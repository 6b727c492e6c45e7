"""Static audit of the CUDA kernels' launches over the registered configs.

The port of the JAX package's ``repro.analysis.audit.kernel_check``. No
device and no weights: each arch's params tree comes from ``model.init``
under ``FakeTensorMode`` and the packed serving shapes from
``deploy.pack.quantize_tree`` under the same mode (the counterpart of
``jax.eval_shape``). Every packed leaf is then swept through the
``kernels/spec.py`` functions the kernel wrappers call, as the port's ops
choose them: ``qgemv`` (``plan_qgemv``) at decode rows, ``qmatmul``
(``plan_qmatmul``) at prefill rows, ``qmatmul_grouped`` at both for
stacked experts, ``kv_decode`` dense and paged (``plan_kv_decode``) at a
cache of ``KV_SEQ`` slots, and ``fakequant`` on the per-layer and the
stacked experts' views. Ragged N is not padded: the kernels mask it.

A launch that fails its shape contract becomes a
``kernel_tile_divisibility`` violation; one whose plan raises
``SmemBudgetError`` (its block asks for more shared memory than
``spec.SMEM_PER_BLOCK``) becomes ``kernel_smem_budget``.
"""
from __future__ import annotations

from typing import Callable

from ...kernels import spec
from ...kernels.spec import KernelSpecError, SmemBudgetError
from .rules import Violation, register_catalog_rule

register_catalog_rule(
    "kernel_tile_divisibility", "kernel",
    "Every kernel launch the serving/calibration path would issue over a "
    "registered config's shapes must satisfy its shape contract "
    "(describe_* / plan_* raise KernelSpecError naming the shapes).")
register_catalog_rule(
    "kernel_smem_budget", "kernel",
    "The dynamic shared memory one block of an audited launch asks for "
    "(plan_qgemv / plan_qmatmul / plan_kv_decode raise SmemBudgetError) "
    "must fit spec.SMEM_PER_BLOCK.")

# Decode batch rows, prefill rows and the KV cache length of the sweep.
DECODE_M = 4
PREFILL_M = 128
KV_SEQ = 512
KV_PAGE = 16

Emit = Callable[[str, str, str], None]


def _iter_packed(fp, packed, path=()):
    """Yield (path, logical_K, wp_shape, qscale_shape) for every packed
    node, walking the FP shape tree (for K) and the packed tree in
    lockstep."""
    if isinstance(packed, dict):
        if "w" in packed and "qscale" in packed and hasattr(packed["w"], "shape"):
            fw = fp["w"] if isinstance(fp, dict) and "w" in fp else None
            if fw is not None and getattr(fw, "ndim", 0) >= 2:
                yield ("/".join(path), fw.shape[-2], tuple(packed["w"].shape),
                       tuple(packed["qscale"].shape))
            return
        for k in packed:
            yield from _iter_packed(fp.get(k) if isinstance(fp, dict) else None,
                                    packed[k], path + (str(k),))


def _check_launch(subject: str, describe: Callable, plan: Callable, emit: Emit) -> None:
    """Contract (``describe``) and plan, with its shared memory, of one
    launch."""
    try:
        describe()
        plan()
    except SmemBudgetError as e:
        emit("kernel_smem_budget", subject, str(e))
    except KernelSpecError as e:
        emit("kernel_tile_divisibility", subject, str(e))


def _sweep_leaf(arch: str, path: str, K: int, wp_shape, qs_shape, emit: Emit) -> None:
    """Audit every launch the qmm dispatch would issue for one packed leaf
    (decode + prefill tiers; grouped for stacked experts)."""
    # strip the layer-stack dim: the runtime slices one layer per call
    if len(wp_shape) >= 3 and len(qs_shape) == len(wp_shape):
        wp_shape, qs_shape = wp_shape[1:], qs_shape[1:]
    rows, N = wp_shape[-2], wp_shape[-1]
    subject = f"{arch}:{path}"
    if rows == 0 or K % rows or K // rows not in (1, 2, 4):
        emit("kernel_tile_divisibility", subject,
             f"packed rows {rows} are not a 1/2/4-per-byte view of "
             f"K={K} (codes {tuple(wp_shape)})")
        return
    bits = 8 // (K // rows)
    G = qs_shape[-2]
    if len(wp_shape) == 2:
        wp, qs = (rows, N), (G, N)
        _check_launch(f"{subject}[decode]",
                      lambda: spec.describe_qgemv((DECODE_M, K), wp, qs, bits=bits),
                      lambda: spec.plan_qgemv(K, N, G, bits), emit)
        _check_launch(f"{subject}[prefill]",
                      lambda: spec.describe_qmatmul((PREFILL_M, K), wp, qs, bits=bits),
                      lambda: spec.plan_qmatmul(PREFILL_M, K, N, G, bits), emit)
    elif len(wp_shape) == 3:
        E = wp_shape[0]
        wp, qs = (E, rows, N), (E, G, N)
        for tier, m in (("grouped-decode", DECODE_M), ("grouped-prefill", PREFILL_M)):
            _check_launch(f"{subject}[{tier}]",
                          lambda m=m: spec.describe_qmatmul_grouped(
                              (E, m, K), wp, qs, bits=bits),
                          lambda m=m: spec.plan_qmatmul(m, K, N, G, bits, E, True),
                          emit)


def _sweep_kv(arch: str, cfg, emit: Emit) -> None:
    """``kv_decode``'s dense and paged entries at a cache of ``KV_SEQ``
    slots (pages of ``KV_PAGE``) over the config's head layout. One plan
    serves both entries; it tests the paged block's shared memory at the
    most page entries (pages of 1), which holds the dense block's too."""
    B, H, K, hd, S = DECODE_M, cfg.n_heads, cfg.n_kv_heads, cfg.hd, KV_SEQ
    q = (B, H, hd)
    mp = -(-S // KV_PAGE)
    pool, scales = (1 + B * mp, KV_PAGE, K, hd), (1 + B * mp, KV_PAGE, K)
    plan = lambda: spec.plan_kv_decode(B, K, S, hd, H // max(K, 1))  # noqa: E731
    _check_launch(f"{arch}:kv_decode",
                  lambda: spec.describe_kv_decode(q, (B, S, K, hd)), plan, emit)
    _check_launch(f"{arch}:kv_decode_paged",
                  lambda: spec.describe_kv_decode_paged(
                      q, pool, pool, scales, scales, (B, mp), (B,), KV_PAGE),
                  plan, emit)


def _sweep_fakequant(arch: str, path: str, w_shape, emit: Emit) -> None:
    """K5 on the calibration's view of one FP weight: (K, N), or a stack of
    experts (E, K, N) as its (E*K, N) view, with one scale per column."""
    K, N = w_shape[-2], w_shape[-1]
    rows = K * (w_shape[-3] if len(w_shape) == 3 else 1)
    try:
        spec.describe_fakequant((rows, N), (1, N))
    except KernelSpecError as e:
        emit("kernel_tile_divisibility", f"{arch}:{path}[fakequant]", str(e))


def audit_arch(arch: str, *, bits: int = 4, reduced: bool = False) -> list[Violation]:
    """Sweep one registered config's serving + calibration launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ...deploy.pack import quantize_tree
    from ...dist.sharding import fake_init
    from ...interop import flatten_paths
    from ...models import get_config

    out: list[Violation] = []

    def emit(rule: str, subject: str, msg: str) -> None:
        out.append(Violation(rule, subject, msg))

    cfg = get_config(arch, reduced=reduced)
    fp = fake_init(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        packed = quantize_tree(fp, bits)
    fp_w = flatten_paths(fp)
    for path, K, wp_shape, qs_shape in _iter_packed(fp, packed):
        _sweep_leaf(arch, path, K, wp_shape, qs_shape, emit)
        # the AdaRound fused forward runs on the per-layer FP view
        w = tuple(fp_w[f"{path}/w"].shape)
        _sweep_fakequant(arch, path, w[1:] if len(w) >= 3 else w, emit)
    _sweep_kv(arch, cfg, emit)
    return out


def run_kernel_checks(archs, *, bits: int = 4, reduced: bool = False,
                      verbose: Callable[[str], None] = lambda s: None) -> list[Violation]:
    out: list[Violation] = []
    for arch in archs:
        found = audit_arch(arch, bits=bits, reduced=reduced)
        verbose(f"  {arch}: " + (f"{len(found)} violation(s)" if found else "ok"))
        out.extend(found)
    return out
