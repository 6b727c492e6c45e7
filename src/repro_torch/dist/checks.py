"""Multi-rank checks of the sharded steps against the one-rank path.

Each check is a job for ``dist.spawn.run_ranks``: it runs on every rank of
a gloo group (CPU ranks in the tests, ranks sharing one GPU on the card)
and returns plain numbers. Every rank builds the same global inputs from a
seed, so each can run the one-rank reference itself.

* :func:`dp_int8`: the int8 error-feedback all-reduce (``_compress_psum``)
  against its arithmetic on every rank's gradients gathered to one rank,
  then ``make_dp_train_step``'s loss curve beside an uncompressed f32
  data-parallel run.
* :func:`train_steps`: ``make_train_step`` under each strategy against the
  same step on whole tensors, gradients included (through Adam's first
  moment); bytes per rank of params and Adam state.
* :func:`serve`: packed prefill + greedy decode under ``Plan("tp")``
  against the one-rank serve of the same artifact, with the packed
  kernels' launches per rank.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

from ..configs.base import ShapeSpec
from ..interop import flatten_paths, tree_leaves
from ..launch.mesh import MeshSpec
from ..optim import adam


def several(rank: int, world: int, calls: list) -> list:
    """Run several checks in one spawn: ``calls`` is a list of (name of a
    check in this module, its arguments after rank and world)."""
    return [globals()[name](rank, world, *args) for name, args in calls]


def _model(arch: str, reduced: bool):
    from ..models import get_model

    return get_model(arch, reduced=reduced)


def _tokens(cfg, batch: int, seq: int, device, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, seq), generator=g).to(device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# int8 all-reduce
# ---------------------------------------------------------------------------


def compress_reference(gs: list, es: list) -> tuple:
    """The compressed all-reduce's arithmetic on all ranks' gradients and
    error buffers at once: (g_hat, [e_new of each rank])."""
    ges = [g.to(torch.float32) + e for g, e in zip(gs, es)]
    amax = torch.stack([x.abs().max() for x in ges]).max()
    scale = torch.clamp_min(amax * torch.tensor(1.0 / 127.0, dtype=torch.float32), 1e-12)
    codes = [torch.clamp(torch.round(x / scale), -127, 127) for x in ges]
    summed = torch.stack(codes).sum(0)
    g_hat = summed * scale * torch.tensor(1.0 / len(gs), dtype=torch.float32)
    e_new = [(x.double() - c.double() * scale.double()).float() for x, c in zip(ges, codes)]
    return g_hat.to(gs[0].dtype), e_new


def compress_rounds(rank: int, world: int, sizes: tuple, rounds: int, shape: tuple,
                    seed: int) -> dict:
    """``_compress_psum`` over the first n ranks, for each n in ``sizes``,
    through ``rounds`` rounds of error feedback on numpy-seeded gradients
    (rank r takes row r of each round's (n, *shape) draw). Returns, per n,
    this rank's g_hat and e_new of every round (numpy)."""
    import numpy as np
    import torch.distributed as dist

    from ..optim.grad_compress import _compress_psum

    out = {}
    for n in sizes:
        group = dist.new_group(list(range(n)))
        if rank >= n:
            continue
        rng = np.random.default_rng(seed + n)
        e = torch.zeros(shape, dtype=torch.float32)
        got = []
        for _ in range(rounds):
            g = rng.standard_normal((n, *shape)).astype(np.float32)
            g *= (10.0 ** rng.uniform(-3, 1, (n,) + (1,) * len(shape))).astype(np.float32)
            g_hat, e = _compress_psum(torch.from_numpy(g[rank]), e, group)
            got.append((g_hat.numpy(), e.numpy()))
        out[n] = got
    return out


def _gather_to_all(t: torch.Tensor, world: int) -> list:
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return parts


def dp_int8(rank: int, world: int, arch: str, reduced: bool, device: str,
            batch: int, seq: int, steps: int, seed: int = 0) -> dict:
    """The int8 all-reduce on real gradients against its reference
    arithmetic, then ``steps`` steps of ``make_dp_train_step`` on one
    global batch beside the same step with the uncompressed f32 all-reduce
    (``mean_psum``) from the same start."""
    from ..launch.train import loss_and_grads
    from ..optim.grad_compress import (_compress_psum, init_error, make_dp_train_step,
                                       mean_psum, rows_of, wire_bytes)

    cfg, model = _model(arch, reduced)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    acfg = adam.AdamConfig(lr=1e-3, grad_clip=1.0)
    # one batch again and again, as JAX's test of the step: the loss falls
    batches = [{"tokens": _tokens(cfg, batch, seq, device, seed + 1)}] * steps

    # 1. one all-reduce of this rank's gradients of batch 0, twice (the
    #    second round carries the first's error), against the reference
    _, grads = loss_and_grads(model, params, rows_of(batches[0], rank, world), "none")
    err = init_error(params)
    worst, ties, n_el = 0.0, 0, 0
    for _ in range(2):
        for g, e in zip(tree_leaves(grads), tree_leaves(err)):
            g_hat, e_new = _compress_psum(g, e, None)
            ref_hat, ref_e = compress_reference(_gather_to_all(g, world),
                                                _gather_to_all(e, world))
            worst = max(worst, float((g_hat - ref_hat).abs().max()),
                        float((e_new - ref_e[rank]).abs().max()))
            ties += int((g_hat != ref_hat).sum())
            n_el += g.numel()
            e.copy_(e_new)
    # 2. the loss curves of the same step, compressed and not
    mesh = MeshSpec((world,), ("data",))
    curves, walls = {}, {}
    for name, reduce in (("int8", _compress_psum), ("f32", mean_psum)):
        step = make_dp_train_step(model, mesh, acfg, remat="none", reduce=reduce)
        p, o, e = params, adam.init(params), init_error(params)
        t0 = time.perf_counter()
        curves[name] = []
        for b in batches:
            p, o, e, loss = step(p, o, e, b)
            curves[name].append(float(loss))
        _sync(device)
        walls[name] = (time.perf_counter() - t0) / steps
        if name == "int8":
            enorm = float(sum(x.abs().sum() for x in tree_leaves(e)))
    return {"max_abs_diff": worst, "unequal": ties, "elements": n_el,
            "int8_losses": curves["int8"], "f32_losses": curves["f32"],
            "err_abs_sum": enorm, "int8_s_per_step": walls["int8"],
            "f32_s_per_step": walls["f32"],
            "wire_bytes": wire_bytes(params, world)}


# ---------------------------------------------------------------------------
# sharded train step
# ---------------------------------------------------------------------------


def train_steps(rank: int, world: int, arch: str, reduced: bool, device: str,
                mesh_shape: tuple, strategies: tuple, batch: int, seq: int,
                seed: int = 0) -> dict:
    """One ``make_train_step`` under each strategy on a (data, model) mesh
    of ``mesh_shape``, against the same step on whole tensors: the loss,
    the gradient norm, the params (their largest difference, and the share
    off by more than 1e-6: Adam's first step is lr * sign(g), so a gradient
    of the wrong sign moves a param by 2 lr) and the gradients themselves,
    through Adam's first moment (``m_rel``: the largest over the leaves of
    |m - m_ref| / |m_ref|, Frobenius norms)."""
    from ..dist.sharding import Plan
    from ..launch import steps

    cfg, model = _model(arch, reduced)
    mesh = MeshSpec(tuple(mesh_shape), ("data", "model"))
    dm = mesh.device_mesh(torch.device(device).type)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    opt = adam.init(params)
    b = {"tokens": _tokens(cfg, batch, seq, device, seed + 1)}
    shape = ShapeSpec("train", seq, batch, "train")
    out = {}
    for strategy in strategies:
        steps.GATHERS.clear()
        st = steps.make_train_step(model, Plan(mesh=mesh, strategy=strategy, cfg=cfg),
                                   shape)
        ref = st.fn(params, opt, b)
        ref_p = flatten_paths(ref[0])
        args = st.shard(params, opt, b, device_mesh=dm)
        t0 = time.perf_counter()
        got = st.run(*args)
        p2 = steps.full_tree(got[0])
        wall = time.perf_counter() - t0
        diffs = {k: (v - ref_p[k]).abs().flatten()
                 for k, v in flatten_paths(p2).items()}
        d = torch.cat(list(diffs.values()))
        off = {k: int((x > 1e-6).sum()) for k, x in diffs.items()}
        # Adam's first moment after one step is (1 - b1) times the clipped
        # gradient, element for element: each leaf's gradient against the
        # one-rank step's, as the norm of the difference over the leaf's
        m_rel = 0.0
        for a, r in zip(tree_leaves(steps.full_tree(got[1]["m"])),
                        tree_leaves(ref[1]["m"])):
            num, den = float((a - r).norm()), float(r.norm())
            m_rel = max(m_rel, num / den if den else (0.0 if num == 0 else float("inf")))
        out[strategy] = {
            "loss": float(got[2]["loss"].full_tensor()), "ref_loss": float(ref[2]["loss"]),
            "gnorm": float(got[2]["gnorm"].full_tensor()),
            "ref_gnorm": float(ref[2]["gnorm"]),
            "max_param_diff": float(d.max()), "lr": 3e-4,
            "params_off": float((d > 1e-6).double().mean()),
            "params_off_leaf": max(off, key=off.get), "m_rel": m_rel,
            "param_bytes": steps.local_bytes(args[0]),
            "adam_bytes": steps.local_bytes({"m": args[1]["m"], "v": args[1]["v"]}),
            "gathers": dict(steps.GATHERS), "s": wall}
    return out


# ---------------------------------------------------------------------------
# packed tensor-parallel serving
# ---------------------------------------------------------------------------


def _serve(prefill, decode, params, tokens, gen, model, dm=None, timed=None):
    """Greedy serve: prefill then ``gen`` decode steps. Returns the logits
    (B, gen + 1, V) of every step, as whole f32 tensors."""
    from ..launch.steps import shard_tree

    B, S = tokens.shape
    cache = model.init_cache(B, S + gen, torch.bfloat16, device=tokens.device)
    pos0 = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    whole = (lambda t: t.full_tensor()) if dm is not None else (lambda t: t)
    if dm is not None:
        params, batch, cache = prefill.shard(params, {"tokens": tokens}, cache,
                                             device_mesh=dm)
        logits, cache = prefill.run(params, batch, cache)
    else:
        logits, cache = prefill.fn(params, {"tokens": tokens}, cache)
    outs = [whole(logits).float()]
    for i in range(gen):
        tok = outs[-1].argmax(-1).to(torch.int32)[:, None]
        pos = pos0 + i
        t0 = time.perf_counter()
        if dm is not None:
            lay = decode.layout(params, tok, cache, pos)[0]
            logits, cache = decode.run(params, shard_tree(tok, lay[1], dm), cache,
                                       shard_tree(pos, lay[3], dm))
        else:
            logits, cache = decode.fn(params, tok, cache, pos)
        outs.append(whole(logits).float())
        if timed is not None:
            _sync(tokens.device)
            timed.append(time.perf_counter() - t0)
    return torch.stack(outs, 1)


@contextlib.contextmanager
def _kernel_shapes(qm_kernel, log):
    """Count the packed kernels' launches by (kernel, N) (``qmm`` looks the
    kernels up on their module at every call)."""
    orig = {n: getattr(qm_kernel, n) for n in ("qgemv", "qmatmul")}

    def wrap(name):
        def fn(x, wp, s, *, bits):
            log[(name, int(wp.shape[-1]))] += 1
            return orig[name](x, wp, s, bits=bits)
        return fn

    for n in orig:
        setattr(qm_kernel, n, wrap(n))
    try:
        yield log
    finally:
        for n, f in orig.items():
            setattr(qm_kernel, n, f)


def serve(rank: int, world: int, arch: str, reduced: bool, device: str,
          mesh_shape: tuple, bits: int, batch: int, prompt: int, gen: int,
          seed: int = 0) -> dict:
    """Packed (RTN ``bits``) prefill + ``gen`` greedy decode steps under
    ``Plan("tp")`` on a (data, model) mesh of ``mesh_shape``, against the
    one-rank serve of the same artifact. Returns the logits' largest
    difference and magnitude, whether the greedy tokens agree, the packed
    kernels' launches and tiers on this rank in the sharded run, and bytes
    of codes per rank."""
    from ..deploy.pack import quantize_tree
    from ..dist.sharding import Plan
    from ..kernels.qmatmul import kernel as qm_kernel
    from ..kernels.qmatmul import ops
    from ..launch import steps

    cfg, model = _model(arch, reduced)
    params = quantize_tree(model.init(torch.Generator(device=device).manual_seed(seed)),
                           bits, None)
    tokens = _tokens(cfg, batch, prompt, device, seed + 1)
    mesh = MeshSpec(tuple(mesh_shape), ("data", "model"))
    dm = mesh.device_mesh(torch.device(device).type)
    plan = Plan(mesh=mesh, strategy="tp", cfg=cfg)
    total = prompt + gen
    pre = steps.make_prefill_step(model, plan, ShapeSpec("p", total, batch, "prefill"),
                                  quant_bits=bits)
    dec = steps.make_decode_step(model, plan, ShapeSpec("d", total, batch, "decode"),
                                 quant_bits=bits)
    one_ms = []
    ref = _serve(pre, dec, params, tokens, gen, model, timed=one_ms)
    steps.GATHERS.clear()
    for k in ops.TIER_COUNTS:
        ops.TIER_COUNTS[k] = 0
    qm_kernel.reset_launches()
    tp_ms, shapes = [], collections.Counter()
    with _kernel_shapes(qm_kernel, shapes):
        got = _serve(pre, dec, params, tokens, gen, model, dm, timed=tp_ms)
    launches = dict(qm_kernel.LAUNCHES)
    bodies = dict(getattr(qm_kernel, "BODY_LAUNCHES", {}))
    tiers = dict(ops.TIER_COUNTS)
    sharded = pre.shard(params, {"tokens": tokens},
                        model.init_cache(batch, total, torch.bfloat16, device=device),
                        device_mesh=dm)[0]
    codes = [t for t in tree_leaves(sharded) if t.dtype == torch.int8]
    # packed matmuls a forward: each stacked packed node once a layer
    scales = {p: q for p, q in flatten_paths(params).items() if p.endswith("/qscale")}
    per_forward = sum(q.shape[0] if q.ndim > 2 else 1 for q in scales.values())
    heads = sum(1 for p in scales if p.startswith("head/"))
    whole_codes = [t for t in tree_leaves(params) if t.dtype == torch.int8]
    # each run feeds back its own tokens: compare up to the first step whose
    # greedy tokens differ, and report how near a tie that step was
    same = (ref.argmax(-1) == got.argmax(-1)).all(0)
    first = int((~same).int().argmax()) if not bool(same.all()) else gen + 1
    upto = min(first + 1, gen + 1)
    top2 = ref[:, :upto].topk(2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    return {"max_abs_diff": float((ref[:, :upto] - got[:, :upto]).abs().max()),
            "max_abs_logit": float(ref[:, :upto].abs().max()),
            "tokens_equal": bool(same.all()), "first_mismatch_step": first,
            "min_top2_gap": gap,
            "launches": launches, "body_launches": bodies, "tiers": tiers,
            "kernel_n": {f"{k}_N{n}": c for (k, n), c in sorted(shapes.items())},
            "whole_n": sorted({int(t.shape[-1]) for t in whole_codes}),
            "gathers": dict(steps.GATHERS),
            "packed_per_forward": per_forward, "packed_heads": heads,
            "codes_bytes_rank": sum(t.to_local().numel() for t in codes),
            "codes_bytes_whole": sum(t.numel() for t in whole_codes),
            "decode_ms_one_rank": 1e3 * sorted(one_ms)[len(one_ms) // 2],
            "decode_ms_tp": 1e3 * sorted(tp_ms)[len(tp_ms) // 2]}

