"""Decoder-only LM over the stack/sub-layer graph: dense, MoE, VLM and the
recurrent families.

A model is: embed -> [stack_0 ... stack_k] -> final norm -> head. Each
*stack* is ``n`` identical blocks whose params are stacked along a
leading layer dim (the same tree layout as the JAX package's ``LM``, so
params and artifacts map key for key). The layer loop is written out in
place of ``lax.scan``: layer ``l`` reads the views ``leaf[l]``.

The port covers the dense family (uniform, sliding-window and
local:global attention), the MoE family (a ``dense0`` stack of leading
dense-FFN layers, then a ``moe`` stack), the VLM family (groups of
self-attention layers closed by a tanh-gated cross-attention layer over
``batch["patches"]``), the ``ssm`` family (xLSTM: blocks of mLSTM
sub-layers closed by an sLSTM one, no FFN) and the ``hybrid`` family
(Hymba: sliding-window attention and a selective SSM on the same input,
averaged, then an MLP); ``encdec.EncDecLM`` builds the encoder-decoder
family on the same sub-layers.

Caches are written in place: attention through its views, and every
recurrent state leaf (``h``, ``conv``, ``C``, ``n``, ``m``, ``c``) by
``copy_`` into the layer's view of the stacked cache. A recurrent step
consumes one token, so ``decode_step`` on a model with a recurrent mixer
takes C = 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..configs.base import ArchConfig
from ..interop import tree_map
from . import attention as attn_mod
from . import common as cm
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .common import NO_QUANT, Ctx, QuantHook

Params = Any

RECURRENT_MIXERS = ("mlstm", "slstm", "hymba")


@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str  # 'attn' | 'xattn' (over ctx.extras["memory"]) | 'mlstm' | 'slstm' | 'hymba'
    window: Optional[int] = None
    ffn: Optional[str] = None  # 'mlp' | 'moe' | None
    causal: bool = True
    d_ff: int = 0  # mlp width override (0 -> cfg.d_ff)


@dataclasses.dataclass(frozen=True)
class StackDef:
    name: str
    n: int
    subs: tuple[SubLayer, ...]


def build_stacks(cfg: ArchConfig) -> list[StackDef]:
    if cfg.enc_dec:
        raise ValueError(f"{cfg.name} is an encoder-decoder config: build it "
                         f"with models.encdec.EncDecLM (registry.build_model)")
    if cfg.family == "ssm":  # xlstm
        k = cfg.slstm_every or 6
        if cfg.n_layers % k:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into "
                             f"blocks of {k - 1} mLSTM + 1 sLSTM")
        subs = tuple([SubLayer("mlstm")] * (k - 1) + [SubLayer("slstm")])
        return [StackDef("body", cfg.n_layers // k, subs)]
    if cfg.family == "hybrid":
        return [StackDef("body", cfg.n_layers,
                         (SubLayer("hymba", window=cfg.hymba_window, ffn="mlp"),))]
    if cfg.family == "vlm":
        k = cfg.xattn_every or 5
        if cfg.n_layers % k:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                             f"into groups of {k} ending in cross-attention")
        subs = tuple([SubLayer("attn", ffn="mlp")] * (k - 1)
                     + [SubLayer("xattn", ffn="mlp")])
        return [StackDef("body", cfg.n_layers // k, subs)]
    if cfg.family == "moe":
        if cfg.moe is None:
            raise ValueError(f"{cfg.name}: the 'moe' family needs a MoEArch")
        stacks = []
        if cfg.moe.first_k_dense:
            stacks.append(StackDef(
                "dense0", cfg.moe.first_k_dense,
                (SubLayer("attn", ffn="mlp", d_ff=cfg.moe.first_dense_ff),)))
        stacks.append(StackDef("moe", cfg.n_layers - cfg.moe.first_k_dense,
                               (SubLayer("attn", ffn="moe"),)))
        return stacks
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.local_global is not None:
        nl, ng = cfg.local_global
        grp = nl + ng
        if cfg.n_layers % grp:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                             f"into local:global groups of {grp}")
        subs = tuple([SubLayer("attn", window=cfg.local_window, ffn="mlp")] * nl
                     + [SubLayer("attn", ffn="mlp")] * ng)
        return [StackDef("body", cfg.n_layers // grp, subs)]
    return [StackDef("body", cfg.n_layers, (SubLayer("attn", window=cfg.window, ffn="mlp"),))]


def _attn_spec(cfg: ArchConfig, sub: SubLayer, cross: bool = False) -> attn_mod.AttnSpec:
    return attn_mod.AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta, window=sub.window,
        causal=sub.causal and not cross, use_rope=not cross, qk_norm=cfg.qk_norm)


def _mlp_spec(cfg: ArchConfig, sub: SubLayer) -> mlp_mod.MLPSpec:
    return mlp_mod.MLPSpec(cfg.d_model, sub.d_ff or cfg.d_ff, cfg.mlp_kind)


def _moe_spec(cfg: ArchConfig, impl: str) -> moe_mod.MoESpec:
    m = cfg.moe
    return moe_mod.MoESpec(cfg.d_model, m.d_ff_expert, m.n_experts, m.top_k,
                           n_shared=m.n_shared, impl=impl)


def _xlstm_spec(cfg: ArchConfig) -> xlstm_mod.XLSTMSpec:
    return xlstm_mod.XLSTMSpec(cfg.d_model, cfg.n_heads, cfg.xlstm_expansion)


def _ssm_spec(cfg: ArchConfig) -> ssm_mod.SSMSpec:
    return ssm_mod.SSMSpec(cfg.d_model, int(cfg.d_model * cfg.ssm_expansion), cfg.ssm_state)


def _norm_init(cfg: ArchConfig, device):
    if cfg.norm == "rms":
        return cm.rmsnorm_init(cfg.d_model, device)
    return cm.layernorm_init(cfg.d_model, device)


def _norm(cfg: ArchConfig, p, x):
    return cm.rmsnorm(p, x) if cfg.norm == "rms" else cm.layernorm(p, x)


# Layer checkpointing for the backward, as JAX's ``_maybe_remat``: "none"
# keeps every activation; "full" recomputes the whole layer; "dots" saves
# the outputs of the weight matmuls (``aten.mm``/``aten.addmm``: no batch
# dims, JAX's ``dots_with_no_batch_dims_saveable``) and recomputes the rest
REMAT = ("none", "full", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: Optional[str]):
    if remat is None or remat == "none":
        return fn
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {} if remat == "full" else {
        "context_fn": lambda: create_selective_checkpoint_contexts(_save_dots)}
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so cache writes land in place."""
    return tree_map(lambda a: a[i], tree)


class LM:
    """Decoder-only language model over the stack/sub-layer graph."""

    def __init__(self, cfg: ArchConfig, *, moe_impl: str = "dense"):
        self.cfg = cfg
        self.stacks = build_stacks(cfg)
        self.moe_impl = moe_impl

    @property
    def recurrent(self) -> bool:
        """Whether a sub-layer carries recurrent state (one token a step)."""
        return any(s.mixer in RECURRENT_MIXERS for st in self.stacks for s in st.subs)

    # -- init ---------------------------------------------------------------

    def _init_sub(self, gen: torch.Generator, sub: SubLayer) -> Params:
        cfg = self.cfg
        p: dict = {"norm1": _norm_init(cfg, gen.device)}
        if sub.mixer == "mlstm":
            p["mix"] = xlstm_mod.mlstm_init(gen, _xlstm_spec(cfg))
        elif sub.mixer == "slstm":
            p["mix"] = xlstm_mod.slstm_init(gen, _xlstm_spec(cfg))
        else:
            cross = sub.mixer == "xattn"
            p["attn"] = attn_mod.init(gen, _attn_spec(cfg, sub, cross))
            if cross:  # the gate starts shut, as in JAX: tanh(0) = 0
                p["xgate"] = torch.zeros((), dtype=torch.float32, device=gen.device)
            if sub.mixer == "hymba":
                p["ssm"] = ssm_mod.init(gen, _ssm_spec(cfg))
        if sub.ffn == "mlp":
            p["norm2"] = _norm_init(cfg, gen.device)
            p["mlp"] = mlp_mod.init(gen, _mlp_spec(cfg, sub))
        elif sub.ffn == "moe":
            p["norm2"] = _norm_init(cfg, gen.device)
            p["moe"] = moe_mod.init(gen, _moe_spec(cfg, self.moe_impl))
        return p

    def init(self, gen: torch.Generator) -> Params:
        """Random params on ``gen.device``, drawn from ``gen``."""
        cfg = self.cfg
        params: dict = {"embed": cm.embed_init(gen, cfg.vocab, cfg.d_model),
                        "final_norm": _norm_init(cfg, gen.device)}
        if not cfg.tie_embeddings:
            head = torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                               dtype=torch.float32, device=gen.device)
            params["head"] = {"w": head * 0.02}
        for stack in self.stacks:
            blocks = [{f"sub{i}": self._init_sub(gen, s)
                       for i, s in enumerate(stack.subs)}
                      for _ in range(stack.n)]
            params[stack.name] = _stack_trees(blocks)
        return params

    # -- sub-layer / block application ---------------------------------------

    def _apply_sub(self, ctx: Ctx, sub: SubLayer, idx: int, p: Params,
                   x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        sc = ctx.scoped(f"sub{idx}")
        h = _norm(cfg, p["norm1"], x)
        if sub.mixer == "xattn":
            out = attn_mod.apply(sc.scoped("attn"), p["attn"],
                                 _attn_spec(cfg, sub, cross=True), h,
                                 kv_x=ctx.extras["memory"])
            x = x + torch.tanh(p["xgate"]) * out
        elif sub.mixer == "mlstm":
            x = x + xlstm_mod.mlstm_apply(sc.scoped("mix"), p["mix"], _xlstm_spec(cfg), h)
        elif sub.mixer == "slstm":
            x = x + xlstm_mod.slstm_apply(sc.scoped("mix"), p["mix"], _xlstm_spec(cfg), h)
        else:
            out = attn_mod.apply(sc.scoped("attn"), p["attn"], _attn_spec(cfg, sub), h)
            if sub.mixer == "hymba":
                s = ssm_mod.apply(sc.scoped("ssm"), p["ssm"], _ssm_spec(cfg), h)
                out = 0.5 * (out + s)
            x = x + out
        if sub.ffn == "mlp":
            h = _norm(cfg, p["norm2"], x)
            x = x + mlp_mod.apply(sc.scoped("mlp"), p["mlp"], _mlp_spec(cfg, sub), h)
        elif sub.ffn == "moe":
            h = _norm(cfg, p["norm2"], x)
            spec = _moe_spec(cfg, self.moe_impl)
            x = x + moe_mod.apply(sc.scoped("moe"), p["moe"], spec, h)
            aux = aux + moe_mod.aux_loss(sc.scoped("moe"), p["moe"], spec, h)
        return x, aux

    def apply_block(self, ctx: Ctx, stack: StackDef, p: Params,
                    x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One block (one layer's params ``p``); returns (x, moe aux)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, sub in enumerate(stack.subs):
            x, a = self._apply_sub(ctx, sub, i, p[f"sub{i}"], x)
            aux = aux + a
        return x, aux

    # -- full forward ---------------------------------------------------------

    def begin(self, params: Params, batch: dict, quant: QuantHook = NO_QUANT,
              act_shard=None) -> tuple[torch.Tensor, Ctx]:
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        ctx = Ctx(cfg=self.cfg, positions=positions, quant=quant)
        if self.cfg.family == "vlm":
            ctx.extras["memory"] = batch["patches"]
        return cm.embed_lookup(ctx, params["embed"], tokens), ctx

    def finish(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        x = _norm(self.cfg, params["final_norm"], x)
        # tied embeddings pass the embed node itself so lm_head can see a
        # packed int8 table (table_qscale) and dequantize it
        head_p = params["head"] if "head" in params else params["embed"]
        return cm.lm_head(ctx, head_p, x)

    def forward(self, params: Params, batch: dict, quant: QuantHook = NO_QUANT,
                *, remat: Optional[str] = "none",
                act_shard=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits, moe aux). ``remat`` (``REMAT``) checkpoints each
        layer for the backward: it changes memory, never values.
        ``act_shard`` (``fn(x, kind)``, from ``launch/steps.act_shard_fn``)
        lays out the hidden state at the embedding and after every block,
        and the MoE dispatch tensors (``ctx.extras["moe_shard"]``)."""
        shard = act_shard or cm.no_shard
        x, ctx = self.begin(params, batch, quant, act_shard=act_shard)
        if act_shard is not None:
            ctx.extras["moe_shard"] = act_shard
        x = shard(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for stack in self.stacks:
            block = _maybe_remat(
                lambda p, x, stack=stack: self.apply_block(ctx, stack, p, x), remat)
            for layer in range(stack.n):
                x, a = block(_layer(params[stack.name], layer), x)
                x = shard(x)
                aux = aux + a
        return self.finish(params, x, ctx), aux

    def loss(self, params: Params, batch: dict, quant: QuantHook = NO_QUANT,
             *, remat: Optional[str] = "none", aux_weight: float = 0.01,
             act_shard=None) -> torch.Tensor:
        logits, aux = self.forward(params, batch, quant, remat=remat,
                                   act_shard=act_shard)
        tokens = batch["tokens"]
        return cm.softmax_xent(logits[:, :-1], tokens[:, 1:]) + aux_weight * aux

    # -- serving ----------------------------------------------------------------

    def _init_sub_cache(self, sub: SubLayer, batch: int, max_len: int, dtype,
                        device):
        cfg = self.cfg
        if sub.mixer == "xattn":
            # sized for n_patches, as in JAX; prefill refits it to the memory
            spec = _attn_spec(cfg, sub, cross=True)
            shape = (batch, cfg.n_patches, spec.n_kv_heads, spec.head_dim)
            return {"xk": torch.zeros(shape, dtype=dtype, device=device),
                    "xv": torch.zeros(shape, dtype=dtype, device=device)}
        if sub.mixer == "mlstm":
            return {"mix": xlstm_mod.mlstm_init_cache(_xlstm_spec(cfg), batch, device)}
        if sub.mixer == "slstm":
            return {"mix": xlstm_mod.slstm_init_cache(_xlstm_spec(cfg), batch, device)}
        c = {"attn": attn_mod.init_cache(_attn_spec(cfg, sub), batch, max_len,
                                         dtype, device)}
        if sub.mixer == "hymba":
            c["ssm"] = ssm_mod.init_cache(_ssm_spec(cfg), batch, dtype, device)
        return c

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """Dense KV caches (cross-attention K/V, recurrent states), stacked
        along the layer dim like the params."""
        cache = {}
        for stack in self.stacks:
            layers = [{f"sub{i}": self._init_sub_cache(s, batch, max_len, dtype, device)
                       for i, s in enumerate(stack.subs)} for _ in range(stack.n)]
            cache[stack.name] = _stack_trees(layers)
        return cache

    def _fit_xattn_cache(self, cache, memory: torch.Tensor) -> None:
        """Give every cross-attention cache the memory's own length (JAX's
        prefill replaces the n_patches-long one it was made with)."""
        B, Sm = memory.shape[:2]
        for stack in self.stacks:
            for i, sub in enumerate(stack.subs):
                c = cache[stack.name][f"sub{i}"]
                if sub.mixer == "xattn" and c["xk"].shape[1:3] != (B, Sm):
                    for k in ("xk", "xv"):
                        old = c[k]
                        c[k] = torch.zeros((old.shape[0], B, Sm, *old.shape[3:]),
                                           dtype=old.dtype, device=old.device)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         kv_dtype: str = "int8", device=None):
        """Paged KV pools for the serve engine: one pool per attention
        sub-layer, stacked along the layer dim like :meth:`init_cache`.
        All layers share one block table (they cache the same token
        sequence), so only the pools live here. Non-attention mixers have
        no paged form and are rejected up front."""
        cfg = self.cfg
        cache = {}
        for stack in self.stacks:
            one = {}
            for i, sub in enumerate(stack.subs):
                if sub.mixer != "attn":
                    raise ValueError(
                        f"paged KV serving needs attention-only mixers; "
                        f"stack {stack.name!r} sub {i} is {sub.mixer!r}")
                spec = _attn_spec(cfg, sub)
                one[f"sub{i}"] = {"attn": cm.init_paged_kv(
                    num_pages, page_size, spec.n_kv_heads, spec.head_dim,
                    kv_dtype, device)}
            cache[stack.name] = tree_map(
                lambda a, n=stack.n: a.expand(n, *a.shape).clone(), one)
        return cache

    def _sub_step(self, ctx: Ctx, sub: SubLayer, idx: int, p, x, cache, step):
        cfg = self.cfg
        sc = ctx.scoped(f"sub{idx}")
        h = _norm(cfg, p["norm1"], x)
        if sub.mixer == "xattn":
            spec = _attn_spec(cfg, sub, cross=True)
            if step is attn_mod.prefill:  # the memory's K/V, cached in place
                mem = ctx.extras["memory"]
                xc = attn_mod.xattn_cache(sc.scoped("attn"), p["attn"], spec, mem)
                cache["xk"].copy_(xc["k"])
                cache["xv"].copy_(xc["v"])
                out = attn_mod.apply(sc.scoped("attn"), p["attn"], spec, h, kv_x=mem)
            else:
                out = attn_mod.xattn_decode(sc.scoped("attn"), p["attn"], spec, h,
                                            {"k": cache["xk"], "v": cache["xv"]})
            x = x + torch.tanh(p["xgate"]) * out
        elif sub.mixer in ("mlstm", "slstm"):
            mlstm = sub.mixer == "mlstm"
            if step is attn_mod.prefill:
                fn = xlstm_mod.mlstm_prefill if mlstm else xlstm_mod.slstm_prefill
                out, state = fn(sc.scoped("mix"), p["mix"], _xlstm_spec(cfg), h)
            else:
                fn = xlstm_mod.mlstm_decode if mlstm else xlstm_mod.slstm_decode
                out, state = fn(sc.scoped("mix"), p["mix"], _xlstm_spec(cfg), h,
                                cache["mix"])
            _write_state(cache["mix"], state)
            x = x + out
        else:
            out, cache["attn"] = step(sc.scoped("attn"), p["attn"], _attn_spec(cfg, sub),
                                      h, cache["attn"])
            if sub.mixer == "hymba":
                spec = _ssm_spec(cfg)
                if step is attn_mod.prefill:
                    s, state = ssm_mod.prefill(sc.scoped("ssm"), p["ssm"], spec, h)
                else:
                    s, state = ssm_mod.decode(sc.scoped("ssm"), p["ssm"], spec, h,
                                              cache["ssm"])
                _write_state(cache["ssm"], state)
                out = 0.5 * (out + s)
            x = x + out
        if sub.ffn == "mlp":
            x = x + mlp_mod.apply(sc.scoped("mlp"), p["mlp"], _mlp_spec(cfg, sub),
                                  _norm(cfg, p["norm2"], x))
        elif sub.ffn == "moe":
            x = x + moe_mod.apply(sc.scoped("moe"), p["moe"],
                                  _moe_spec(cfg, self.moe_impl),
                                  _norm(cfg, p["norm2"], x))
        return x, cache

    def _run_layers(self, ctx: Ctx, params, x, cache, step, shard=cm.no_shard):
        for stack in self.stacks:
            for layer in range(stack.n):
                p_i = _layer(params[stack.name], layer)
                c_i = _layer(cache[stack.name], layer)
                for i, sub in enumerate(stack.subs):
                    x, _ = self._sub_step(ctx, sub, i, p_i[f"sub{i}"], x,
                                          c_i[f"sub{i}"], step)
                x = shard(x)
        return x

    def prefill(self, params, batch: dict, cache, quant: QuantHook = NO_QUANT,
                *, act_shard=None):
        """Process the prompt; returns (last-token logits, filled cache).
        The cache is filled in place. ``act_shard`` as :meth:`forward`'s."""
        shard = act_shard or cm.no_shard
        x, ctx = self.begin(params, batch, quant, act_shard=act_shard)
        if act_shard is not None:
            ctx.extras["moe_shard"] = act_shard
        if "memory" in ctx.extras:
            self._fit_xattn_cache(cache, ctx.extras["memory"])
        x = self._run_layers(ctx, params, shard(x), cache, attn_mod.prefill, shard)
        logits = self.finish(params, x[:, -1:], ctx)
        return logits[:, 0], cache

    def decode_step(self, params, tokens: torch.Tensor, cache, pos: torch.Tensor,
                    quant: QuantHook = NO_QUANT, extras: Optional[dict] = None,
                    act_shard=None, *, all_logits: bool = False):
        """Decode C tokens in one cached step (cache updated in place).

        tokens (B, C); pos (B,) absolute position of ``tokens[:, 0]``
        (consecutive positions within the chunk). C = 1 is plain decode;
        C > 1 is a chunked-prefill step through the same cached path.
        ``cache`` is dense (:meth:`init_cache`) or paged
        (:meth:`init_paged_cache`, with ``extras={"paged": ...}``).
        Returns last-position logits (B, V), or (B, C, V) with
        ``all_logits``. ``act_shard`` as :meth:`forward`'s; a sharded
        step passes ``extras={"cache_shard": ...}`` too.
        """
        B, C = tokens.shape
        if C > 1 and self.recurrent:
            raise ValueError(f"{self.cfg.name}: decode_step got {C} tokens a row; a "
                             f"recurrent mixer steps one token at a time")
        positions = (pos[:, None] + torch.arange(C, device=pos.device)[None]).to(torch.int32)
        ctx = Ctx(cfg=self.cfg, positions=positions, quant=quant)
        if extras:
            ctx.extras.update(extras)
        shard = act_shard or cm.no_shard
        if act_shard is not None:
            ctx.extras["moe_shard"] = act_shard
        x = shard(cm.embed_lookup(ctx, params["embed"], tokens))
        x = self._run_layers(ctx, params, x, cache, attn_mod.decode, shard)
        logits = self.finish(params, x, ctx)
        return (logits if all_logits else logits[:, -1]), cache


def _write_state(cache: dict, state: dict) -> None:
    """A recurrent step's new state into the layer's views of the stacked
    cache (``_run_layers`` keeps no returned cache)."""
    for k, v in state.items():
        cache[k].copy_(v)


def _stack_trees(trees: list) -> Any:
    """Stack a list of same-structured trees along a new leading dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
