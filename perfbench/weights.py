"""The benchmark's inputs, made on the device from ``--seed``: the FP
weights of a dense decoder and calibration tokens.

The tree's layout is the program's (its ``init`` run under
``FakeTensorMode``: shapes only, nothing allocated); the values are the
benchmark's, drawn from ``torch.Generator`` streams of the seed on the
card: each layer's dense weights in one call (stream ``LAYER0 + i``), the
embedding table (stream 0) and the untied head (stream 2) in one call
each. Every dense ``w`` is uniform in +-1/sqrt(K) (K its input width), the
table and the head N(0, 0.02^2), every norm gain 1. A layer reads the same
whichever way it is made, so the serving driver packs the model one layer
at a time and the reference makes the same layers again after the window.
"""
from __future__ import annotations

import math

import torch

LAYER0 = 16  # stream of layer 0's dense weights; streams 0-15 are the rest


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one named stream of the seed."""
    s = (int(seed) * 0x9E3779B1 + stream * 0x85EBCA77) % (1 << 63)
    return torch.Generator(device=device).manual_seed(s)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _set(tree, path, val):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = val


class Layout:
    """The leaves of a dense decoder's tree: the stacked layer leaves under
    ``body`` (their shapes without the layer dim) and the rest."""

    def __init__(self, model):
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            fake = model.init(torch.Generator().manual_seed(0))
        leaves = list(_walk(fake))
        self.n_layers = model.cfg.n_layers
        self.paths = [p for p, _ in leaves]  # the program's order
        self.dense = [(p, tuple(t.shape[1:])) for p, t in leaves
                      if p[0] == "body" and p[-1] == "w"]
        self.gains = [(p, tuple(t.shape[1:])) for p, t in leaves
                      if p[0] == "body" and p[-1] == "g"]
        self.top = [(p, tuple(t.shape)) for p, t in leaves if p[0] != "body"]
        known = {p for p, _ in self.dense + self.gains}
        known |= {p for p, _ in self.top
                  if p in (("embed", "table"), ("head", "w")) or p[-1] == "g"}
        other = [p for p, _ in leaves if p not in known]
        if other:
            raise ValueError(f"no rule for the leaves {other}")


def layer(layout: Layout, seed: int, i: int, device) -> dict:
    """Layer ``i``'s leaves, keyed by their path under ``body``, in one draw."""
    total = sum(math.prod(s) for _, s in layout.dense)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    buf.uniform_(-1.0, 1.0, generator=generator(seed, device, LAYER0 + i))
    out, off = {}, 0
    for p, s in layout.dense:
        n = math.prod(s)
        out[p[1:]] = buf[off:off + n].view(s).mul_(1.0 / math.sqrt(s[-2]))
        off += n
    for p, s in layout.gains:
        out[p[1:]] = torch.ones(s, dtype=torch.float32, device=device)
    return {p[1:]: out[p[1:]] for p in layout.paths if p[0] == "body"}


def top(layout: Layout, seed: int, device) -> dict:
    """The leaves outside the layers: table, untied head, final gain."""
    out = {}
    for p, s in layout.top:
        if p[-1] == "g":
            out[p] = torch.ones(s, dtype=torch.float32, device=device)
        else:
            stream = 0 if p == ("embed", "table") else 2
            t = torch.empty(s, dtype=torch.float32, device=device)
            out[p] = t.normal_(0.0, 0.02, generator=generator(seed, device, stream))
    return out


def make_params(model, seed: int, device) -> dict:
    """The whole FP tree, the layers stacked as the program keeps them,
    filled one layer at a time."""
    lay = Layout(model)
    flat = top(lay, seed, device)
    flat.update({p: torch.empty((lay.n_layers,) + s, dtype=torch.float32, device=device)
                 for p, s in lay.dense + lay.gains})
    for i in range(lay.n_layers):
        for q, t in layer(lay, seed, i, device).items():
            flat[("body",) + q][i] = t
    out: dict = {}
    for p in lay.paths:
        _set(out, p, flat[p])
    return out


def calib_tokens(seed: int, n: int, seq_len: int, vocab: int, device) -> torch.Tensor:
    """(n, seq_len) int32 token ids, uniform over the vocabulary."""
    gen = generator(seed, device, stream=1)
    return torch.randint(0, vocab, (n, seq_len), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)
