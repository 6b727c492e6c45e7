"""Param trees across the package boundary.

A params tree is a nested ``dict`` whose leaves are arrays. The JAX
package and this port share the keys and the stacked layout (the leaves
of ``params[stack.name]`` carry a leading layer dim), so a tree moves
across as numpy: ``params_from_numpy(jax_tree)`` carries the reference
weights into torch, ``params_to_numpy`` carries them back. Dtypes are
kept (int8 codes stay int8, f32 stays f32).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .device import resolve


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict in sorted-key order (the order the JAX
    package flattens dicts in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def flatten_paths(tree: Any, sep: str = "/") -> dict:
    """Nested dict -> {'a/b/c': leaf}, keys in sorted order."""
    out: dict = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        else:
            out[sep.join(prefix)] = node

    walk(tree, ())
    return out


def params_from_numpy(tree: Any, device=None) -> Any:
    """Array-like leaves (numpy, or anything ``np.asarray`` takes) ->
    torch tensors on ``device`` with the same dtype. ``None`` means the
    card (``device.resolve``: raises where there is none); pass
    ``device="cpu"`` for host tensors."""
    dev = resolve(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Torch tensors -> numpy arrays (host copies), same keys and dtypes."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
