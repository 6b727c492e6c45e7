"""The one generator every traffic mix of the serving driver goes through.

A mix file gives the length laws of prompts and outputs (log-normal with a
median and a sigma, clipped), the number ``requests`` of distinct requests,
the offered ``rate`` in requests a second and ``order_seed``. The lengths
are the laws' quantiles at ``(i + 0.5) / requests``, and the gaps between
arrivals the quantiles of an exponential law (a Poisson process) scaled to
a mean of ``1 / rate``, each put in an order drawn from ``order_seed``: a
replayed trace, the same sizes and arrivals in the same order for every
run, cycling past ``requests``. A mix above the knee may give a
``backlog``: that many of its requests already queued when the window
opens, as at a service past its capacity, with the Poisson arrivals after
them. While the queue never empties, the engine's ticks are one sequence
in every run, whatever the host's pace. The run's seed draws the prompt
tokens (and the driver's weights). The order is fixed because it moves the
tails: with it drawn from the seed, the conversation mix's
``ttft_p95_ms`` read 4.5 s on some seeds and 7.8 s on others, while two
runs of one seed agreed within 1%.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def lengths(law: dict, n: int) -> list[int]:
    nd = NormalDist()
    mu, sigma = math.log(law["median"]), law["sigma"]
    out = []
    for i in range(n):
        x = math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n))
        out.append(int(min(max(round(x), law["min"]), law["max"])))
    return out


def arrivals(mix: dict, horizon_s: float, rate: float | None = None,
             backlog: int | None = None) -> np.ndarray:
    """Arrival times in seconds from the window's start, up to ``horizon_s``,
    at the mix's rate (or ``rate``), after the mix's backlog (or
    ``backlog``) at 0."""
    n = mix["requests"]
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    gaps = np.random.default_rng(mix["order_seed"] + 1).permutation(gaps / gaps.mean())
    gaps /= rate or mix["rate"]
    reps = int(horizon_s / gaps.sum()) + 1
    t = np.cumsum(np.tile(gaps, reps)) - gaps[0]
    k = mix.get("backlog", 0) if backlog is None else backlog
    return np.concatenate([np.zeros(k), t[t < horizon_s]])


def draw(mix: dict, seed: int, vocab: int) -> list[tuple[np.ndarray, int]]:
    """The mix's requests in its order: (prompt token ids drawn from
    ``seed``, tokens to generate)."""
    n = mix["requests"]
    order = np.random.default_rng(mix["order_seed"])
    p_len = order.permutation(lengths(mix["prompt"], n))
    o_len = order.permutation(lengths(mix["output"], n))
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(pl), dtype=np.int64).astype(np.int32), int(ol))
            for pl, ol in zip(p_len, o_len)]
