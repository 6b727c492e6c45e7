"""The traffic generator: deterministic per seed, the same sizes for every
seed, and the stated medians and clips."""
import math
from statistics import median

import numpy as np
import pytest

from perfbench import harness, traffic

SERVE = [w["traffic"] for w in harness.load_spec()["workloads"]
         if harness.load_mix(w["traffic"])["driver"] == "serve"]


@pytest.mark.parametrize("name", SERVE)
def test_deterministic_and_same_sizes(name):
    """Same seed, same requests; another seed, the same sizes in the same
    order with other prompt tokens."""
    mix = harness.load_mix(name)
    a = traffic.draw(mix, 2**31 + 11, 1000)
    b = traffic.draw(mix, 2**31 + 11, 1000)
    c = traffic.draw(mix, 5, 1000)
    assert all((pa == pb).all() and na == nb for (pa, na), (pb, nb) in zip(a, b))
    assert [(len(p), n) for p, n in a] == [(len(p), n) for p, n in c]
    assert any((pa != pc).any() for (pa, _), (pc, _) in zip(a, c))
    # prompt and output lengths are not in the same order
    assert [len(p) for p, _ in a] != sorted(len(p) for p, _ in a)


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("part", ["prompt", "output"])
def test_median_and_clips(name, part):
    mix = harness.load_mix(name)
    law = mix[part]
    n = traffic.lengths(law, mix["requests"])
    assert min(n) >= law["min"] and max(n) <= law["max"]
    assert abs(median(n) - law["median"]) <= 0.05 * law["median"] + 1
    # the spread follows sigma: the quartiles of a log-normal
    q1, q3 = np.percentile(n, [25, 75])
    if law["min"] < q1 and q3 < law["max"]:
        assert abs(math.log(q3 / q1) - 2 * 0.6745 * law["sigma"]) < 0.15


@pytest.mark.parametrize("name", SERVE)
def test_requests_fit_the_engine(name):
    """The longest request fits a slot and the pool; the pool holds the
    slots filled with requests of the mix's mean size, and no more."""
    mix = harness.load_mix(name)
    e = mix["engine"]
    longest = mix["prompt"]["max"] + mix["output"]["max"]
    assert longest <= e["max_len"] and longest <= e["pool_tokens"]
    n = mix["requests"]
    mean = np.mean(np.add(traffic.lengths(mix["prompt"], n), traffic.lengths(mix["output"], n)))
    assert e["num_slots"] * mean <= e["pool_tokens"] < 1.1 * e["num_slots"] * mean


@pytest.mark.parametrize("name", SERVE)
def test_arrivals(name):
    """The same arrivals for every run: the mix's backlog at 0, then Poisson
    arrivals at the stated mean rate, from 0."""
    mix = harness.load_mix(name)
    k = mix.get("backlog", 0)
    a = traffic.arrivals(mix, 51.0)
    assert (a == traffic.arrivals(mix, 51.0)).all() and (a[:k + 1] == 0.0).all()
    p = traffic.arrivals(mix, 51.0, backlog=0)
    assert (p == a[k:]).all()
    assert (np.diff(p) > 0).all() and p[-1] < 51.0
    # the rate is the mean of a pass of the mix's gaps; a window holds part of one
    assert len(p) == pytest.approx(51.0 * mix["rate"], rel=0.1)
    n = mix["requests"]
    b = traffic.arrivals(mix, 3 * n / mix["rate"], backlog=0)
    assert b[n] == pytest.approx(n / mix["rate"])  # one pass of the gaps has the mean
    assert len(traffic.arrivals(mix, 51.0, rate=2 * mix["rate"], backlog=0)) > 1.9 * len(p)
