"""Every name in BENCHMARK.json resolves to its file, and the file sticks to
the contract's shape."""
import json
import re

import pytest

from perfbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and len(w["why"]) <= 200
    config = harness.load_config(SPEC, w["config"])
    mix = harness.load_mix(w["traffic"])
    assert harness.driver_path(mix["driver"]).is_file()
    for key in ("hidden_size", "num_hidden_layers", "vocab_size"):
        assert key in config
    e2e = {m["name"] for m in harness.metrics_for(SPEC, "end_to_end", w["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(SPEC, "per_layer", w["name"])


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    cfg = harness.load_config(SPEC, c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert key in cfg and "published" in cfg and key in cfg["published"]
        assert not key.endswith(("_dim", "_rank", "_size")), key
    assert cfg["deployment"] and "assumed" in cfg


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_resolves(m):
    assert callable(harness.load_metric(m["name"]).read)
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for w in m["workloads"]:
        assert m["moves"] in {e["name"] for e in harness.metrics_for(SPEC, "end_to_end", w)}


def test_end_to_end_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
