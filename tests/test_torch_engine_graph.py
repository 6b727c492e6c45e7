"""The serve engine's two programs replayed from CUDA graphs
(``serve_engine/graphs.py``).

On the CPU (tier 1): the engine stays eager and counts its calls so; the
in-place check refuses a program that hands back a fresh cache leaf; and a
program's capture and replay, with a stand-in for the graph, log the
kernel wrappers' ``(work, dims)`` once and hand them to ``record.call``
again on every replay, in order, with the launch counters advanced as an
eager call advances them.

On the card (``requires_cuda``, skipped here): graphs against eager bit for
bit in tokens and every recorded logit row, on reduced brecq-lm-100m and
reduced internlm2-20b (GQA), staggered against sequential, a preempted
stream's resume, a poisoned program that fails only its own stream, a
``share_compiled`` engine with graphs of its own, and the same sequence of
``record.call`` calls and launches graphed and eager. This file imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_engine_graph.py
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.deploy import rtn_artifact
from repro_torch.interop import tree_leaves
from repro_torch.kernels import record
from repro_torch.kernels.qmatmul import ops as qops
from repro_torch.models import get_model
from repro_torch.serve_engine import EngineConfig, ServeEngine
from repro_torch.serve_engine import graphs
from torch_threads import one_torch_thread  # noqa: F401

ECFG = dict(num_slots=3, page_size=4, num_pages=49, max_len=40, prefill_chunk=8,
            record_logits=True)
PROMPT_LENS = (5, 13, 9, 17, 6)
MAX_NEW = (6, 3, 9, 4, 12)
ARRIVALS = (0, 0, 2, 5, 9)


def w4(arch: str, device):
    """A reduced model's RTN W4 artifact; the linear weights at 3x their
    init range and the embedding at 25x, so that greedy decode does not
    settle on one repeated token (``chip_smoke.py::engine_params``)."""
    cfg, model = get_model(arch, reduced=True)
    params = _scale(model.init(torch.Generator(device=device).manual_seed(0)))
    return cfg, model, rtn_artifact(params, 4, None, cfg=cfg)


def _scale(tree, key=""):
    if isinstance(tree, dict):
        return {k: _scale(v, k) for k, v in tree.items()}
    return tree * {"w": 3.0, "table": 25.0}.get(key, 1.0)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def prompts(vocab: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


def staggered(eng, ps):
    """Every request admitted on its arrival tick, ticked to the end."""
    nxt = 0
    while nxt < len(ps) or eng.pending():
        while nxt < len(ps) and ARRIVALS[nxt] <= eng.tick:
            eng.submit(ps[nxt], MAX_NEW[nxt], uid=nxt)
            nxt += 1
        eng.step()
    return eng


def sequential(eng, ps):
    for uid, p in enumerate(ps):
        eng.submit(p, MAX_NEW[uid], uid=uid)
        eng.run()
    return eng


def program_calls(eng) -> int:
    m = eng.metrics()
    return m["decode_ticks"] + m["chunk_rows"] // eng.cfg.prefill_chunk


def tokens(eng) -> dict:
    return {u: list(r.generated) for u, r in eng.requests.items()}


def same_logits(a, b) -> bool:
    return all(len(a.requests[u].logits) == len(b.requests[u].logits)
               and all(np.array_equal(x, y) for x, y in
                       zip(a.requests[u].logits, b.requests[u].logits))
               for u in a.requests)


@contextlib.contextmanager
def calls_seen():
    """What ``record.call`` is handed while inside, as ``(work, dims)``:
    a stand-in on the module attribute, as the benchmark's is."""
    seen, real = [], record.call

    def call(work, *dims):
        seen.append((work.__name__, dims))
        return real(work, *dims)

    record.call = call
    try:
        yield seen
    finally:
        record.call = real


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_w4():
    return w4("brecq_lm_100m", torch.device("cpu"))


def test_engine_stays_eager_on_the_cpu(cpu_w4):
    cfg, model, art = cpu_w4
    eng = ServeEngine(model, art.params, EngineConfig(**ECFG), quant=art.hook())
    assert eng.counters()["program_replays"] == 0
    staggered(eng, prompts(cfg.vocab))
    assert all(r.state == "done" for r in eng.requests.values())
    assert eng._decode_c.graph is None and eng._chunk_c.graph is None
    c, m = eng.counters(), eng.metrics()
    assert c["program_replays"] == m["program_replays"] == 0
    assert c["program_eager_calls"] == m["program_eager_calls"] == program_calls(eng) > 0
    assert eng._in_place == (True, True)


def rebind_first_leaf(tree):
    """Put a copy of the first leaf into the dict that holds it, in place
    of the tensor itself: the container stays the one given."""
    key = sorted(tree)[0]
    if isinstance(tree[key], dict):
        rebind_first_leaf(tree[key])
    else:
        tree[key] = tree[key].clone()
    return tree


@pytest.mark.parametrize("fresh", [clone_tree, rebind_first_leaf],
                         ids=["new_tree", "leaf_rebound_in_the_given_dict"])
def test_in_place_check_refuses_a_fresh_cache_leaf(cpu_w4, fresh):
    cfg, model, art = cpu_w4
    eng = ServeEngine(model, art.params, EngineConfig(**ECFG), quant=art.hook())
    real = eng._decode_fn

    def fresh_leaf(params, tokens, cache, pos, bt):
        logits, out = real(params, tokens, cache, pos, bt)
        return logits, fresh(out)

    eng._decode_fn = fresh_leaf
    eng.compile()
    assert eng._in_place == (False, True)
    given = tree_leaves(eng.cache)
    assert graphs.writes_in_place(given, eng.cache)
    assert not graphs.writes_in_place(given, fresh(eng.cache))
    assert not graphs.writes_in_place(given, {"other": torch.zeros(1)})


class StandInGraph:
    """``torch.cuda.CUDAGraph`` as the CPU can have it: the capture runs
    the program eagerly, a replay only counts."""

    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1


def test_replay_re_reports_the_captured_calls(cpu_w4, monkeypatch):
    cfg, model, art = cpu_w4
    eng = ServeEngine(model, art.params, EngineConfig(**ECFG), quant=art.hook())
    eng.compile()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None, stream=None: contextlib.nullcontext())
    c = eng.cfg
    tok = torch.arange(c.num_slots, dtype=torch.int32)[:, None]
    pos = torch.zeros((c.num_slots,), dtype=torch.int32)
    bt = torch.full((c.num_slots, c.max_pages_per_stream), -1, dtype=torch.int32)
    with calls_seen() as eager:
        before = dict(qops.TIER_COUNTS)
        eng._decode_fn(eng.params, tok, eng.cache, pos, bt)
        step = {k: qops.TIER_COUNTS[k] - before[k] for k in before}
    assert eager and step["decode"] > 0

    prog = graphs.Program(eng._decode_fn)
    before = dict(qops.TIER_COUNTS)
    with calls_seen() as during:
        prog.capture(eng.params, eng.cache, (c.num_slots, 1), c.max_pages_per_stream,
                     stream=None)
    assert during == [] and qops.TIER_COUNTS == before  # logged, not counted
    assert [(w.__name__, d) for w, d in prog.calls] == eager

    for n in (1, 2):
        with calls_seen() as replayed:
            logits, cache = prog(eng.params, tok, eng.cache, pos, bt)
        assert replayed == eager  # the same calls, in order, on every replay
        assert prog.graph.replayed == prog.replays == n and prog.eager_calls == 0
        assert {k: qops.TIER_COUNTS[k] - before[k] for k in before} == {
            k: n * v for k, v in step.items()}
    assert cache is eng.cache and logits is prog.logits
    assert torch.equal(prog.inputs[0], tok) and torch.equal(prog.inputs[2], bt)
    with pytest.raises(ValueError, match="captured with"):
        prog(eng.params, tok, {**eng.cache}, pos, bt)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    return torch.device("cuda")


def engine(model, art, graphed: bool, **over):
    eng = ServeEngine(model, art.params, EngineConfig(**{**ECFG, **over}),
                      quant=art.hook())
    eng.compile(graphs=graphed)
    return eng


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["brecq_lm_100m", "internlm2_20b"])
def test_graphs_equal_eager_bit_for_bit(cuda, arch):
    cfg, model, art = w4(arch, cuda)
    ps = prompts(cfg.vocab)
    graph = engine(model, art, True)
    assert graph._decode_c.graph is not None and graph._chunk_c.graph is not None
    with calls_seen() as seen_g:
        staggered(graph, ps)
    eager = engine(model, art, False)
    with calls_seen() as seen_e:
        staggered(eager, ps)
    assert all(r.state == "done" for r in graph.requests.values())
    assert tokens(graph) == tokens(eager) and same_logits(graph, eager)
    assert len({t for ts in tokens(graph).values() for t in ts}) > 3
    assert seen_g == seen_e and seen_g
    g, e = graph.counters(), eager.counters()
    assert g["program_replays"] == program_calls(graph) and g["program_eager_calls"] == 0
    assert e["program_eager_calls"] == program_calls(eager) and e["program_replays"] == 0

    seq = sequential(engine(model, art, True), ps)
    assert tokens(seq) == tokens(graph) and same_logits(seq, graph)


@pytest.mark.requires_cuda
def test_graphs_count_the_launches_eager_counts(cuda):
    cfg, model, art = w4("brecq_lm_100m", cuda)
    ps = prompts(cfg.vocab)
    counts = []
    for graphed in (True, False):
        eng = engine(model, art, graphed)
        before = [dict(c) for c in graphs.launch_counters()]
        staggered(eng, ps)
        counts.append([{k: n - was[k] for k, n in c.items()}
                       for c, was in zip(graphs.launch_counters(), before)])
    assert counts[0] == counts[1]
    assert sum(sum(c.values()) for c in counts[0]) > 0


def storm(eng, vocab: int):
    """Four streams submitted at once against a pool too small for their
    worst case (``test_torch_engine.py``'s pressure streams): under
    ``overcommit='prompt'`` decode outgrows the reservations and preempts."""
    rng = np.random.default_rng(3)
    for uid, (n, max_new) in enumerate(zip((6, 9, 7, 11), (12, 14, 12, 10))):
        eng.submit(rng.integers(0, vocab, size=n).astype(np.int32), max_new, uid=uid)
    eng.run()
    return eng


@pytest.mark.requires_cuda
def test_graphs_resume_a_preempted_stream_as_eager(cuda):
    cfg, model, art = w4("brecq_lm_100m", cuda)
    pressed = dict(num_pages=12, overcommit="prompt")
    graph = storm(engine(model, art, True, **pressed), cfg.vocab)
    eager = storm(engine(model, art, False, **pressed), cfg.vocab)
    assert graph.metrics()["preemptions"] >= 1 and graph.metrics()["replay_prefill_chunks"] > 0
    assert all(r.state == "done" for r in graph.requests.values())
    assert tokens(graph) == tokens(eager) and same_logits(graph, eager)
    assert graph.counters()["program_replays"] == program_calls(graph)
    graph.assert_no_leaks()


@pytest.mark.requires_cuda
def test_poisoned_replay_fails_only_its_stream(cuda):
    cfg, model, art = w4("brecq_lm_100m", cuda)
    ps = prompts(cfg.vocab)
    clean = staggered(engine(model, art, True), ps)
    eng = engine(model, art, True)
    dec, chunk = eng._decode_c, eng._chunk_c
    fired = []

    def poisoned_decode(params, tokens, cache, pos, bt):
        logits, cache = dec(params, tokens, cache, pos, bt)
        req = eng.requests.get(2)
        if "decode" not in fired and req and req.state == "decode" and len(req.generated) >= 2:
            logits = logits.clone()  # the static logits stay the graph's
            logits[req.slot] = float("nan")
            fired.append("decode")
        return logits, cache

    def poisoned_chunk(params, tokens, cache, pos, bt):
        logits, cache = chunk(params, tokens, cache, pos, bt)
        req = eng.requests.get(3)  # its last chunk, whose logits are read
        if ("chunk" not in fired and req and req.state == "prefill"
                and int(bt[0, 0]) == eng.block_tables[req.slot, 0]
                and len(req.prompt) - req.prefill_off <= eng.cfg.prefill_chunk):
            logits = torch.full_like(logits, float("nan"))
            fired.append("chunk")
        return logits, cache

    eng._decode_c, eng._chunk_c = poisoned_decode, poisoned_chunk
    staggered(eng, ps)
    assert sorted(fired) == ["chunk", "decode"]
    assert eng.requests[2].error == "non-finite logits"
    assert eng.requests[3].error == "non-finite logits at prefill"
    for u in (0, 1, 4):
        assert eng.requests[u].state == "done"
        assert eng.requests[u].generated == clean.requests[u].generated
    assert eng.counters()["program_replays"] == program_calls(eng)
    eng.assert_no_leaks()


@pytest.mark.requires_cuda
def test_shared_engine_captures_its_own_graphs(cuda):
    cfg, model, art = w4("brecq_lm_100m", cuda)
    ps = prompts(cfg.vocab)
    donor = staggered(engine(model, art, True), ps)
    replays = donor.counters()["program_replays"]
    pool = [t.clone() for t in tree_leaves(donor.cache)]
    shared = ServeEngine(model, art.params, EngineConfig(**ECFG), quant=art.hook(),
                         share_compiled=donor)
    staggered(shared, ps)
    assert shared._decode_fn is donor._decode_fn and shared._in_place == (True, True)
    for mine, theirs in ((shared._decode_c, donor._decode_c),
                         (shared._chunk_c, donor._chunk_c)):
        assert mine is not theirs and mine.graph is not None
        assert mine.graph is not theirs.graph and mine.cache is shared.cache
    assert donor.counters()["program_replays"] == replays
    assert shared.counters()["program_replays"] == program_calls(shared)
    assert all(torch.equal(a, b) for a, b in zip(pool, tree_leaves(donor.cache)))
    assert tokens(shared) == tokens(donor) and same_logits(shared, donor)
