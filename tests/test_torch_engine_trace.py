"""The serve engine's spans and counters (``serve_engine/trace.py``) on a
reduced brecq-lm-100m on the CPU: spans change nothing the engine serves,
tick spans nest inside their tick, request spans follow one another, and
the counters count what the engine did."""
import numpy as np
import pytest
import torch

from repro_torch import serve_engine as tse
from repro_torch.models import get_model
from torch_threads import one_torch_thread  # noqa: F401

BASE = dict(num_slots=3, page_size=4, max_len=32, prefill_chunk=8,
            kv_dtype="float32", backend="torch")
RNG = np.random.default_rng(5)
PROMPTS = [RNG.integers(0, 512, size=n).astype(np.int32) for n in (6, 9, 7, 11, 13)]
MAX_NEWS = (12, 14, 12, 10, 3)
ARRIVALS = (0, 0, 1, 3, 4)
TICK_CHILDREN = ("tick.schedule", "chunk.stage", "chunk.launch", "chunk.readback",
                 "decode.stage", "decode.launch", "decode.readback", "decode.sample")


@pytest.fixture(scope="module")
def mk():
    _, model = get_model("brecq_lm_100m", reduced=True)
    params = model.init(torch.Generator().manual_seed(0))
    donors: dict = {}

    def make(**over):
        cfg = tse.EngineConfig(**{**BASE, **over})
        eng = tse.ServeEngine(model, params, cfg,
                              share_compiled=donors.get(cfg.program_shape))
        donors.setdefault(cfg.program_shape, eng)
        return eng

    return make


def serve(eng, spans: bool):
    """The streams submitted on their arrival ticks, ticked to the end."""
    if spans:
        eng.trace.enable()
    nxt = 0
    while nxt < len(PROMPTS) or eng.pending():
        while nxt < len(PROMPTS) and ARRIVALS[nxt] <= eng.tick:
            eng.submit(PROMPTS[nxt], MAX_NEWS[nxt], uid=nxt)
            nxt += 1
        eng.step()
    snap = eng.trace.snapshot()
    eng.trace.disable()
    return snap


@pytest.fixture(scope="module", params=["none", "prompt"])
def pair(request, mk):
    """(engine with spans off, its snapshot, engine with spans on, its
    snapshot); ``prompt``: overcommit on a pool that forces preemptions."""
    over = {"num_pages": 49} if request.param == "none" else {
        "num_pages": 12, "overcommit": "prompt"}
    off = mk(**over)
    snap_off = serve(off, False)
    on = mk(**over)
    return off, snap_off, on, serve(on, True), request.param


def test_spans_change_nothing_served(pair):
    off, _, on, _, _ = pair
    assert on.events == off.events
    for uid in range(len(PROMPTS)):
        assert on.requests[uid].state == "done"
        assert on.requests[uid].generated == off.requests[uid].generated
    assert on.metrics()["ticks"] == off.metrics()["ticks"]


def test_spans_off_snapshot_has_none(pair):
    _, snap_off, _, snap_on, _ = pair
    assert snap_off["spans"] == []
    assert snap_on["spans"]
    same = [k for k in snap_off["counters"] if k != "plans_built"]  # process-wide
    assert [snap_on["counters"][k] for k in same] == [snap_off["counters"][k] for k in same]


def test_tick_children_nest(pair):
    _, _, on, snap, _ = pair
    spans = snap["spans"]
    ticks = [i for i, s in enumerate(spans) if s[0] == "tick"]
    assert len(ticks) == on.tick
    kids: dict = {i: [] for i in ticks}
    for name, t0, t1, uid, parent in spans:
        assert t0 <= t1
        if name in TICK_CHILDREN:
            kids[parent].append((t0, t1, name, uid))
            _, p0, p1, _, _ = spans[parent]
            assert p0 <= t0 and t1 <= p1, name
            assert (uid == -1) == (not name.startswith("chunk.")), name
        else:
            assert name in ("tick", "queued", "prefill", "decode"), name
    for i in ticks:
        got = sorted(kids[i])
        assert got[0][2] == "tick.schedule"
        assert all(a[1] <= b[0] for a, b in zip(got, got[1:]))  # in order, apart
        assert sum(t1 - t0 for t0, t1, _, _ in got) <= spans[i][2] - spans[i][1]


def test_request_spans_follow_one_another(pair):
    _, _, on, snap, mode = pair
    spans = snap["spans"]
    ticks = [s for s in spans if s[0] == "tick"]
    first_tick = {u: t for t, ev, u in on.events if ev == "first_token"}
    for uid in range(len(PROMPTS)):
        mine = sorted((s for s in spans if s[3] == uid and s[0] in ("queued", "prefill",
                                                                     "decode")),
                      key=lambda s: s[1])
        names = [s[0] for s in mine]
        preempted = on.requests[uid].preemptions
        assert names.count("queued") == names.count("prefill") == 1 + preempted
        assert names[0] == "queued" and names[-1] == "decode"
        for a, b in zip(mine, mine[1:]):
            assert a[2] == b[1]  # one ends where the next begins
            if b[0] != "queued":
                assert spans[b[4]] == a  # caused by the span before it
        first_prefill = mine[names.index("prefill")]
        _, t0, t1, _, _ = ticks[first_tick[uid]]
        assert t0 <= first_prefill[2] <= t1  # ends at the first_token tick
    if mode == "prompt":
        assert any(on.requests[u].preemptions for u in range(len(PROMPTS)))


def test_tick_counters(pair):
    _, _, on, _, _ = pair
    m = on.metrics()
    kinds = m["ticks_chunk"] + m["ticks_decode"] + m["ticks_both"]
    assert 0 < kinds <= m["ticks"]
    assert m["ticks_chunk"] + m["ticks_both"] == sum(
        ev == "prefill_chunk" for _, ev, _ in on.events)
    assert m["ticks_decode"] + m["ticks_both"] == m["decode_ticks"]
    assert m["chunk_rows"] == BASE["prefill_chunk"] * sum(
        ev == "prefill_chunk" for _, ev, _ in on.events)


def test_chunk_tokens_count_replays(mk):
    """Every token a chunk feeds, the replays of preempted streams too."""
    eng = mk(num_pages=12, overcommit="prompt")
    fed = []
    orig = eng._prefill_chunk

    def counted(req):
        src = req.prefill_src if req.prefill_src is not None else req.prompt
        fed.append(len(src[req.prefill_off:req.prefill_off + BASE["prefill_chunk"]]))
        orig(req)

    eng._prefill_chunk = counted
    serve(eng, False)
    m = eng.metrics()
    assert m["preemptions"] >= 1
    assert m["chunk_tokens"] == sum(fed) > sum(map(len, PROMPTS))
    fresh = mk(num_pages=49)
    serve(fresh, False)
    assert fresh.metrics()["chunk_tokens"] == sum(map(len, PROMPTS))


def test_admission_wait_counters(mk):
    """The head of the queue waits on pages with a slot free when the pool
    holds one request's worst case and not two; on slots when every slot
    is taken."""
    need = -(-(len(PROMPTS[0]) + MAX_NEWS[0]) // BASE["page_size"])
    eng = mk(num_pages=need + 2)
    eng.submit(PROMPTS[0], MAX_NEWS[0], uid=0)
    eng.submit(PROMPTS[0], MAX_NEWS[0], uid=1)
    eng.step()
    assert eng.requests[1].state == "waiting" and eng.slot_req.count(None) == 2
    assert eng.metrics()["admit_wait_pages"] == 1
    eng.run()
    m = eng.metrics()
    assert m["admit_wait_pages"] > 1 and m["admit_wait_slots"] == 0
    eng = mk(num_pages=49)
    for uid in range(BASE["num_slots"] + 1):
        eng.submit(PROMPTS[uid], MAX_NEWS[uid], uid=uid)
    eng.step()
    m = eng.metrics()
    assert (m["admit_wait_slots"], m["admit_wait_pages"]) == (1, 0)


def test_plans_built_reads_the_plan_caches(mk):
    from repro_torch.kernels import spec

    eng = mk(num_pages=49)
    before = eng.metrics()["plans_built"]
    spec.plan_kv_decode(3, 2, 1_000_003, 64)  # a shape no other test plans
    assert eng.metrics()["plans_built"] == before + 1
