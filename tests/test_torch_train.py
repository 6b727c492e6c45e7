"""The port's single-device trainer (``repro_torch.launch.train``) against
the JAX package's, on the CPU.

Reduced brecq-lm-100m and reduced deepseek-moe-16b (its aux loss in the
loss); params cross with ``interop.params_from_numpy``, batches come from
both packages' token-identical ``make_batches``. One step: the loss within
1e-5 relative of JAX's, every gradient leaf within 1e-4 * max|g_leaf| +
1e-7, ``adam.update`` fed JAX's own gradients within 1e-6 of JAX's update,
``cosine_schedule`` within 1e-7. The whole step's params are not held
elementwise at a tight tolerance: Adam's first step is about lr * sign(g),
so a gradient element near 0 that rounds to the other sign in the other
package moves that weight by 2 * lr. ``remat`` changes memory, never
values: none / full / dots give equal losses and gradients. A resumed run
equals an unbroken one bit for bit, and checkpoints cross between the
packages both ways.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.launch import train as jtrain
from repro.models import get_model as j_get_model
from repro.optim import adam as jadam
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import Corpus, CorpusConfig, make_batches
from repro_torch.interop import flatten_paths, params_from_numpy, tree_leaves, tree_map
from repro_torch.launch import train
from repro_torch.models import get_model
from repro_torch.optim import adam
from test_torch_models import np_params
from torch_threads import one_torch_thread  # noqa: F401


SRC = str(Path(__file__).resolve().parents[1] / "src")
LOSS_RTOL = 1e-5
ADAM_ATOL = 1e-6
LR_ATOL = 1e-7
# the CLI of the resume tests: reduced brecq, 4 x 32 tokens a step
CLI = ["--arch", "brecq_lm_100m", "--reduced", "--batch", "4", "--seq", "32",
       "--log-every", "100"]


def grad_tol(g) -> float:
    return 1e-4 * float(np.abs(g).max()) + 1e-7


def batch_np(cfg, step=0, b=4, s=32):
    return make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 1, b, s, seed=0,
                        start_step=step)[0]["tokens"].numpy()


def flat_np(tree) -> dict:
    """'/'-joined paths -> numpy, for either package's tree."""
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_paths(tree).items()}


def acfg_pair(steps=10):
    return (adam.AdamConfig(lr=adam.cosine_schedule(3e-3, 2, steps), grad_clip=1.0),
            jadam.AdamConfig(lr=jadam.cosine_schedule(3e-3, 2, steps), grad_clip=1.0))


@pytest.mark.parametrize("arch", ["brecq_lm_100m", "deepseek_moe_16b"])
def test_one_step_matches_jax(arch):
    jcfg, jmodel = j_get_model(arch, reduced=True)
    cfg, model = get_model(arch, reduced=True)
    assert model.moe_impl == jmodel.moe_impl
    p = np_params(jmodel)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, device="cpu")
    toks = batch_np(cfg)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: jmodel.loss(q, {"tokens": jnp.asarray(toks)}, remat="none")))(jp)
    loss, grads = train.loss_and_grads(model, tp, {"tokens": torch.from_numpy(toks)},
                                       "none")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    if cfg.moe is not None:  # the aux loss is in both
        _, aux = model.forward(tp, {"tokens": torch.from_numpy(toks)})
        assert float(aux) > 0
    jg, g = flat_np(jgrads), flat_np(grads)
    assert set(jg) == set(g)
    for k in jg:
        np.testing.assert_allclose(g[k], jg[k], rtol=0, atol=grad_tol(jg[k]), err_msg=k)

    # Adam on JAX's own gradients, from a fresh state and from a later one
    cfg_t, cfg_j = acfg_pair()
    state, jstate = adam.init(tp), jadam.init(jp)
    jg_t = params_from_numpy(jax.tree.map(np.asarray, jgrads), device="cpu")
    for _ in range(2):
        tp, state = adam.update(cfg_t, jg_t, state, tp)
        jp, jstate = jax.jit(lambda gr, st, pr: jadam.update(cfg_j, gr, st, pr))(
            jgrads, jstate, jp)
        for got, want in ((tp, jp), (state["m"], jstate["m"]), (state["v"], jstate["v"])):
            want_f = flat_np(want)
            for k, a in flat_np(got).items():
                np.testing.assert_allclose(a, want_f[k], rtol=0, atol=ADAM_ATOL, err_msg=k)
        assert int(state["count"]) == int(jstate["count"])


def test_cosine_schedule_matches_jax():
    steps, warmup = 30, 5
    lr = adam.cosine_schedule(3e-3, warmup, steps)
    jlr = jadam.cosine_schedule(3e-3, warmup, steps)
    for c in range(steps + 6):
        np.testing.assert_allclose(float(lr(torch.tensor(c, dtype=torch.int32))),
                                   float(jlr(jnp.asarray(c, jnp.int32))), rtol=0,
                                   atol=LR_ATOL, err_msg=str(c))


class _MMCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["brecq_lm_100m", "deepseek_moe_16b", "whisper_small"])
def test_remat_changes_memory_never_values(arch):
    """none / full / dots: the same loss and gradients, exactly. The
    backward of "full" recomputes every layer's weight matmuls; "dots"
    saves them, so its backward runs as many as "none"'s."""
    from repro_torch.data import arch_extras_fn

    cfg, model = get_model(arch, reduced=True)
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 1, 2, 16, seed=0,
                         extras_fn=arch_extras_fn(cfg))[0]
    out, mms = {}, {}
    for remat in ("none", "full", "dots"):
        tree = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(tree)
        loss = model.loss(tree, batch, remat=remat)
        with _MMCount() as count:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[remat], mms[remat] = (loss.detach(), grads), count.n
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert (a is None and b is None) or torch.equal(a, b)
    assert mms["dots"] == mms["none"] < mms["full"]
    with pytest.raises(ValueError, match="remat"):
        model.loss(params, batch, remat="some")


def _ckpt_leaves(d) -> dict:
    cm = CheckpointManager(d)
    return flatten_paths(cm.restore_nested(cm.latest_step()))


def test_train_resume_cli(tmp_path):
    """As the JAX package's test: 6 steps checkpointed every 3, extended to
    8, then resumed at completion (no step runs; it must exit cleanly)."""
    args = CLI + ["--steps", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
                  "--device", "cpu"]
    train.main(args)
    assert CheckpointManager(tmp_path).all_steps() == [3, 6]
    args8 = [a if a != "6" else "8" for a in args]
    train.main(args8)
    assert CheckpointManager(tmp_path).latest_step() == 8
    out = tmp_path / "m.json"
    train.main(args8 + ["--metrics-out", str(out)])
    assert CheckpointManager(tmp_path).latest_step() == 8
    m = json.loads(out.read_text())
    assert m["steps"] == 0 and m["final_loss"] is None


def test_resumed_run_equals_unbroken_bit_for_bit(tmp_path):
    common = CLI + ["--steps", "6", "--ckpt-every", "3", "--device", "cpu"]
    whole = train.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    train.main(CLI + ["--steps", "3", "--ckpt-every", "3", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path / "b")])
    resumed = train.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    a, b = _ckpt_leaves(tmp_path / "a"), _ckpt_leaves(tmp_path / "b")
    assert set(a) == set(b) and any(k.startswith("opt/m/") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for x, y in zip(tree_leaves(whole), tree_leaves(resumed)):
        assert torch.equal(x, y)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's trainer writes step 3; the port resumes it: at completion it
    returns JAX's params bit for bit, and its next step's loss (on the
    restored params and step 3's batch) is JAX's loss there."""
    jargs = ["--arch", "brecq_lm_100m", "--reduced", "--steps", "3", "--batch", "4",
             "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
             "--log-every", "100"]
    jtrain.main(jargs)
    saved = dict(np.load(tmp_path / "step_00000003" / "arrays.npz"))
    params = train.main(CLI + ["--steps", "3", "--ckpt-dir", str(tmp_path),
                               "--device", "cpu"])
    got = flatten_paths(params)
    assert {f"params/{k}" for k in got} == {k for k in saved if k.startswith("params/")}
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), saved[f"params/{k}"], err_msg=k)

    out = tmp_path / "m.json"
    train.main(CLI + ["--steps", "4", "--ckpt-dir", str(tmp_path), "--device", "cpu",
                      "--metrics-out", str(out)])
    assert CheckpointManager(tmp_path).latest_step() == 4
    _, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    jp = jax.tree.map(jnp.asarray, JCheckpointManager(tmp_path).restore(
        3, {"params": jmodel.init(jax.random.PRNGKey(0))})["params"])
    cfg, _ = get_model("brecq_lm_100m", reduced=True)
    jloss = jmodel.loss(jp, {"tokens": jnp.asarray(batch_np(cfg, step=3))})
    np.testing.assert_allclose(json.loads(out.read_text())["final_loss"], float(jloss),
                               rtol=LOSS_RTOL)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's trainer writes step 2; JAX's ``restore(step, like)`` reads
    every leaf of {"params", "opt": {m, v, count}} equal, same key set."""
    train.main(CLI + ["--steps", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    _, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    like = {"params": jparams, "opt": jadam.init(jparams)}
    restored = JCheckpointManager(tmp_path).restore(2, like)
    saved = dict(np.load(tmp_path / "step_00000002" / "arrays.npz"))
    got = flat_np(restored)
    assert set(got) == set(saved)
    for k, a in got.items():
        assert a.dtype == saved[k].dtype, k
        np.testing.assert_array_equal(a, saved[k], err_msg=k)
    assert int(got["opt/count"]) == 2


def test_save_async_snapshots_the_tree_at_the_call(tmp_path):
    cm = CheckpointManager(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32), "b": {"c": torch.ones(3)}}
    cm.save_async(1, tree)
    tree["a"].add_(100.0)  # in place, after the call
    tree["b"]["c"].zero_()
    cm.wait()
    like = {"a": torch.zeros(6), "b": {"c": torch.zeros(3)}}
    back = cm.restore(1, like)
    assert torch.equal(back["a"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(back["b"]["c"], torch.ones(3))
    assert back["a"].dtype == like["a"].dtype


def test_restore_refuses_a_leaf_of_another_shape(tmp_path):
    """``restore(step, like)`` on a checkpoint of another configuration
    raises, naming the leaf, where a copy would load wrong leaves."""
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"params": {"w": torch.ones(4, 8)}, "count": torch.tensor(1)})
    with pytest.raises(ValueError, match="params/w has shape"):
        cm.restore(1, {"params": {"w": torch.zeros(4, 16)}, "count": torch.tensor(0)})
    back = cm.restore(1, {"params": {"w": torch.zeros(4, 8)}, "count": torch.tensor(0)})
    assert torch.equal(back["params"]["w"], torch.ones(4, 8))


def test_shutdown_checkpoints_at_the_next_step_and_exits(tmp_path, monkeypatch):
    """A SIGTERM during step 1 (through the handler the trainer installed):
    the step finishes, step 2 is checkpointed, and the run stops there."""
    step_fn = train.train_step
    calls = []

    def signalled(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return step_fn(*a, **kw)

    monkeypatch.setattr(train, "train_step", signalled)
    out = tmp_path / "m.json"
    prev = signal.getsignal(signal.SIGTERM)
    train.main(CLI + ["--steps", "6", "--ckpt-dir", str(tmp_path / "c"), "--device",
                      "cpu", "--metrics-out", str(out)])
    assert signal.getsignal(signal.SIGTERM) == prev  # the handler is put back
    assert len(calls) == 2 and json.loads(out.read_text())["steps"] == 2
    assert CheckpointManager(tmp_path / "c").all_steps() == [2]


@pytest.mark.parametrize("case", ["int8_with_model_shard", "int8_at_world_one",
                                  "model_shard_at_world_one"])
def test_multi_device_flags_raise(case, tmp_path):
    """The multi-device flags: int8 with a model axis exits as JAX's parser
    does; int8 alone runs at world 1 (in a subprocess: it starts its own
    one-rank process group); a model axis that does not divide the ranks
    raises, naming the sizes, before any group starts."""
    if case == "int8_with_model_shard":
        with pytest.raises(SystemExit):
            train.parse_args(["--grad-compress", "int8", "--model-shard", "2"])
        assert train.parse_args(["--grad-compress", "int8"]).grad_compress == "int8"
    elif case == "model_shard_at_world_one":
        with pytest.raises(ValueError, match="model axis of 2 does not divide the 1 ranks"):
            train.main(CLI + ["--steps", "1", "--device", "cpu", "--model-shard", "2"])
    else:
        out = tmp_path / "m.json"
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *CLI, "--batch", "2",
             "--seq", "16", "--steps", "2", "--device", "cpu", "--grad-compress", "int8",
             "--metrics-out", str(out)],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})
        assert r.returncode == 0, r.stderr[-3000:]
        m = json.loads(out.read_text())
        assert m["steps"] == 2 and np.isfinite(m["final_loss"]), m
        assert "[mesh] 1 ranks, --grad-compress int8" in r.stdout


def test_train_defaults_to_the_card(monkeypatch):
    """No --device means CUDA: without a card it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(CLI + ["--steps", "1"])
