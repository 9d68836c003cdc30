"""The optimizer, the int8 quantizer, the checkpointer and the supervised
``Trainer`` (mirroring ``tests/test_optim.py`` and ``tests/test_trainer.py``),
each held against the JAX package where it computes the same numbers.
The ``Trainer`` is driven with the port's SAGE step function
(``models.sage_minibatch.make_sage_train_step``): a recovered run equals a
clean one bit for bit."""

import shutil
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import OptimizerConfig as JOpt
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config import (CORA, OptimizerConfig, TrainConfig,
                                reduced_graph)
from repro_torch.data.pipeline import GraphPipeline
from repro_torch.graph.datasets import (make_features, make_labels,
                                        make_synthetic_graph)
from repro_torch.models.sage_minibatch import (SageMiniBatchModel,
                                               make_sage_train_step)
from repro_torch.optim.compression import (_quantize, compression_wire_bytes,
                                           init_residuals)
from repro_torch.optim.optimizer import (adamw_update, cosine_lr,
                                         global_norm, make_train_state,
                                         tree_map)
from repro_torch.train.trainer import FailureInjector, StepWatchdog, Trainer

torch.set_num_threads(2)


def test_adamw_converges_quadratic():
    opt = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=200,
                          weight_decay=0.0, grad_clip=0.0)
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32))
    state = make_train_state({"w": torch.zeros((4, 4))}, opt)
    for _ in range(150):
        state, _ = adamw_update(state, {"w": 2 * (state.params["w"] - target)},
                                opt)
    assert float(((state.params["w"] - target) ** 2).sum()) < 1e-2


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,decay", [(0.0, 0.0), (1.0, 0.1)])
def test_adamw_matches_reference(moments, clip, decay):
    """Five AdamW steps on the same gradients: parameters and moments
    within the f32 band (bf16 moments in the bf16 band)."""
    kw = dict(lr=0.05, warmup_steps=2, total_steps=10, grad_clip=clip,
              weight_decay=decay, moment_dtype=moments)
    rng = np.random.default_rng(1)
    p0 = {"w": rng.standard_normal((6, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    js = jopt.make_train_state(jax.tree.map(jnp.asarray, p0), JOpt(**kw))
    ts = make_train_state(tree_map(torch.from_numpy, p0),
                          OptimizerConfig(**kw))
    for _ in range(5):
        g = {"w": rng.standard_normal((6, 3)).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32)}
        js, jm = jopt.adamw_update(js, jax.tree.map(jnp.asarray, g),
                                   JOpt(**kw))
        ts, tm = adamw_update(ts, tree_map(torch.from_numpy, g),
                              OptimizerConfig(**kw))
    band = "bf16" if moments == "bfloat16" else "f32"
    for k in p0:
        assert_allclose_dtype(ts.params[k].numpy(), np.asarray(js.params[k]),
                              scale=10)
        assert_allclose_dtype(ts.m[k].float().numpy(),
                              np.asarray(js.m[k], np.float32), dtype=band)
    assert int(ts.step) == int(js.step) == 5
    assert_allclose_dtype(float(tm["lr"]), float(jm["lr"]))
    assert_allclose_dtype(float(tm["grad_norm"]), float(jm["grad_norm"]))


def test_cosine_schedule_shape():
    opt = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(cosine_lr(opt, 0)) == 0.0
    assert float(cosine_lr(opt, 10)) == pytest.approx(1.0)
    assert float(cosine_lr(opt, 100)) == pytest.approx(0.0, abs=1e-6)
    assert 0.4 < float(cosine_lr(opt, 55)) < 0.6
    jo = JOpt(lr=1.0, warmup_steps=10, total_steps=100)
    for s in (0, 3, 10, 37, 55, 99, 100, 120):
        assert_allclose_dtype(float(cosine_lr(opt, s)),
                              float(jopt.cosine_lr(jo, jnp.asarray(s))))


def test_grad_clip_caps_norm():
    opt = OptimizerConfig(lr=0.0, grad_clip=1.0)
    state = make_train_state({"w": torch.zeros(8)}, opt)
    _, metrics = adamw_update(state, {"w": torch.full((8,), 100.0)}, opt)
    assert float(metrics["grad_norm"]) > 100
    assert float(global_norm({"a": torch.ones(4), "b": torch.ones(5)})) == 3


def test_weight_decay_skips_vectors():
    opt = OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=1.0)
    params = {"w": torch.ones((4, 4)), "b": torch.ones(4)}
    state = make_train_state(params, opt)
    state, _ = adamw_update(state, tree_map(torch.zeros_like, params), opt)
    assert float((state.params["w"] - 1.0).abs().max()) > 0
    assert float((state.params["b"] - 1.0).abs().max()) == 0


def test_moment_dtype_bf16():
    state = make_train_state({"w": torch.ones(4)},
                             OptimizerConfig(moment_dtype="bfloat16"))
    assert state.m["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="moment_dtype"):
        make_train_state({"w": torch.ones(4)},
                         OptimizerConfig(moment_dtype="float16"))


# ----------------------------------------------------------- compression
def test_quantize_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(0)
    residual = torch.zeros(64)
    total_g, total_sent = np.zeros(64), np.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        q, scale, residual = _quantize(g, residual)
        total_g += g.numpy()
        total_sent += q.numpy().astype(np.float64) * float(scale)
    np.testing.assert_allclose(total_sent + residual.numpy(), total_g,
                               rtol=1e-4, atol=1e-4)


def test_quantize_matches_reference():
    g = np.random.default_rng(2).standard_normal(200).astype(np.float32) * 3
    r = np.random.default_rng(3).standard_normal(200).astype(np.float32)
    q, scale, res = _quantize(torch.from_numpy(g), torch.from_numpy(r))
    jq, jscale, jres = jcomp._quantize(jnp.asarray(g), jnp.asarray(r))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    assert_allclose_dtype(res.numpy(), np.asarray(jres))
    big = torch.tensor([-1000.0, 0.0, 1000.0])
    q, scale, _ = _quantize(big, torch.zeros(3))
    assert int(q.abs().max()) <= 127
    np.testing.assert_allclose(q.float().numpy() * float(scale), big.numpy(),
                               rtol=1e-2, atol=float(scale))
    res = init_residuals({"a": torch.ones(3, dtype=torch.bfloat16)})
    assert res["a"].dtype == torch.float32 and not res["a"].any()


def test_wire_bytes_model():
    w = compression_wire_bytes(1_000_000, dp=16)
    assert w == jcomp.compression_wire_bytes(1_000_000, dp=16)
    assert w["fp32_bytes"] / w["int8_ef_bytes"] == pytest.approx(4.0)


# ----------------------------------------------------------- checkpointer
def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.tensor([1.5, -2.25, 3.0, 7.0],
                                         dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "opt": make_train_state({"w": torch.ones(2)}, OptimizerConfig())}


@pytest.fixture
def ckdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d)


def test_checkpoint_roundtrip(ckdir):
    ck = Checkpointer(ckdir, keep=2)
    st = _state()
    ck.save(3, st, extra={"pipeline": {"step": 3, "seed": 0}}, blocking=True)
    template = tree_map(torch.zeros_like, _state())
    restored, step, extra = ck.restore(template)
    assert step == 3 and extra["pipeline"]["step"] == 3
    assert torch.equal(restored["params"]["w"], st["params"]["w"])
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["b"], st["params"]["b"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    assert type(restored["opt"]).__name__ == "TrainState"
    assert torch.equal(restored["opt"].params["w"], torch.ones(2))


def test_checkpoint_snapshot_is_taken_at_save(ckdir):
    """An async save writes the values at the call, not later updates."""
    ck = Checkpointer(ckdir)
    st = {"w": torch.ones(1000)}
    ck.save(1, st)
    st["w"].add_(1.0)
    ck.wait()
    restored, _, _ = ck.restore({"w": torch.zeros(1000)})
    assert torch.equal(restored["w"], torch.ones(1000))


def test_checkpoint_retention_and_latest(ckdir):
    ck = Checkpointer(ckdir, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(), blocking=True)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_async_then_wait(ckdir):
    ck = Checkpointer(ckdir, keep=1)
    ck.save(1, _state(), blocking=False)
    ck.wait()
    assert ck.latest_step() == 1


def test_checkpoint_atomicity_no_partial_dirs(ckdir):
    ck = Checkpointer(ckdir, keep=3)
    (Path(ckdir) / "step_000000000099.tmp").mkdir()
    ck.save(1, _state(), blocking=True)
    assert ck.all_steps() == [1]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(Path(ckdir) / "empty")).restore(_state())


def test_checkpoint_shape_mismatch_raises(ckdir):
    ck = Checkpointer(ckdir)
    ck.save(1, _state(), blocking=True)
    bad = _state()
    bad["params"]["w"] = torch.zeros((5, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(bad)
    bad = _state()
    bad["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError):
        ck.restore(bad)


# ----------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def setup():
    spec = reduced_graph(CORA, 256, 16)
    g = make_synthetic_graph(spec, device="cpu")
    x = make_features(spec, device="cpu")
    y = make_labels(spec, device="cpu")
    model = SageMiniBatchModel(spec.feature_len, 32, spec.num_classes,
                               device="cpu",
                               generator=torch.Generator().manual_seed(0))
    init = tree_map(lambda t: t.detach().clone(), model.init())
    opt = OptimizerConfig(lr=0.01, warmup_steps=2, total_steps=20)
    step_fn = make_sage_train_step(model, x, y, opt)

    def make_state():
        return make_train_state(tree_map(torch.clone, init), opt)
    return spec, g, opt, step_fn, make_state


def _trainer(setup, tdir, steps=10, fail_at=(), ckpt_every=3):
    spec, g, opt, step_fn, make_state = setup
    tc = TrainConfig(model="sage", steps=steps, checkpoint_every=ckpt_every,
                     log_every=100, checkpoint_dir=tdir, optimizer=opt)
    return Trainer(tc, make_state=make_state, step_fn=step_fn,
                   pipeline=GraphPipeline(g, spec, 16, fanouts=(3, 3),
                                          seed=1, device="cpu"),
                   failure_injector=FailureInjector(fail_at=fail_at))


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def test_recovery_bitwise_equals_clean_run(setup, ckdir):
    d2 = tempfile.mkdtemp()
    try:
        res_f = _trainer(setup, ckdir, fail_at=(5,)).run()
        res_c = _trainer(setup, d2).run()
        assert res_f["recoveries"] == 1
        assert float(res_f["metrics"]["loss"]) == \
            float(res_c["metrics"]["loss"])
        assert all(torch.equal(p, q) for p, q in zip(
            _leaves(res_f["state"]), _leaves(res_c["state"])))
        assert np.isfinite(float(res_c["metrics"]["loss"]))
    finally:
        shutil.rmtree(d2)


def test_multiple_failures(setup, ckdir):
    res = _trainer(setup, ckdir, fail_at=(2, 7)).run()
    assert res["recoveries"] == 2


def test_resume_from_kill(setup, ckdir):
    """A run of 6 steps, then a fresh Trainer resumes to 10: its last loss
    equals a clean 10-step run's."""
    _trainer(setup, ckdir, steps=6, ckpt_every=2).run()
    res = _trainer(setup, ckdir, steps=10, ckpt_every=2).run()
    d2 = tempfile.mkdtemp()
    try:
        res_c = _trainer(setup, d2, steps=10, ckpt_every=2).run()
        assert float(res["metrics"]["loss"]) == \
            float(res_c["metrics"]["loss"])
    finally:
        shutil.rmtree(d2)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=2.0, max_straggler_steps=3)
    restart = False
    for i in range(10):
        restart = wd.observe(i, 0.1)
    assert not restart and wd.straggler_steps == []
    for i in range(10, 13):
        restart = wd.observe(i, 1.0)
    assert restart
    assert len(wd.straggler_steps) == 3


def test_sharded_state_is_not_ported(setup, ckdir):
    """Sharded state and batches are ported: the ``Trainer`` takes their
    shardings (a DTensor run on a mesh, which
    ``tests/test_torch_launch_train.py`` drives); without them the run is
    the unsharded one above."""
    spec, g, opt, step_fn, make_state = setup
    tc = TrainConfig(model="sage", checkpoint_dir=ckdir)
    tr = Trainer(tc, make_state=make_state, step_fn=step_fn, pipeline=None,
                 state_shardings={}, batch_shardings={})
    assert tr.state_shardings == {} and tr.batch_shardings == {}
    plain = Trainer(tc, make_state=make_state, step_fn=step_fn,
                    pipeline=None)
    assert plain.state_shardings is None and plain.batch_shardings is None
