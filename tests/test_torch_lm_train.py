"""The port's LM training path on the CPU against the JAX package.

``lm_loss`` (chunked cross-entropy, each chunk under
``torch.utils.checkpoint``) and the gradient of every parameter must
match ``jax.value_and_grad`` of ``repro.models.transformer.lm_loss`` on
the reduced f32 gemma2 (local/global layers, softcaps, tied embeddings)
and granite, with the reference's ``init_lm`` weights loaded through
``params_from_reference``: sequences past the reduced window of 16, a
``ce_chunk`` that divides the tokens and one that does not (the unchunked
fallback), a padded vocabulary, labels -100, ``remat="full"``, and one
sequence of 2560 tokens, where both sides run ``flash_attention_xla``.
The loss must be in the f32 band, each gradient leaf within 1e-4 of that
leaf's largest magnitude.

Then the pieces around it: ``init_lm``'s leaves (names, shapes, per-leaf
std) against the reference's; three ``make_train_step`` AdamW steps, with
and without ``microbatch=2``, against the reference's step (parameters
within 1e-4); ``make_eval_step``; ``Trainer`` resume through
``make_train_step`` bit for bit; ``launch/train_lm.py`` cut short;
``LMConfig.param_count``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import get_config as jget_config
from repro.configs import gemma2_9b as jgemma
from repro.configs import granite_3_8b as jgranite
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.nn import layers as jlayers
from repro.optim import optimizer as jopt
from repro_torch.config import OptimizerConfig, ShapeSpec, get_config
from repro_torch.configs import gemma2_9b, granite_3_8b
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train_lm
from repro_torch.models import transformer as ttr
from repro_torch.nn import layers
from repro_torch.optim.optimizer import make_train_state
from repro_torch.train.trainer import FailureInjector

torch.set_num_threads(2)

ARCHS = {"gemma2": (gemma2_9b, jgemma), "granite": (granite_3_8b, jgranite)}
#: each gradient leaf against the reference's, over that leaf's largest
#: magnitude (chip_smoke.py holds step-0 gradients to the same limit)
LEAF_LIMIT = 1e-4


def _cfgs(arch, vocab=None):
    tmod, jmod = ARCHS[arch]
    cfg = dataclasses.replace(tmod.reduced(), dtype="float32")
    jcfg = dataclasses.replace(jmod.reduced(), dtype="float32")
    if vocab is not None:   # a vocab below the 256-row padding
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
    return cfg, jcfg


def _models(arch, vocab=None, seed=0):
    cfg, jcfg = _cfgs(arch, vocab)
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(tree)
    return cfg, jcfg, params, model


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -100, np.int32)],
                            axis=1)
    labels[0, 3] = labels[-1, s // 2] = -100
    return toks, labels


def _leaf_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check_loss_and_grads(cfg, jcfg, params, model, toks, labels, **kw):
    jkw = {k: v for k, v in kw.items() if k in ("ce_chunk", "remat")}
    (jloss, jm), jgrad = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jcfg, jnp.asarray(toks),
                              jnp.asarray(labels), **jkw),
        has_aux=True)(params)
    loss, metrics = ttr.lm_loss(model, torch.from_numpy(toks),
                                torch.from_numpy(labels), **kw)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    assert_allclose_dtype(loss.detach(), np.asarray(jloss))
    assert_allclose_dtype(metrics["ce"].detach(), np.asarray(jm["ce"]))
    assert float(metrics["aux"]) == 0.0
    want = ttr.flatten_reference(jax.tree.map(np.asarray, jgrad), cfg)
    assert sorted(want) == sorted(names)
    errs = {n: _leaf_err(g.numpy(), want[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_LIMIT, (worst, errs[worst])


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("ce_chunk,vocab", [(16, None), (48, 250)])
def test_lm_loss_and_gradients_match_reference(arch, ce_chunk, vocab):
    """B 2 x S 40 (80 tokens, past the window of 16): ``ce_chunk`` 16
    divides them, 48 does not (one unchunked chunk); vocab 250 pads to 256
    rows, masked with -1e30."""
    cfg, jcfg, params, model = _models(arch, vocab)
    assert (cfg.padded_vocab != cfg.vocab_size) == (vocab is not None)
    toks, labels = _batch(cfg, 2, 40)
    _check_loss_and_grads(cfg, jcfg, params, model, toks, labels,
                          ce_chunk=ce_chunk)


def test_lm_loss_full_remat_matches_reference():
    """``remat="full"``: each period under torch.utils.checkpoint, against
    the reference's ``jax.checkpoint`` of its scan body."""
    cfg, jcfg, params, model = _models("gemma2")
    toks, labels = _batch(cfg, 2, 24)
    _check_loss_and_grads(cfg, jcfg, params, model, toks, labels,
                          ce_chunk=16, remat="full")


def test_lm_loss_at_2560_tokens_runs_flash_attention_xla(monkeypatch):
    """Past 2048 tokens both sides attend through their flash VJPs."""
    from repro_torch.nn import attention as tattn
    calls = {"n": 0}
    xla = tattn.flash_attention_xla

    def spy(*a, **kw):
        calls["n"] += 1
        return xla(*a, **kw)
    monkeypatch.setattr(tattn, "flash_attention_xla", spy)
    cfg, jcfg, params, model = _models("gemma2")
    toks, labels = _batch(cfg, 1, 2560)
    _check_loss_and_grads(cfg, jcfg, params, model, toks, labels)
    assert calls["n"] == cfg.num_layers


def test_train_step_with_full_remat_matches_without():
    """``make_train_step(remat="full")``: the loss runs through
    ``functional_call`` on a ``meta`` skeleton, and the backward's
    recomputation of each checkpointed period must see the state's
    parameters, not the skeleton's.  The step equals the one without
    remat bit for bit."""
    cfg, _, _, model = _models("gemma2")
    opt = _opt()[0]
    batch = TokenPipeline(cfg, ShapeSpec("t", 24, 2, "train"),
                          seed=2).batch_at(0)
    state = make_train_state(
        {k: p.detach() for k, p in model.named_parameters()}, opt)
    full, m_full = tsteps.make_train_step(cfg, opt, remat="full")(state,
                                                                  batch)
    none, m_none = tsteps.make_train_step(cfg, opt)(state, batch)
    assert torch.equal(m_full["loss"], m_none["loss"])
    assert torch.equal(m_full["grad_norm"], m_none["grad_norm"])
    for k, p in full.params.items():
        assert torch.equal(p, none.params[k]), k


def test_lm_loss_refuses_selective_remat():
    """``remat="selective"`` is ported (the reference's
    ``dots_with_no_batch_dims_saveable``): its loss is ``"none"``'s bit
    for bit; a mode the port does not have is refused."""
    cfg, _, _, model = _models("granite")
    toks, labels = _batch(cfg, 1, 8)
    toks, labels = torch.from_numpy(toks), torch.from_numpy(labels)
    got, _ = ttr.lm_loss(model, toks, labels, remat="selective")
    want, _ = ttr.lm_loss(model, toks, labels)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="dots"):
        ttr.lm_loss(model, toks, labels, remat="dots")


def test_lm_loss_through_functional_call_matches_the_module():
    """``params=`` runs the loss over a dict of tensors by name on a
    structure-only (meta) module: the same loss as the module's own."""
    cfg, _, _, model = _models("gemma2")
    toks, labels = _batch(cfg, 2, 20)
    skel = ttr.TransformerLM(cfg, device="meta")
    params = {k: p.detach() for k, p in model.named_parameters()}
    with torch.no_grad():
        a, _ = ttr.lm_loss(model, torch.from_numpy(toks),
                           torch.from_numpy(labels))
        b, _ = ttr.lm_loss(skel, torch.from_numpy(toks),
                           torch.from_numpy(labels), params=params)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_lm_leaves_match_reference(arch):
    """Names and shapes equal the reference's ``init_lm`` leaves; each
    leaf's std matches (same scale per leaf; different random streams)."""
    cfg, jcfg = _cfgs(arch)
    cfg = dataclasses.replace(cfg, d_model=128, d_ff=256)
    jcfg = dataclasses.replace(jcfg, d_model=128, d_ff=256)
    want = ttr.flatten_reference(
        jax.tree.map(np.asarray, jtr.init_lm(jcfg, jax.random.PRNGKey(1))),
        cfg)
    model = ttr.init_lm(cfg, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, a in got.items():
        assert a.shape == want[n].shape and a.dtype == np.float32, n
        if n.endswith("scale"):      # norm scales start at 0
            assert not a.any() and not want[n].any(), n
        else:
            ratio = a.std() / want[n].std()
            assert abs(ratio - 1) < 0.05, (n, ratio)


def _opt(weight_decay=0.1):
    # eps above the gradients' f32 noise (about 1e-7 of a leaf's largest
    # gradient): at the default 1e-8 an element whose gradient is that
    # noise steps by m / (sqrt(v) + eps), about +-lr, in either direction,
    # in both implementations alike
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10,
              weight_decay=weight_decay, eps=1e-6)
    return OptimizerConfig(**kw), JOptimizerConfig(**kw)


@pytest.mark.parametrize("microbatch,weight_decay", [(0, 0.0), (2, 0.0),
                                                     (0, 0.1)])
def test_train_steps_match_reference(microbatch, weight_decay):
    """Three AdamW steps of ``make_train_step`` from the reference's
    weights on TokenPipeline batches against the reference's step: each
    parameter leaf within 1e-4 of its largest magnitude (a norm's scales
    as the 1 + scale it applies), the metrics in the f32 band (scale 10:
    three steps of updates).

    ``adamw_update`` decays leaves of two or more dimensions ("no decay on
    norms"): the reference's scales are stacked (n_rep, d) leaves, so its
    decay reaches them, the port's 1-D per-layer scales it does not -- a
    difference of about weight_decay lr^2 a step, far below 1e-4 of the
    1 + scale a norm applies."""
    cfg, jcfg, params, model = _models("gemma2")
    opt, jopt_cfg = _opt(weight_decay)
    pipe = TokenPipeline(cfg, ShapeSpec("t", 24, 4, "train"), seed=0)
    state = make_train_state(
        {k: p.detach() for k, p in model.named_parameters()}, opt)
    jstate = jopt.make_train_state(params, jopt_cfg)
    step = tsteps.make_train_step(cfg, opt, microbatch=microbatch)
    jstep = jsteps.make_train_step(jcfg, jopt_cfg, microbatch=microbatch)
    for i in range(3):
        batch = pipe.batch_at(i)
        state, metrics = step(state, batch)
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert_allclose_dtype(metrics[key], np.asarray(jmetrics[key]),
                                  scale=10, err_msg=key)
    assert int(state.step) == 3
    want = ttr.flatten_reference(jax.tree.map(np.asarray, jstate.params),
                                 cfg)
    # an RMSNorm applies 1 + scale: its scales start at 0 and move by
    # about lr a step, so they are held as the weight the norm applies
    scales = {n for n in want if n.endswith(".scale")}
    errs = {n: _leaf_err(p.numpy() + (n in scales), want[n] + (n in scales))
            for n, p in state.params.items()}
    assert all(e <= LEAF_LIMIT for e in errs.values()), \
        {n: e for n, e in errs.items() if e > LEAF_LIMIT}


def test_microbatch_accumulates_in_accum_dtype():
    """The microbatch buffers take ``opt.accum_dtype``: in bf16 the summed
    gradients are rounded to 8 bits, so the gradient norm moves within the
    bf16 band of the f32 buffers' while the loss stays bit for bit."""
    cfg, _, _, model = _models("granite")
    opt = dataclasses.replace(_opt()[0], accum_dtype="bfloat16")
    pipe = TokenPipeline(cfg, ShapeSpec("t", 16, 4, "train"), seed=1)
    params = {k: p.detach() for k, p in model.named_parameters()}
    batch = pipe.batch_at(0)
    _, m_bf16 = tsteps.make_train_step(cfg, opt, microbatch=2)(
        make_train_state(params, opt), batch)
    opt32 = dataclasses.replace(opt, accum_dtype="float32")
    _, m_f32 = tsteps.make_train_step(cfg, opt32, microbatch=2)(
        make_train_state(params, opt32), batch)
    assert torch.equal(m_bf16["loss"], m_f32["loss"])
    # the bf16 buffers round each summed gradient to 8 bits
    assert_allclose_dtype(m_bf16["grad_norm"], m_f32["grad_norm"], "bf16")
    assert not torch.equal(m_bf16["grad_norm"], m_f32["grad_norm"])


def test_eval_step_matches_lm_loss():
    cfg, jcfg, params, model = _models("granite")
    batch = TokenPipeline(cfg, ShapeSpec("t", 16, 2, "train"),
                          seed=0).batch_at(0)
    got = tsteps.make_eval_step(cfg)(
        {k: p.detach() for k, p in model.named_parameters()}, batch)
    want = jsteps.make_eval_step(jcfg)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert_allclose_dtype(got["ce"], np.asarray(want["ce"]))


def _trainer(tmp, steps, every):
    cfg = train_lm.make_config("gemma2-9b", "smoke")
    return train_lm.make_trainer(cfg, steps=steps, batch=2, seq=24,
                                 ckpt_dir=str(tmp), device="cpu",
                                 log_every=1, checkpoint_every=every)


def test_trainer_resume_is_bit_for_bit(tmp_path):
    """Six steps in one run against three, then a fresh Trainer resuming
    from the step-2 checkpoint for the other three: the same parameters
    and moments bit for bit, the same losses."""
    straight = _trainer(tmp_path / "a", 6, 100).run()
    first = _trainer(tmp_path / "b", 3, 100).run()
    resumed = _trainer(tmp_path / "b", 6, 100).run()
    assert [h["step"] for h in resumed["history"]] == [3, 4, 5]
    losses = [h["loss"] for h in first["history"] + resumed["history"]]
    assert losses == [h["loss"] for h in straight["history"]]
    a, b = straight["state"], resumed["state"]
    assert int(a.step) == int(b.step) == 6
    for tree in ("params", "m", "v"):
        for k, t in getattr(a, tree).items():
            assert torch.equal(t, getattr(b, tree)[k]), (tree, k)


def test_train_lm_launcher_smoke_on_cpu(tmp_path, capsys):
    result = train_lm.main(["--arch", "gemma2-9b", "--preset", "smoke",
                            "--device", "cpu", "--ckpt-dir",
                            str(tmp_path)])
    hist = result["history"]
    assert [h["step"] for h in hist] == [0, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "arch=gemma2-9b-smoke" in capsys.readouterr().out


def test_train_lm_launcher_refuses_unported_archs():
    with pytest.raises(NotImplementedError, match="not ported"):
        train_lm.make_config("kimi-k2-1t-a32b")
    assert train_lm.make_config("gemma2-9b", width="full",
                                layers=2).d_model == 3584


@pytest.mark.parametrize("name", ["gemma2-9b", "granite-3-8b"])
def test_param_count_matches_reference(name):
    assert get_config(name).param_count() == jget_config(name).param_count()


def test_launcher_model_and_optimizer_defaults_match_reference():
    """The example's granite-100m counts as the reference counts it, and
    ``OptimizerConfig.accum_dtype`` has the reference's default."""
    from repro.config import AttentionConfig as JAttention
    from repro.config import LMConfig as JLMConfig
    m = train_lm.model_100m()
    ref = JLMConfig(name=m.name, family="dense", num_layers=12, d_model=640,
                    d_ff=1792, vocab_size=32768,
                    attention=JAttention(num_heads=10, num_kv_heads=2,
                                         head_dim=64),
                    mlp_activation="swiglu", tie_embeddings=True,
                    dtype="float32")
    assert m.param_count() == ref.param_count()
    assert OptimizerConfig().accum_dtype == JOptimizerConfig().accum_dtype


def test_trainer_without_checkpoints_writes_none(tmp_path):
    """``checkpoint_every`` 0: the run writes no checkpoint, not even its
    last step's (a run that only measures steps)."""
    result = _trainer(tmp_path, 2, 0).run()
    assert int(result["state"].step) == 2
    assert not any(tmp_path.iterdir())


def test_trainer_without_checkpoints_raises_failures(tmp_path):
    """``checkpoint_every`` 0 leaves nothing to restore from: a failure
    mid-run reaches the caller, not a silent restart from step 0."""
    trainer = _trainer(tmp_path, 3, 0)
    trainer.failure_injector = FailureInjector(fail_at=[1])
    with pytest.raises(RuntimeError, match="injected node failure at "
                                           "step 1"):
        trainer.run()
    assert trainer.recoveries == 0
    assert [h["step"] for h in trainer.metrics_history] == [0]


@pytest.mark.parametrize("vocab", [7, 2 * layers.UNEMBED_CHUNK + 5])
def test_unembed_grads_match_reference_vjp(vocab):
    """The bf16 head's backward, a slice of ``UNEMBED_CHUNK`` vocab rows at
    a time, against ``jax.vjp`` of the reference's f32-accumulated
    ``unembed``: dx and the table's gradient in bf16, within its band."""
    rng = np.random.default_rng(vocab)
    jt = jnp.asarray(rng.standard_normal((vocab, 64)), jnp.bfloat16)
    jx = jnp.asarray(rng.standard_normal((6, 64)), jnp.bfloat16)
    g = rng.standard_normal((6, vocab)).astype(np.float32)
    _, vjp = jax.vjp(lambda t, x: jlayers.unembed({"table": t}, x), jt, jx)
    want_t, want_x = vjp(jnp.asarray(g))
    tt, tx = (torch.from_numpy(np.array(a.astype(jnp.float32)))
              .to(torch.bfloat16) for a in (jt, jx))
    dx, dt = layers.unembed_grads(torch.from_numpy(g), tx, tt)
    assert dx.dtype == dt.dtype == torch.bfloat16
    assert_allclose_dtype(dx.float(), np.asarray(want_x, np.float32), "bf16")
    assert_allclose_dtype(dt.float(), np.asarray(want_t, np.float32), "bf16")
    only_x = layers.unembed_grads(torch.from_numpy(g), tx, tt,
                                  need_table=False)
    assert only_x[1] is None and torch.equal(only_x[0], dx)
