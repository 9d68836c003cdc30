"""The port's enc-dec path (seamless-m4t-medium) on the CPU against the
JAX package.

At the reduced config (2 + 2 layers, d 64, 4 heads of 16, vocab 256) in
f32, with the reference's ``init_encdec`` weights loaded through
``EncDecLM.params_from_reference``, the same numpy-seeded frames and
tokens go through the reference and the port's ``torch`` tier:
``sinusoidal_positions``, ``chunked_attention`` (causal, window, softcap,
Sq < Sk; its assert on chunks that do not divide), ``cross_attention_block``
on both sides of the 2048-token switch, ``encode``, ``decode_stack``,
``encdec_prefill`` with three ``encdec_decode_step``s, the reference's
decode consistency (``tests/test_serving.py``), ``encdec_loss`` and every
gradient leaf against ``jax.value_and_grad``, ``make_train_step`` updates,
``make_eval_step``, ``make_prefill_step`` / ``make_decode_step`` for both
families, ``init_encdec``'s leaves, ``param_count`` and the pipeline's
``frames``, all in the f32 band (gradients and parameters per leaf over
the leaf's largest magnitude, as ``tests/test_torch_lm_train.py``).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import ShapeSpec as JShapeSpec
from repro.config import get_config as jget_config
from repro.configs import granite_3_8b as jgranite
from repro.configs import seamless_m4t_medium as jseamless
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.optim import optimizer as jopt
from repro_torch.config import OptimizerConfig, ShapeSpec, get_config
from repro_torch.configs import granite_3_8b, seamless_m4t_medium
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train_lm
from repro_torch.models import encdec
from repro_torch.models import transformer as ttr
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers
from repro_torch.optim.optimizer import make_train_state

torch.set_num_threads(2)

#: each gradient or parameter leaf against the reference's, over that
#: leaf's largest magnitude (tests/test_torch_lm_train.py LEAF_LIMIT)
LEAF_LIMIT = 1e-4
#: the reference's decode consistency band (tests/test_serving.py: rtol
#: and atol 1e-3), as 100x the f32 unit band
DECODE_SCALE = 100


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(vocab=None):
    cfg = dataclasses.replace(seamless_m4t_medium.reduced(), dtype="float32")
    jcfg = dataclasses.replace(jseamless.reduced(), dtype="float32")
    if vocab is not None:   # a vocab below the 256-row padding
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
    return cfg, jcfg


def _models(vocab=None, seed=0):
    cfg, jcfg = _cfgs(vocab)
    params = jencdec.init_encdec(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = encdec.EncDecLM(cfg, device="cpu").params_from_reference(tree)
    return cfg, jcfg, params, model


def _inputs(cfg, b=2, s_enc=24, s=12, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -100, np.int32)],
                            axis=1)
    labels[0, 2] = -100
    return frames, toks, labels


def _leaf_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# Layers and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,d", [(16, 64), (40, 16), (3, 1024)])
def test_sinusoidal_positions_match_reference(seq, d):
    got = layers.sinusoidal_positions(seq, d, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    assert_allclose_dtype(got, np.asarray(jlayers.sinusoidal_positions(seq,
                                                                       d)))


def test_sinusoidal_positions_default_to_the_card(monkeypatch):
    """The entry point's default device is the card: with none visible it
    raises rather than build the table on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        layers.sinusoidal_positions(8, 16)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,qc,kc", [
    (2, 4, 2, 32, 32, 16, True, 0, 0.0, 8, 16),     # causal
    (1, 4, 4, 48, 48, 16, True, 12, 0.0, 16, 8),    # window
    (1, 4, 2, 32, 32, 32, True, 0, 50.0, 16, 16),   # softcap
    (2, 2, 1, 16, 64, 16, True, 0, 0.0, 8, 16),     # Sq < Sk, right-aligned
    (1, 4, 4, 24, 40, 16, False, 0, 0.0, 8, 8),     # non-causal Sq < Sk
    (1, 2, 2, 20, 20, 16, True, 0, 0.0, 2048, 1024),  # chunks cut to S
])
def test_chunked_attention_matches_reference(b, hq, hkv, sq, sk, d, causal,
                                             window, cap, qc, kc):
    rng = np.random.default_rng(sq * d + sk)
    q, k, v = (rng.standard_normal(shp).astype(np.float32) for shp in
               ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kw = dict(causal=causal, window=window, cap=cap, q_chunk=qc,
              kv_chunk=kc)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), **kw)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    assert got.shape == (b, hq, sq, d)
    assert_allclose_dtype(got, np.asarray(want))
    # the same function as the port's direct attention
    assert_allclose_dtype(got, tattn.direct_attention(
        _t(q), _t(k), _t(v), causal=causal, window=window, cap=cap))


def test_chunked_attention_asserts_dividing_chunks():
    """Chunks that do not divide the sequences fail the reference's assert
    on both sides: no ragged last chunk."""
    q = np.zeros((1, 2, 24, 16), np.float32)
    k = np.zeros((1, 2, 40, 16), np.float32)
    for kw in (dict(q_chunk=16), dict(kv_chunk=16)):
        with pytest.raises(AssertionError):
            tattn.chunked_attention(_t(q), _t(k), _t(k), **kw)
        with pytest.raises(AssertionError):
            jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(k), **kw)


def _cross_params(rng, d_model, a):
    ws = {n: (rng.standard_normal(shp) * shp[0] ** -0.5).astype(np.float32)
          for n, shp in (("wq", (d_model, a.q_dim)), ("wk", (d_model,
                                                             a.kv_dim)),
                         ("wv", (d_model, a.kv_dim)),
                         ("wo", (a.q_dim, d_model)))}
    return (SimpleNamespace(**{n: _t(w) for n, w in ws.items()}),
            {n: {"w": jnp.asarray(w)} for n, w in ws.items()})


@pytest.mark.parametrize("s,sm,path", [
    (5, 9, "direct_attention"),
    (3, 2056, "flash_attention_xla"),   # past the 2048 switch
])
def test_cross_attention_block_matches_reference(s, sm, path, monkeypatch):
    """Both sides of the reference's switch (``s <= 2048 and sm <= 2048``):
    the torch tier takes the reference's path and matches its output."""
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(s + sm)
    p, jp = _cross_params(rng, cfg.d_model, cfg.attention)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, sm, cfg.d_model)).astype(np.float32)
    calls = []
    fn = getattr(tattn, path)
    monkeypatch.setattr(tattn, path,
                        lambda *a, **kw: calls.append(kw) or fn(*a, **kw))
    got = tattn.cross_attention_block(p, _t(x), _t(mem), cfg.attention)
    want = jattn.cross_attention_block(jp, jnp.asarray(x), jnp.asarray(mem),
                                       jcfg.attention)
    assert len(calls) == 1 and calls[0]["causal"] is False
    assert got.shape == (2, s, cfg.d_model)
    assert_allclose_dtype(got, np.asarray(want))
    assert_allclose_dtype(got, tattn.cross_attention_block(
        p, _t(x), _t(mem), cfg.attention, impl="direct"))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def test_encode_and_decode_stack_match_reference():
    cfg, jcfg, params, model = _models()
    frames, toks, _ = _inputs(cfg)
    with torch.no_grad():
        memory = encdec.encode(model, _t(frames))
        logits, caches = encdec.decode_stack(model, _t(toks), memory)
    jmem = jencdec.encode(params, jcfg, jnp.asarray(frames))
    jlogits, _ = jencdec.decode_stack(params, jcfg, jnp.asarray(toks), jmem)
    assert caches is None and logits.dtype == torch.float32
    assert_allclose_dtype(memory, np.asarray(jmem))
    assert logits.shape == (2, toks.shape[1], cfg.padded_vocab)
    assert_allclose_dtype(logits, np.asarray(jlogits))


@pytest.mark.parametrize("vocab", [None, 250])
def test_prefill_and_decode_steps_match_reference(vocab):
    """``encdec_prefill`` then three ``encdec_decode_step``s against the
    reference's on the same tokens: logits, the caches' rows, memory and
    lengths.  Vocab 250 pads to 256 rows, masked with -1e30."""
    cfg, jcfg, params, model = _models(vocab)
    frames, toks, _ = _inputs(cfg, s=11, seed=1)
    cache = 16
    with torch.no_grad():
        lg, caches, memory, length = encdec.encdec_prefill(
            model, _t(frames), _t(toks[:, :8]), cache)
        jlg, jcaches, jmem, jlength = jencdec.encdec_prefill(
            params, jcfg, jnp.asarray(frames), jnp.asarray(toks[:, :8]),
            cache_size=cache)
        assert lg.shape == (2, 1, cfg.padded_vocab)
        assert_allclose_dtype(lg, np.asarray(jlg))
        assert_allclose_dtype(memory, np.asarray(jmem))
        assert int(length) == int(jlength) == 8
        for t in range(8, 11):
            lg, caches, length = encdec.encdec_decode_step(
                model, _t(toks[:, t:t + 1]), caches, memory, length)
            jlg, jcaches, jlength = jencdec.encdec_decode_step(
                params, jcfg, jnp.asarray(toks[:, t:t + 1]), jcaches, jmem,
                jlength)
            assert int(length) == int(jlength) == t + 1
            assert_allclose_dtype(lg, np.asarray(jlg))
    assert len(caches) == cfg.num_layers
    for n, (k, v) in enumerate(caches):
        assert k.shape == (2, cfg.attention.num_kv_heads, cache,
                           cfg.attention.head_dim)
        assert_allclose_dtype(k, np.asarray(jcaches["k"][n]))
        assert_allclose_dtype(v, np.asarray(jcaches["v"][n]))
    if vocab is not None:
        assert (lg[..., vocab:] <= -1e29).all()


def test_decode_matches_full_decode_stack():
    """The reference's ``test_encdec_decode_consistency`` on the port: the
    decode step's logits at the last token against a full
    ``decode_stack`` over the prompt and that token (its band: rtol and
    atol 1e-3), and ``init_dec_caches``' zeroed caches, written in place by
    a decode step from length 0, giving the first token's logits."""
    cfg, _, _, model = _models()
    frames, toks, _ = _inputs(cfg, s_enc=16, s=12, seed=2)
    with torch.no_grad():
        memory = encdec.encode(model, _t(frames))
        full, _ = encdec.decode_stack(model, _t(toks), memory)
        _, caches, mem, length = encdec.encdec_prefill(
            model, _t(frames), _t(toks[:, :11]), cache_size=16)
        lg2, _, _ = encdec.encdec_decode_step(model, _t(toks[:, 11:12]),
                                              caches, mem, length)
        assert_allclose_dtype(lg2[:, 0], full[:, -1], scale=DECODE_SCALE)
        zero = encdec.init_dec_caches(cfg, 2, 16, device="cpu")
        assert all(not k.any() and not v.any() for k, v in zero)
        lg0, _, n = encdec.encdec_decode_step(
            model, _t(toks[:, :1]), zero, memory,
            torch.tensor(0, dtype=torch.int32))
    assert int(n) == 1 and zero[0][0][:, :, 0].any()
    assert_allclose_dtype(lg0[:, 0], full[:, 0], scale=DECODE_SCALE)


def test_init_encdec_leaves_match_reference():
    """Names and shapes equal the reference's ``init_encdec`` leaves; each
    leaf's std matches (same scale per leaf, other random streams)."""
    cfg, jcfg = _cfgs()
    cfg = dataclasses.replace(cfg, d_model=128, d_ff=256)
    jcfg = dataclasses.replace(jcfg, d_model=128, d_ff=256)
    want = encdec.flatten_reference(jax.tree.map(
        np.asarray, jencdec.init_encdec(jcfg, jax.random.PRNGKey(1))), cfg)
    model = encdec.init_encdec(cfg, generator=torch.Generator().manual_seed(1),
                               device="cpu")
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    assert "dec.1.cross_attn.wk" in got and "enc.0.attn.wo" in got
    for n, a in got.items():
        assert a.shape == want[n].shape and a.dtype == np.float32, n
        if n.endswith("scale"):      # norm scales start at 0
            assert not a.any() and not want[n].any(), n
        else:
            ratio = a.std() / want[n].std()
            assert abs(ratio - 1) < 0.05, (n, ratio)


def test_encdec_refuses_decoder_only_configs():
    with pytest.raises(NotImplementedError, match="encoder"):
        encdec.EncDecLM(dataclasses.replace(_cfgs()[0], encoder_layers=0),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="EncDecLM"):
        ttr.TransformerLM(_cfgs()[0], device="cpu")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ce_chunk,vocab", [(8, None), (10, 250)])
def test_encdec_loss_and_gradients_match_reference(ce_chunk, vocab):
    """``encdec_loss`` and the gradient of every parameter against
    ``jax.value_and_grad`` of the reference's: ``ce_chunk`` 8 divides the
    24 tokens, 10 does not (one unchunked chunk); vocab 250 pads to 256
    rows; labels -100 masked; frames take their gradient through the
    encoder's checkpointed layers."""
    cfg, jcfg, params, model = _models(vocab)
    frames, toks, labels = _inputs(cfg)
    (jloss, jm), jgrad = jax.value_and_grad(
        lambda p: jencdec.encdec_loss(p, jcfg, jnp.asarray(frames),
                                      jnp.asarray(toks), jnp.asarray(labels),
                                      ce_chunk=ce_chunk),
        has_aux=True)(params)
    loss, metrics = encdec.encdec_loss(model, _t(frames), _t(toks),
                                       _t(labels), ce_chunk=ce_chunk)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    assert_allclose_dtype(loss.detach(), np.asarray(jloss))
    assert_allclose_dtype(metrics["ce"].detach(), np.asarray(jm["ce"]))
    want = encdec.flatten_reference(jax.tree.map(np.asarray, jgrad), cfg)
    assert sorted(want) == sorted(names)
    errs = {n: _leaf_err(g.numpy(), want[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_LIMIT, (worst, errs[worst])


def test_encdec_loss_through_functional_call_matches_the_module():
    """``params=`` on a ``meta`` skeleton: the module's loss, and its
    gradients through the checkpointed layers' recomputation, bit for
    bit."""
    cfg, _, _, model = _models()
    frames, toks, labels = _inputs(cfg, seed=3)
    skel = encdec.EncDecLM(cfg, device="meta")
    leaves = {k: p.detach().requires_grad_(True)
              for k, p in model.named_parameters()}
    a, _ = encdec.encdec_loss(model, _t(frames), _t(toks), _t(labels))
    b, _ = encdec.encdec_loss(skel, _t(frames), _t(toks), _t(labels),
                              params=leaves)
    assert torch.equal(a, b)
    ga = torch.autograd.grad(a, list(model.parameters()))
    gb = torch.autograd.grad(b, list(leaves.values()))
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def _opt():
    # eps above the gradients' f32 noise (tests/test_torch_lm_train.py)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, weight_decay=0.1,
              eps=1e-6)
    return OptimizerConfig(**kw), JOptimizerConfig(**kw)


@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_steps_match_reference(microbatch):
    """Two AdamW steps of ``make_train_step`` on TokenPipeline batches
    (frames included) from the reference's weights against the
    reference's step: each parameter leaf within 1e-4 of its largest
    magnitude, a norm's scales as the 1 + scale it applies (the reference
    decays its stacked (L, d) scales, the port's 1-D ones it does not:
    ROADMAP "Reference caveats"), the metrics in the f32 band."""
    cfg, jcfg, params, model = _models()
    opt, jopt_cfg = _opt()
    pipe = TokenPipeline(cfg, ShapeSpec("t", 16, 4, "train"), seed=0)
    state = make_train_state(
        {k: p.detach() for k, p in model.named_parameters()}, opt)
    jstate = jopt.make_train_state(params, jopt_cfg)
    step = tsteps.make_train_step(cfg, opt, microbatch=microbatch)
    jstep = jsteps.make_train_step(jcfg, jopt_cfg, microbatch=microbatch)
    for i in range(2):
        batch = pipe.batch_at(i)
        assert batch["frames"].shape == (4, 16, cfg.d_model)
        state, metrics = step(state, batch)
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert_allclose_dtype(metrics[key], np.asarray(jmetrics[key]),
                                  scale=10, err_msg=key)
    assert int(state.step) == 2
    want = encdec.flatten_reference(jax.tree.map(np.asarray, jstate.params),
                                    cfg)
    scales = {n for n in want if n.endswith(".scale")}
    errs = {n: _leaf_err(p.numpy() + (n in scales), want[n] + (n in scales))
            for n, p in state.params.items()}
    assert all(e <= LEAF_LIMIT for e in errs.values()), \
        {n: e for n, e in errs.items() if e > LEAF_LIMIT}


@pytest.mark.parametrize("remat", ["full", "selective"])
def test_train_step_refuses_remat_for_the_audio_family(remat):
    """encdec_loss always rematerializes every layer: an option it would
    drop raises instead."""
    with pytest.raises(ValueError, match="remat"):
        tsteps.make_train_step(_cfgs()[0], OptimizerConfig(), remat=remat)


def test_eval_step_matches_reference():
    cfg, jcfg, params, model = _models()
    batch = TokenPipeline(cfg, ShapeSpec("t", 12, 2, "train"),
                          seed=1).batch_at(0)
    got = tsteps.make_eval_step(cfg)(
        {k: p.detach() for k, p in model.named_parameters()}, batch)
    want = jsteps.make_eval_step(jcfg)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert sorted(got) == ["ce"]
    assert_allclose_dtype(got["ce"], np.asarray(want["ce"]))


def test_prefill_and_decode_step_makers_match_reference():
    """``make_prefill_step`` / ``make_decode_step`` of the audio family
    against the reference's (numpy batches moved to the model's device),
    and of a dense model against ``lm_prefill`` / ``lm_decode_step``."""
    cfg, jcfg, params, model = _models()
    frames, toks, _ = _inputs(cfg, s=9, seed=4)
    batch = {"frames": frames, "tokens": toks[:, :8]}
    with torch.no_grad():
        lg, caches, memory, length = tsteps.make_prefill_step(cfg, 12)(
            model, batch)
        lg2, caches, length = tsteps.make_decode_step(cfg)(
            model, {"token": toks[:, 8:9], "caches": caches,
                    "memory": memory, "length": length})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlg, jcaches, jmem, jlength = jsteps.make_prefill_step(jcfg, 12)(
        params, jb)
    jlg2, _, _ = jsteps.make_decode_step(jcfg)(
        params, {"token": jnp.asarray(toks[:, 8:9]), "caches": jcaches,
                 "memory": jmem, "length": jlength})
    assert_allclose_dtype(lg, np.asarray(jlg))
    assert_allclose_dtype(lg2, np.asarray(jlg2))
    assert int(length) == 9

    dcfg = dataclasses.replace(granite_3_8b.reduced(), dtype="float32")
    dense = ttr.TransformerLM(dcfg, device="cpu")
    dt = np.random.default_rng(5).integers(0, dcfg.vocab_size, (2, 7))
    with torch.no_grad():
        a, ca, la = tsteps.make_prefill_step(dcfg, 10)(dense, {"tokens": dt})
        b, cb, lb = ttr.lm_prefill(dense, _t(dt), 10)
        assert torch.equal(a, b) and int(la) == int(lb) == 7
        a2, _, _ = tsteps.make_decode_step(dcfg)(
            dense, {"token": dt[:, :1], "caches": ca, "length": la})
        b2, _, _ = ttr.lm_decode_step(dense, _t(dt[:, :1]), cb, lb)
    assert torch.equal(a2, b2)
    assert jgranite.reduced().family == dcfg.family == "dense"


def test_train_lm_launcher_trains_seamless_on_cpu(tmp_path, capsys):
    """``--arch seamless-m4t-medium``: the enc-dec model from
    ``init_encdec``, its frames from the pipeline, finite losses."""
    result = train_lm.main(["--arch", "seamless-m4t-medium", "--preset",
                            "smoke", "--device", "cpu", "--ckpt-dir",
                            str(tmp_path)])
    hist = result["history"]
    assert [h["step"] for h in hist] == [0, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "arch=seamless-m4t-medium-smoke" in capsys.readouterr().out
    full = train_lm.make_config("seamless-m4t-medium", width="full")
    assert (full.d_model, full.encoder_layers) == (1024, 12)


# ---------------------------------------------------------------------------
# Config and data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["config", "reduced"])
def test_param_count_matches_reference(which):
    got = getattr(seamless_m4t_medium, which)()
    want = getattr(jseamless, which)()
    assert got.param_count() == want.param_count()
    if which == "config":
        assert get_config("seamless-m4t-medium") == got
        assert got.param_count() == jget_config(
            "seamless-m4t-medium").param_count()
        assert 6.1e8 < got.param_count() < 6.2e8
    assert seamless_m4t_medium.MAX_ENC_FRAMES == jseamless.MAX_ENC_FRAMES
    for s in (1, 4096, 32768):
        assert seamless_m4t_medium.enc_frames(s) == jseamless.enc_frames(s)


@pytest.mark.parametrize("seq,batch,step", [(16, 2, 0), (5000, 1, 3)])
def test_pipeline_frames_match_reference_bit_for_bit(seq, batch, step):
    """``TokenPipeline``'s audio batch: tokens, labels and frames (at most
    MAX_ENC_FRAMES of them) bit for bit the reference's draw."""
    cfg = seamless_m4t_medium.reduced()
    got = TokenPipeline(cfg, ShapeSpec("t", seq, batch, "train"),
                        seed=7).batch_at(step)
    want = JTokenPipeline(jseamless.reduced(),
                          JShapeSpec("t", seq, batch, "train"),
                          seed=7).batch_at(step)
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    assert got["frames"].shape == (batch, min(seq, 4096), cfg.d_model)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_cuda_tier_runs_k5_on_every_attention(monkeypatch):
    """The cuda tier's path on CPU tensors, with its device check lifted
    and K5's plain version standing in for the kernel: a prefill calls K5
    once per encoder layer (non-causal), per decoder self-attention
    (causal) and per cross-attention (non-causal, Sq = prompt); a decode
    step once per cross-attention (Sq = 1), its self-attention the plain
    decode; under a gradient the loss goes through K5's wrapper too.
    The logits match the torch tier's."""
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.kernels import ops
    cfg, _, _, model = _models()
    frames, toks, labels = _inputs(cfg, s=6, seed=6)
    calls = []
    plain = k5.flash_attention_plain

    def spy(q, k, v, kv_len=None, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return plain(q, k, v, kv_len, **kw)
    monkeypatch.setattr(ops, "_check_tier", lambda backend, t: None)
    monkeypatch.setattr(k5, "flash_attention", spy)
    with torch.no_grad():
        lg, caches, memory, length = encdec.encdec_prefill(
            model, _t(frames), _t(toks[:, :5]), 8, attn_impl="cuda")
        n = cfg.num_layers
        assert calls == [(24, 24, False)] * cfg.encoder_layers + \
            [(5, 5, True), (5, 24, False)] * n
        calls.clear()
        lg2, _, _ = encdec.encdec_decode_step(model, _t(toks[:, 5:6]),
                                              caches, memory, length,
                                              attn_impl="cuda")
        assert calls == [(1, 24, False)] * n
        want, _, _, _ = encdec.encdec_prefill(model, _t(frames),
                                              _t(toks[:, :5]), 8,
                                              attn_impl="torch")
    assert_allclose_dtype(lg, want)
    calls.clear()
    loss, _ = encdec.encdec_loss(model, _t(frames), _t(toks), _t(labels),
                                 attn_impl="cuda")
    torch.autograd.grad(loss, list(model.parameters()))
    # forward, then the checkpointed layers' recomputation
    fa = [causal for _, _, causal in calls]
    assert fa.count(False) == 2 * (cfg.encoder_layers + cfg.num_layers)
    assert fa.count(True) == 2 * cfg.num_layers
