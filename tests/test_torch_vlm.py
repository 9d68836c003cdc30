"""The port's VLM path (internvl2-1b) against the JAX package.

Reduced internvl2-1b (2 layers, d 64, 4 query heads over 2 KV heads, tied
embeddings) with the reference's ``init_lm`` weights loaded through
``params_from_reference``; the same numpy patch embeddings (the frontend
stub's ``NUM_PATCH_TOKENS`` positions) and tokens go through
``repro.models.vlm`` and ``repro_torch.models.vlm``.  Held in the f32
band: ``vlm_forward``'s logits, ``vlm_loss`` with every parameter's
gradient and the patch embeddings' (against ``jax.grad``),
``vlm_prefill``'s last logits, length and caches and greedy decode steps
after it, and the launch steps with an ``embeds`` batch; the same in the
configs' own bf16 in the bf16 band.  The reference's Pallas K5 (interpret
mode) against the port's cuda tier with K5's plain version standing in
for the kernel.  Then the launcher: ``train_lm`` on the reduced config
with its patch embeddings from ``TokenPipeline``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.configs import internvl2_1b as jinternvl
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.models import vlm as jvlm
from repro.optim import optimizer as jopt
from repro_torch.config import OptimizerConfig, ShapeSpec
from repro_torch.configs import internvl2_1b
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train_lm
from repro_torch.models import transformer as ttr
from repro_torch.models import vlm
from repro_torch.optim.optimizer import make_train_state

torch.set_num_threads(2)

P = internvl2_1b.NUM_PATCH_TOKENS
#: each gradient leaf against the reference's, over that leaf's largest
#: magnitude (tests/test_torch_lm_train.py's limit)
LEAF_LIMIT = 1e-4


def _cfgs(dtype="float32"):
    return (dataclasses.replace(internvl2_1b.reduced(), dtype=dtype),
            dataclasses.replace(jinternvl.reduced(), dtype=dtype))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(cfg, reference cfg, reference params, port model on the CPU) in
    f32 and in the config's own bf16."""
    cfg, jcfg = _cfgs(request.param)
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(tree)
    return cfg, jcfg, params, model


def _inputs(cfg, b, s, seed, n_patches=P):
    """numpy patch embeddings (the stub's N(0, 1) * 0.02) and tokens."""
    rng = np.random.default_rng(seed)
    embeds = (rng.standard_normal((b, n_patches, cfg.d_model)) * 0.02
              ).astype(np.float32)
    return embeds, rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, cfg, scale=1.0):
    """f32: the f32 band; bf16: the bf16 band of the f32 logits."""
    if cfg.dtype == "float32":
        assert_allclose_dtype(got, np.asarray(want), scale=scale)
    else:
        assert_allclose_dtype(got, np.asarray(want, np.float32),
                              dtype=jnp.bfloat16)


def _leaf_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_config_and_patch_count_match_reference():
    assert P == jinternvl.NUM_PATCH_TOKENS == 256
    cfg, jcfg = internvl2_1b.config(), jinternvl.config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.frontend_stub and cfg.family == "vlm"


def test_stub_patch_embeds_draws_from_the_generator():
    """(B, NUM_PATCH_TOKENS, d_model) f32 of std 0.02 by default, the same
    draw from the same seed, another from another."""
    cfg = internvl2_1b.reduced()
    a = vlm.stub_patch_embeds(torch.Generator().manual_seed(3), 2, cfg,
                              device="cpu")
    assert a.shape == (2, P, cfg.d_model) and a.dtype == torch.float32
    assert abs(a.std().item() - 0.02) < 2e-3 and abs(a.mean().item()) < 1e-3
    b = vlm.stub_patch_embeds(torch.Generator().manual_seed(3), 2, cfg,
                              device="cpu")
    c = vlm.stub_patch_embeds(torch.Generator().manual_seed(4), 2, cfg, 5,
                              device="cpu")
    assert torch.equal(a, b) and c.shape == (2, 5, cfg.d_model)


def test_vlm_forward_matches_reference(pair):
    """Logits over [patches ++ tokens]: (B, P + S, V), the patch
    positions' too."""
    cfg, jcfg, params, model = pair
    embeds, toks = _inputs(cfg, 2, 12, 1)
    want, _ = jvlm.vlm_forward(params, jcfg, jnp.asarray(embeds),
                               jnp.asarray(toks))
    with torch.no_grad():
        got = vlm.vlm_forward(model, torch.from_numpy(embeds),
                              torch.from_numpy(toks))
    assert got.shape == (2, P + 12, cfg.padded_vocab)
    assert got.dtype == torch.float32
    _close(got, want, cfg)


def test_vlm_forward_k5_path_matches_reference_pallas(monkeypatch):
    """The reference's attention through its Pallas K5 (interpret mode)
    against the port's cuda tier on CPU tensors with the tier's device
    check lifted and K5's plain version standing in for the kernel: one
    causal call a layer over all P + S positions, GQA 2; the logits in the
    f32 band."""
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.kernels import ops
    cfg, jcfg = _cfgs()
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(1))
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(
        jax.tree.map(np.asarray, params))
    embeds, toks = _inputs(cfg, 1, 9, 2, n_patches=40)
    want, _ = jvlm.vlm_forward(params, jcfg, jnp.asarray(embeds),
                               jnp.asarray(toks), attn_impl="pallas")
    calls, plain = [], k5.flash_attention_plain

    def spy(q, k, v, kv_len=None, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return plain(q, k, v, kv_len, **kw)
    monkeypatch.setattr(ops, "_check_tier", lambda backend, t: None)
    monkeypatch.setattr(k5, "flash_attention", spy)
    with torch.no_grad():
        got = vlm.vlm_forward(model, torch.from_numpy(embeds),
                              torch.from_numpy(toks), attn_impl="cuda")
    a = cfg.attention
    assert calls == [((1, a.num_heads, 49, a.head_dim),
                      (1, a.num_kv_heads, 49, a.head_dim), True)] * \
        cfg.num_layers
    assert_allclose_dtype(got, np.asarray(want))


def test_vlm_loss_and_gradients_match_reference():
    """``vlm_loss`` (labels over the tokens only, -100 masked; ``ce_chunk``
    16 divides the 2 x 24 text positions) and the gradient of every
    parameter and of the patch embeddings against ``jax.value_and_grad``."""
    cfg, jcfg = _cfgs()
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(2))
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(
        jax.tree.map(np.asarray, params))
    embeds, toks = _inputs(cfg, 2, 24, 3)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    labels[0, 5] = -100
    (jloss, jm), (jgrad, jgemb) = jax.value_and_grad(
        lambda p, e: jvlm.vlm_loss(p, jcfg, e, jnp.asarray(toks),
                                   jnp.asarray(labels), ce_chunk=16),
        argnums=(0, 1), has_aux=True)(params, jnp.asarray(embeds))
    temb = torch.from_numpy(embeds).requires_grad_(True)
    loss, metrics = vlm.vlm_loss(model, temb, torch.from_numpy(toks),
                                 torch.from_numpy(labels), ce_chunk=16)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(
        loss, [p for _, p in model.named_parameters()] + [temb])
    assert_allclose_dtype(loss.detach(), np.asarray(jloss))
    assert_allclose_dtype(metrics["ce"].detach(), np.asarray(jm["ce"]))
    want = ttr.flatten_reference(jax.tree.map(np.asarray, jgrad), cfg)
    assert sorted(want) == sorted(names)
    errs = {n: _leaf_err(g.numpy(), want[n]) for n, g in zip(names, grads)}
    errs["embeds"] = _leaf_err(grads[-1].numpy(), np.asarray(jgemb))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_LIMIT, (worst, errs[worst])
    assert float(np.abs(np.asarray(jgemb)).max()) > 0


def test_vlm_prefill_and_decode_match_reference(pair):
    """``vlm_prefill`` into a cache of P + S + 8 rows: the last logits, the
    length (patches + tokens) and every layer's caches; then 4 greedy
    decode steps, each step's logits."""
    cfg, jcfg, params, model = pair
    embeds, toks = _inputs(cfg, 2, 10, 4)
    size = P + 10 + 8
    jlg, jcaches, jlen = jvlm.vlm_prefill(params, jcfg, jnp.asarray(embeds),
                                          jnp.asarray(toks), size)
    with torch.no_grad():
        lg, caches, length = vlm.vlm_prefill(
            model, torch.from_numpy(embeds), torch.from_numpy(toks), size)
        _close(lg, jlg, cfg)
        assert int(length) == int(jlen) == P + 10
        want = ttr.flatten_reference(
            {"blocks": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    jcaches)}, cfg)
        for n, (k, v) in enumerate(caches):
            assert k.shape == (2, cfg.attention.num_kv_heads, size,
                               cfg.attention.head_dim)
            _close(k.float(), want[f"layers.{n}.k"], cfg)
            _close(v.float(), want[f"layers.{n}.v"], cfg)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        for _ in range(4):
            jlg, jcaches, jlen = jtr.lm_decode_step(
                params, jcfg, jnp.asarray(tok.numpy()), jcaches, jlen)
            lg, caches, length = ttr.lm_decode_step(model, tok, caches,
                                                    length)
            _close(lg, jlg, cfg)
            tok = lg[:, -1].argmax(-1, keepdim=True)
        assert int(length) == int(jlen) == P + 14


def test_vlm_decode_matches_full_forward():
    """The port against itself in f32: a prefill of the patches and all but
    the last token, then a decode step of the last, against
    ``vlm_forward``'s last two positions (chip_smoke.py phase 22 holds
    the card's decode so)."""
    cfg, _ = _cfgs()
    model = ttr.TransformerLM(cfg, device="cpu")
    embeds, toks = _inputs(cfg, 2, 16, 5)
    e, t = torch.from_numpy(embeds), torch.from_numpy(toks)
    with torch.no_grad():
        full = vlm.vlm_forward(model, e, t)
        lg, caches, length = vlm.vlm_prefill(model, e, t[:, :-1], P + 20)
        assert_allclose_dtype(lg[:, 0], full[:, -2], scale=10)
        lg2, _, length = ttr.lm_decode_step(model, t[:, -1:], caches, length)
        assert_allclose_dtype(lg2[:, 0], full[:, -1], scale=10)
        assert int(length) == P + 16


def test_vlm_prefill_refuses_a_short_cache():
    cfg, _ = _cfgs()
    model = ttr.TransformerLM(cfg, device="cpu")
    embeds, toks = _inputs(cfg, 1, 4, 6)
    with pytest.raises(ValueError, match="cache_size"):
        vlm.vlm_prefill(model, torch.from_numpy(embeds),
                        torch.from_numpy(toks), P + 3)


def _opts():
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.0,
              eps=1e-6)
    return OptimizerConfig(**kw), JOptimizerConfig(**kw)


def test_launch_steps_with_embeds_match_reference():
    """``make_prefill_step`` (its default cache: patches + tokens) and
    ``make_decode_step`` over an ``embeds`` batch; ``make_eval_step`` and
    two ``make_train_step`` AdamW steps over TokenPipeline batches with
    ``frontend_tokens``, each parameter within 1e-4 of its largest
    magnitude (a norm's scale as the 1 + scale it applies)."""
    cfg, jcfg = _cfgs()
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(3))
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(
        jax.tree.map(np.asarray, params))
    embeds, toks = _inputs(cfg, 2, 8, 7)
    batch = {"embeds": embeds, "tokens": toks}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlg, jcaches, jlen = jsteps.make_prefill_step(jcfg)(params, jb)
    with torch.no_grad():
        lg, caches, length = tsteps.make_prefill_step(cfg)(model, batch)
        assert_allclose_dtype(lg, np.asarray(jlg))
        assert int(length) == int(jlen) == P + 8
        assert caches[0][0].shape[2] == P + 8
    # a decode step needs a row free: prefill into a larger cache
    jlg, jcaches, jlen = jsteps.make_prefill_step(jcfg, P + 10)(params, jb)
    with torch.no_grad():
        lg, caches, length = tsteps.make_prefill_step(cfg, P + 10)(model,
                                                                  batch)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        jlg, _, jlen = jsteps.make_decode_step(jcfg)(params, {
            "token": jnp.asarray(tok.numpy()), "caches": jcaches,
            "length": jlen})
        lg, _, length = tsteps.make_decode_step(cfg)(model, {
            "token": tok, "caches": caches, "length": length})
        assert_allclose_dtype(lg, np.asarray(jlg))
        assert int(length) == int(jlen) == P + 9

    pipe = TokenPipeline(cfg, ShapeSpec("t", P + 16, 2, "train"), seed=0,
                         frontend_tokens=P)
    tb = pipe.batch_at(0)
    assert tb["embeds"].shape == (2, P, cfg.d_model)
    assert tb["tokens"].shape == tb["labels"].shape == (2, 16)
    tparams = {k: p.detach() for k, p in model.named_parameters()}
    got = tsteps.make_eval_step(cfg)(tparams, tb)
    want = jsteps.make_eval_step(jcfg)(
        params, {k: jnp.asarray(v) for k, v in tb.items()})
    assert_allclose_dtype(got["ce"], np.asarray(want["ce"]))

    opt, jopt_cfg = _opts()
    state = make_train_state(tparams, opt)
    jstate = jopt.make_train_state(params, jopt_cfg)
    step = tsteps.make_train_step(cfg, opt)
    jstep = jsteps.make_train_step(jcfg, jopt_cfg)
    for i in range(2):
        b = pipe.batch_at(i)
        state, metrics = step(state, b)
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in b.items()})
        for key in ("loss", "ce", "grad_norm"):
            assert_allclose_dtype(metrics[key], np.asarray(jmetrics[key]),
                                  scale=10, err_msg=key)
    want = ttr.flatten_reference(jax.tree.map(np.asarray, jstate.params),
                                 cfg)
    scales = {n for n in want if n.endswith(".scale")}
    errs = {n: _leaf_err(p.numpy() + (n in scales), want[n] + (n in scales))
            for n, p in state.params.items()}
    assert max(errs.values()) <= LEAF_LIMIT, max(errs, key=errs.get)


def test_train_lm_reduced_internvl_on_cpu(tmp_path, capsys):
    """``train_lm`` on the reduced internvl2-1b: its pipeline prepends
    NUM_PATCH_TOKENS patch embeddings a row, which ``--seq`` counts."""
    cfg = train_lm.make_config("internvl2-1b", "smoke")
    assert train_lm.frontend_tokens(cfg) == P
    tr = train_lm.make_trainer(cfg, steps=2, batch=2, seq=P + 24,
                               ckpt_dir=str(tmp_path / "a"), device="cpu")
    b = tr.pipeline.batch_at(0)
    assert b["embeds"].shape == (2, P, cfg.d_model)
    assert b["tokens"].shape == (2, 24)
    result = train_lm.main(["--arch", "internvl2-1b", "--preset", "smoke",
                            "--device", "cpu", "--ckpt-dir",
                            str(tmp_path / "b")])
    hist = result["history"]
    assert [h["step"] for h in hist] == [0, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "arch=internvl2-1b-smoke" in out and f"2x{P + 32}" in out
