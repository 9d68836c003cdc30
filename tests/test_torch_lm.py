"""The port's LM serving path against the JAX package, on the same weights.

Reduced f32 gemma2 (local/global alternation, sandwich norms, softcaps,
GeGLU) and granite (dense GQA, SwiGLU, padded vocab): the reference's
``init_lm`` weights load into ``TransformerLM`` through
``params_from_reference``; ``lm_forward``, ``lm_prefill`` and
``lm_decode_step`` must match the JAX ones within the f32 band, the port's
decode its own full forward, and the port's ``ServeEngine`` must emit the
JAX ``ServeEngine``'s greedy tokens.  The same three entry points also run
in the configs' native bf16 and must match the reference's bf16 logits
within the bf16 band; ``unembed`` must return the f32 accumulator of bf16
operands, as the reference does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import get_config as jget_config
from repro.config import list_archs as jlist_archs
from repro.config import override as joverride
from repro.configs import ASSIGNED_ARCHS
from repro.configs import arctic_480b as jarctic
from repro.configs import deepseek_67b as jdeepseek
from repro.configs import gemma2_9b as jgemma
from repro.configs import gemma_7b as jgemma7
from repro.configs import granite_3_8b as jgranite
from repro.configs import internvl2_1b as jinternvl
from repro.configs import kimi_k2 as jkimi
from repro.models import transformer as jtr
from repro.nn import layers as jlayers
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import get_config, list_archs, override
from repro_torch.configs import (arctic_480b, deepseek_67b, gemma2_9b,
                                 gemma_7b, granite_3_8b, internvl2_1b,
                                 kimi_k2)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as ttr
from repro_torch.nn import layers
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(2)

#: f32 band x 10 for whole-model logits: 2-4 layers of matmuls, norms and
#: softmaxes summed in other orders by XLA and PyTorch (measured: within
#: 0.25 of the unit band; the reference's decode-vs-forward test allows 1e-3)
LM_SCALE = 10
ARCHS = {"gemma2": (gemma2_9b, jgemma), "granite": (granite_3_8b, jgranite)}


def _fp32(mod):
    return dataclasses.replace(mod.reduced(), dtype="float32")


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    """(cfg, reference cfg, reference params, port model on the CPU)."""
    tmod, jmod = ARCHS[request.param]
    cfg, jcfg = _fp32(tmod), _fp32(jmod)
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(tree)
    return cfg, jcfg, params, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


CONFIG_MODULES = {"gemma2-9b": (gemma2_9b, jgemma),
                  "granite-3-8b": (granite_3_8b, jgranite),
                  "arctic-480b": (arctic_480b, jarctic),
                  "kimi-k2-1t-a32b": (kimi_k2, jkimi),
                  "internvl2-1b": (internvl2_1b, jinternvl),
                  "gemma-7b": (gemma_7b, jgemma7),
                  "deepseek-67b": (deepseek_67b, jdeepseek)}
#: the configs whose reduced weights load from the reference's and whose
#: logits match it: the dense and VLM ones added with the VLM frontend
DENSE_NEW = ("deepseek-67b", "gemma-7b", "internvl2-1b")


@pytest.mark.parametrize("name", sorted(CONFIG_MODULES))
def test_configs_match_reference(name):
    mod = CONFIG_MODULES[name]
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jget_config(name))
    assert dataclasses.asdict(mod[0].reduced()) == \
        dataclasses.asdict(mod[1].reduced())
    cfg = get_config(name)
    assert cfg.padded_vocab == jget_config(name).padded_vocab
    assert [cfg.layer_is_local(i) for i in range(cfg.num_layers)] == \
        [jget_config(name).layer_is_local(i) for i in range(cfg.num_layers)]
    assert [s.name for s in cfg.shapes()] == \
        [s.name for s in jget_config(name).shapes()]
    assert [dataclasses.asdict(s) for s in cfg.shapes()] == \
        [dataclasses.asdict(s) for s in jget_config(name).shapes()]


def test_list_archs_and_override_match_reference():
    """Every assigned arch is registered; ``override`` replaces fields
    through dotted keys as the reference's does."""
    assert set(ASSIGNED_ARCHS) <= set(list_archs())
    assert list_archs() == jlist_archs()
    kw = {"d_model": 128, "attention.num_heads": 8,
          "attention.head_dim": 32, "dtype": "float32"}
    got = override(get_config("internvl2-1b"), **kw)
    want = joverride(jget_config("internvl2-1b"), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.attention.num_kv_heads == 2 and got.attention.q_dim == 256
    with pytest.raises(TypeError):
        override(get_config("gemma-7b"), **{"attention.no_such_field": 1})


@pytest.mark.parametrize("name", DENSE_NEW)
def test_param_counts_match_reference(name):
    """``param_count`` of the published config and of its reduced one."""
    mod, jmod = CONFIG_MODULES[name]
    for cfg, jcfg in ((get_config(name), jget_config(name)),
                      (mod.reduced(), jmod.reduced())):
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == cfg.param_count()


@pytest.mark.parametrize("name", DENSE_NEW)
def test_new_configs_load_reference_weights(name):
    """``params_from_reference`` takes the reduced config's reference
    weights unchanged (untied deepseek's ``lm_head`` too); ``lm_forward``
    and a prefill then match the reference's in the f32 band."""
    mod, jmod = CONFIG_MODULES[name]
    cfg, jcfg = _fp32(mod), _fp32(jmod)
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(tree)
    flat = ttr.flatten_reference(tree, cfg)
    assert sorted(flat) == sorted(n for n, _ in model.named_parameters())
    assert ("lm_head.table" in flat) == (not cfg.tie_embeddings)
    toks = _tokens(cfg, (2, 20), 1)
    want, _ = jtr.lm_forward(params, jcfg, jnp.asarray(toks))
    jlg, _, _ = jtr.lm_prefill(params, jcfg, jnp.asarray(toks), 24)
    with torch.no_grad():
        assert_allclose_dtype(ttr.lm_forward(model, torch.from_numpy(toks)),
                              want, scale=LM_SCALE)
        lg, _, _ = ttr.lm_prefill(model, torch.from_numpy(toks), 24)
        assert_allclose_dtype(lg, jlg, scale=LM_SCALE)


def test_params_from_reference_round_trip(pair):
    cfg, _, params, model = pair
    period = len(ttr.layer_positions(cfg))
    mine = dict(model.named_parameters())
    expect = {"embed.table": params["embed"]["table"],
              "final_ln.scale": params["final_ln"]["scale"]}
    for n in range(cfg.num_layers):
        blk = params["blocks"][f"pos{n % period}"]
        rep = n // period
        for sub, leaves in blk.items():
            # {"scale": a} or {"wq": {"w": a}}
            for leaf, val in leaves.items():
                arr = val["w"] if isinstance(val, dict) else val
                expect[f"layers.{n}.{sub}.{leaf}"] = arr[rep]
    assert set(expect) == set(mine)
    for name, arr in expect.items():
        np.testing.assert_array_equal(mine[name].detach().numpy(),
                                      np.asarray(arr), err_msg=name)
    assert [blk.window for blk in model.layers] == [
        cfg.attention.sliding_window if cfg.layer_is_local(n) else 0
        for n in range(cfg.num_layers)]


def test_params_from_reference_rejects_a_mismatch(pair):
    cfg, _, params, model = pair
    tree = jax.tree.map(np.asarray, params)
    del tree["final_ln"]
    with pytest.raises(ValueError, match="final_ln"):
        ttr.TransformerLM(cfg, device="cpu").params_from_reference(tree)


def test_lm_forward_prefill_decode_match_reference(pair):
    cfg, jcfg, params, model = pair
    toks = _tokens(cfg, (2, 20), 1)
    want, _ = jtr.lm_forward(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got = ttr.lm_forward(model, torch.from_numpy(toks))
        assert got.dtype == torch.float32
        assert_allclose_dtype(got, want, scale=LM_SCALE)

        jlg, jcaches, jlen = jtr.lm_prefill(params, jcfg,
                                            jnp.asarray(toks[:, :16]),
                                            cache_size=24)
        lg, caches, length = ttr.lm_prefill(model,
                                            torch.from_numpy(toks[:, :16]),
                                            24)
        assert_allclose_dtype(lg, jlg, scale=LM_SCALE)
        assert int(length) == int(jlen) == 16
        for t in range(16, 20):
            jlg, jcaches, jlen = jtr.lm_decode_step(
                params, jcfg, jnp.asarray(toks[:, t:t + 1]), jcaches, jlen)
            lg, caches, length = ttr.lm_decode_step(
                model, torch.from_numpy(toks[:, t:t + 1]), caches, length)
            assert_allclose_dtype(lg, jlg, scale=LM_SCALE)
        assert int(length) == int(jlen) == 20


@pytest.fixture(scope="module", params=sorted(ARCHS))
def bf16_pair(request):
    """(cfg, reference cfg, reference params, port model on the CPU), in
    the configs' own dtype, bf16."""
    tmod, jmod = ARCHS[request.param]
    cfg, jcfg = tmod.reduced(), jmod.reduced()
    assert cfg.dtype == jcfg.dtype == "bfloat16"
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(tree)
    return cfg, jcfg, params, model


def _bf16_close(got, want):
    assert got.dtype == torch.float32
    assert_allclose_dtype(got, np.asarray(want, np.float32),
                          dtype=jnp.bfloat16)


def test_lm_bf16_forward_prefill_decode_match_reference(bf16_pair):
    """The bf16 LM path that phase 6 of chip_smoke.py serves, held to the
    reference's bf16 logits on the same weights (logits, not greedy
    tokens: random weights leave near-ties)."""
    cfg, jcfg, params, model = bf16_pair
    toks = _tokens(cfg, (2, 20), 1)
    want, _ = jtr.lm_forward(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        _bf16_close(ttr.lm_forward(model, torch.from_numpy(toks)), want)
        jlg, jcaches, jlen = jtr.lm_prefill(params, jcfg,
                                            jnp.asarray(toks[:, :16]),
                                            cache_size=24)
        lg, caches, length = ttr.lm_prefill(model,
                                            torch.from_numpy(toks[:, :16]),
                                            24)
        _bf16_close(lg, jlg)
        assert caches[0][0].dtype == torch.bfloat16
        for t in range(16, 20):
            jlg, jcaches, jlen = jtr.lm_decode_step(
                params, jcfg, jnp.asarray(toks[:, t:t + 1]), jcaches, jlen)
            lg, caches, length = ttr.lm_decode_step(
                model, torch.from_numpy(toks[:, t:t + 1]), caches, length)
            _bf16_close(lg, jlg)
        assert int(length) == int(jlen) == 20


@pytest.mark.parametrize("vocab", [7, layers.UNEMBED_CHUNK + 5])
def test_unembed_bf16_returns_the_f32_accumulator(vocab):
    """bf16 operands give the reference's f32 logits within the f32 band
    (not rounded to bf16), also across the CPU's vocab chunks."""
    rng = np.random.default_rng(vocab)
    table = rng.standard_normal((vocab, 64)).astype(np.float32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jt, jx = jnp.asarray(table, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    want = jlayers.unembed({"table": jt}, jx)
    tt, tx = (torch.from_numpy(np.array(a.astype(jnp.float32)))
              .to(torch.bfloat16) for a in (jt, jx))
    got = layers.unembed(tt, tx)
    assert got.dtype == torch.float32 and got.shape == (2, 3, vocab)
    assert_allclose_dtype(got, want)
    # the f32 accumulator itself: rounding it to bf16 would move it off
    assert not torch.equal(got, got.bfloat16().float())
    assert torch.equal(layers.unembed(tt.float(), tx.float()),
                       tx.float() @ tt.float().t())


def test_decode_matches_full_forward(pair):
    cfg, _, _, model = pair
    b, s = 2, 32
    toks = torch.from_numpy(_tokens(cfg, (b, s), 2))
    with torch.no_grad():
        full = ttr.lm_forward(model, toks)
        lg, caches, length = ttr.lm_prefill(model, toks[:, :s - 1], s + 4)
        assert_allclose_dtype(lg[:, 0], full[:, -2], scale=LM_SCALE)
        lg2, caches, length = ttr.lm_decode_step(model, toks[:, s - 1:],
                                                 caches, length)
        assert_allclose_dtype(lg2[:, 0], full[:, -1], scale=LM_SCALE)
        # per-slot lengths: slot 1 is one token behind and decodes its own
        caches = ttr.init_caches(cfg, b, s + 4, device="cpu")
        for slot, n in enumerate((s - 1, s - 2)):
            _, c1, _ = ttr.lm_prefill(model, toks[slot:slot + 1, :n], s + 4)
            for (bk, bv), (k1, v1) in zip(caches, c1):
                bk[slot:slot + 1] = k1
                bv[slot:slot + 1] = v1
        lens = torch.tensor([s - 1, s - 2], dtype=torch.int32)
        nxt = torch.stack([toks[0, s - 1:], toks[1, s - 2:s - 1]])
        lg3, _, lens = ttr.lm_decode_step(model, nxt, caches, lens)
        assert lens.tolist() == [s, s - 1]
        assert_allclose_dtype(lg3[0, 0], full[0, -1], scale=LM_SCALE)
        assert_allclose_dtype(lg3[1, 0], full[1, -2], scale=LM_SCALE)


def test_unsupported_families_raise():
    """An enc-dec stack (its model is ``models/encdec.py``) raises in
    ``TransformerLM`` and ``init_caches``, also with a frontend stub (the
    audio family's seamless has one); frontend embeddings on a decoder
    stack are held by tests/test_torch_vlm.py."""
    cfg = _fp32(granite_3_8b)
    for kw in ({"encoder_layers": 2},
               {"encoder_layers": 2, "frontend_stub": True}):
        bad = dataclasses.replace(cfg, **kw)
        with pytest.raises(NotImplementedError, match="enc-dec"):
            ttr.TransformerLM(bad, device="cpu")
        with pytest.raises(NotImplementedError, match="enc-dec"):
            ttr.init_caches(bad, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="enc-dec"):
        ttr.TransformerLM(get_config("seamless-m4t-medium"), device="meta")


# ---------------------------------------------------------------------------
# ServeEngine: greedy tokens equal the reference engine's
# ---------------------------------------------------------------------------


def _serve(engine_cls, request_cls, cfg, weights, reqs, **kw):
    eng = engine_cls(cfg, weights, **kw)
    for rid, prompt, max_tokens, eos in reqs:
        eng.submit(request_cls(rid=rid, prompt=prompt, max_tokens=max_tokens,
                               eos_id=eos))
    done = eng.run()
    return {r.rid: r.output for r in done}, eng.stats()


@pytest.mark.parametrize("max_batch", [1, 2])
def test_engine_greedy_tokens_match_reference(pair, max_batch):
    """Five requests through fewer slots: slots are reused (continuous
    batching) with prompts of other lengths in the other slots."""
    cfg, jcfg, params, model = pair
    reqs = [(i, _tokens(cfg, 3 + 2 * i, 10 + i), 3 + i, None)
            for i in range(5)]
    want, jstats = _serve(JServeEngine, JRequest, jcfg, params, reqs,
                          max_batch=max_batch, cache_size=40)
    got, stats = _serve(ServeEngine, Request, cfg, model, reqs,
                        max_batch=max_batch, cache_size=40)
    assert got == want
    assert [len(got[i]) for i in range(5)] == [3 + i for i in range(5)]
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert stats["served"] == 5 and stats["slot_assignments"] == 5


def test_engine_greedy_tokens_match_reference_moe():
    """Reduced arctic-480b in f32 (MoE layers with a dense residual, top-2
    of 4 experts): prefill with capacity drops, dropless decode; five
    requests through two slots emit the reference engine's greedy tokens."""
    cfg = dataclasses.replace(arctic_480b.reduced(), dtype="float32")
    jcfg = dataclasses.replace(jarctic.reduced(), dtype="float32")
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(
        jax.tree.map(np.asarray, params))
    reqs = [(i, _tokens(cfg, 3 + 4 * i, 20 + i), 4 + i, None)
            for i in range(5)]
    want, jstats = _serve(JServeEngine, JRequest, jcfg, params, reqs,
                          max_batch=2, cache_size=40)
    got, stats = _serve(ServeEngine, Request, cfg, model, reqs,
                        max_batch=2, cache_size=40)
    assert got == want
    assert stats["decode_steps"] == jstats["decode_steps"]


@pytest.mark.parametrize("name", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_param_counts_match_reference(name):
    """``param_count`` and ``active_param_count`` of the published MoE
    configs and their reduced ones against the reference's."""
    mod, jmod = CONFIG_MODULES[name]
    for cfg, jcfg in ((get_config(name), jget_config(name)),
                      (mod.reduced(), jmod.reduced())):
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.active_param_count() < cfg.param_count()


def test_engine_eos_and_full_cache_stop_like_reference(pair):
    cfg, jcfg, params, model = pair
    prompt = _tokens(cfg, 6, 3)
    first, _ = _serve(ServeEngine, Request, cfg, model,
                      [(0, prompt, 8, None)], max_batch=1, cache_size=32)
    eos = first[0][2]          # the third greedy token ends generation
    reqs = [(0, prompt, 8, eos), (1, _tokens(cfg, 12, 4), 30, None)]
    want, _ = _serve(JServeEngine, JRequest, jcfg, params, reqs,
                     max_batch=2, cache_size=16)
    got, stats = _serve(ServeEngine, Request, cfg, model, reqs,
                        max_batch=2, cache_size=16)
    assert got == want
    assert got[0] == first[0][:first[0].index(eos) + 1]
    assert len(got[1]) == 16 - 1 - 12 + 1   # stops when its cache is full
    assert 15 in stats["cache_len"]


def test_engine_temperature_sampling_is_seeded(pair):
    cfg, _, _, model = pair
    outs = []
    for _ in range(2):
        eng = ServeEngine(cfg, model, max_batch=2, cache_size=32, seed=5)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=_tokens(cfg, 4, i),
                               max_tokens=6, temperature=1.0))
        outs.append({r.rid: r.output for r in eng.run()})
    assert outs[0] == outs[1]
    assert all(0 <= t < cfg.vocab_size for o in outs[0].values() for t in o)


@pytest.mark.parametrize("arch", sorted(launch_serve.MODULES))
def test_launch_serve_reduced_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-tokens", "4"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
