"""The port's Mamba-2 block and its SSM and hybrid stacks against the JAX
package, on the CPU.

Layer level (``models/mamba2.py``): ``gated_rmsnorm``, ``causal_conv``,
``ssd_chunked`` (against the reference's ``_ssd_chunked`` and its
sequential oracle ``ssd_reference``, at the reference's own limits, rtol
1e-4 / atol 1e-5, and with a bf16 ``compute_dtype`` in the bf16 band) and
``mamba2_block`` on the reference's ``init_mamba2`` weights: prefill within
a chunk, at a multiple of it and padded, its caches, a decode step from the
reference's cache, and the gradients of ``out.sum()`` against
``jax.grad``.  The reference keeps a conv tail narrower than ``d_conv - 1``
after a 1- or 2-token prompt; the port keeps the full tail, and its
prefill plus decode must equal the reference's block over the whole
sequence.

Model level: reduced mamba2-2.7b (attention-free, FFN-free) and reduced
jamba-1.5-large (one attention layer in 8, MoE on odd layers) in f32, the
reference's ``init_lm`` weights loaded through ``params_from_reference``:
``lm_forward``, ``lm_prefill`` + ``lm_decode_step``, ``lm_loss`` and its
gradients and one ``make_train_step`` step, under the MoE tests' route rule
(``tests/moe_routes.py``); the ``ServeEngine``'s greedy tokens against the
reference's engine, and for 1- and 2-token prompts against a greedy
re-prefill of the growing sequence through the reference's ``lm_prefill``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from moe_routes import Routes
from tolerance import assert_allclose_dtype

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import SSMConfig as JSSMConfig
from repro.config import get_config as jget_config
from repro.configs import jamba_1_5_large as jjamba
from repro.configs import mamba2_2_7b as jmamba
from repro.launch import steps as jsteps
from repro.models import mamba2 as jm2
from repro.models import transformer as jtr
from repro.nn import layers as jlayers
from repro.optim import optimizer as jopt
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import OptimizerConfig, SSMConfig, get_config
from repro_torch.configs import jamba_1_5_large, mamba2_2_7b
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train_lm
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as ttr
from repro_torch.nn import layers
from repro_torch.optim.optimizer import make_train_state
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(2)

#: the reference's own limits for the chunked scan against its oracle
#: (``tests/test_mamba_moe.py``)
SSD_RTOL, SSD_ATOL = 1e-4, 1e-5
#: f32 band x 10 for whole-model logits (tests/test_torch_lm.py)
LM_SCALE = 10
#: each gradient leaf against the reference's, over that leaf's largest
#: magnitude (tests/test_torch_lm_train.py)
LEAF_LIMIT = 1e-4


def _leaf_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, z = (jnp.asarray(rng.standard_normal((2, 5, 48)), jdt)
            for _ in range(2))
    scale = rng.standard_normal(48).astype(np.float32) * 0.1
    want = jlayers.gated_rmsnorm({"scale": jnp.asarray(scale)}, x, z)
    tx, tz = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(dtype)
              for a in (x, z))
    got = layers.gated_rmsnorm(torch.from_numpy(scale), tx, tz)
    assert got.dtype == dtype
    assert_allclose_dtype(_np(got), np.asarray(want, np.float32),
                          dtype="f32" if dtype == torch.float32 else "bf16")


@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv_matches_reference(with_tail, dtype):
    rng = np.random.default_rng(1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((2, 9, 24)), jdt)
    w = jnp.asarray(rng.standard_normal((24, 4)) * 0.3, jdt)
    b = jnp.asarray(rng.standard_normal(24) * 0.1, jnp.float32)
    tail = jnp.asarray(rng.standard_normal((2, 24, 3)), jnp.float32) \
        if with_tail else None
    want = jm2._causal_conv(x, w, b, tail)
    tx, tw = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(dtype)
              for a in (x, w))
    got = m2.causal_conv(tx, tw, torch.tensor(np.asarray(b)),
                         None if tail is None
                         else torch.tensor(np.asarray(tail)))
    assert got.dtype == dtype and got.shape == (2, 9, 24)
    assert_allclose_dtype(_np(got), np.asarray(want, np.float32),
                          dtype="f32" if dtype == torch.float32 else "bf16")


@pytest.mark.parametrize("s,width", [(1, 3), (2, 3), (3, 3), (7, 3)])
def test_conv_tail_is_full_width_and_left_padded(s, width):
    """The tail a prefill of ``s`` tokens stores: always ``d_conv - 1``
    columns, the last tokens at the right, zeros (what the causal conv saw
    before the first token) at the left of a short prompt."""
    x = torch.arange(2 * s * 5, dtype=torch.bfloat16).reshape(2, s, 5)
    tail = m2.conv_tail(x, 4)
    assert tail.shape == (2, 5, width) and tail.dtype == torch.float32
    pad = max(0, width - s)
    assert not tail[:, :, :pad].any()
    assert torch.equal(tail[:, :, pad:],
                       x.transpose(1, 2)[:, :, -min(s, width):].float())


def _ssd_inputs(seed=11, b=2, s=64, h=4, p=8, g=2, n=16):
    """The reference test's inputs (``tests/test_mamba_moe.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.5 + 0.01).astype(np.float32)
    a = -(rng.random(h) + 0.2).astype(np.float32)
    return x, bm, cm, dt, a


def _ssd_pair(chunk: int, compute_dtype: str):
    kw = dict(d_state=16, n_groups=2, head_dim=8, chunk_size=chunk,
              compute_dtype=compute_dtype)
    return SSMConfig(**kw), JSSMConfig(**kw)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_chunked_f32_matches_reference(chunk):
    """f32, G = 2: the port's chunked scan against the reference's and
    against the reference's sequential oracle, at the reference's limits,
    y and the final state."""
    cfg, jcfg = _ssd_pair(chunk, "float32")
    x, bm, cm, dt, a = _ssd_inputs()
    jin = [jnp.asarray(v) for v in (x, bm, cm, dt, a)]
    jy, jst = jm2._ssd_chunked(*jin, jcfg)
    oy, ost = jm2.ssd_reference(*jin)
    y, st = m2.ssd_chunked(*(torch.from_numpy(v) for v in
                             (x, bm, cm, dt, a)), cfg)
    assert y.dtype == st.dtype == torch.float32
    for got, want in ((y, jy), (st, jst), (y, oy), (st, ost)):
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   rtol=SSD_RTOL, atol=SSD_ATOL)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_chunked_bf16_compute_matches_reference(chunk):
    """A bf16 ``compute_dtype`` (bf16 x, B and C; scores, decay mask and
    dt x in bf16, their products accumulated in f32, the state in f32):
    against the reference's chunked scan in the same dtypes, and against
    the f32 oracle, in the bf16 band."""
    cfg, jcfg = _ssd_pair(chunk, "bfloat16")
    x, bm, cm, dt, a = _ssd_inputs()
    jx, jb, jc = (jnp.asarray(v, jnp.bfloat16) for v in (x, bm, cm))
    jy, jst = jm2._ssd_chunked(jx, jb, jc, jnp.asarray(dt), jnp.asarray(a),
                               jcfg)
    oy, ost = jm2.ssd_reference(*(jnp.asarray(v) for v in
                                  (x, bm, cm, dt, a)))
    tx, tb, tc = (torch.tensor(np.asarray(v.astype(jnp.float32)))
                  .bfloat16() for v in (jx, jb, jc))
    y, st = m2.ssd_chunked(tx, tb, tc, torch.from_numpy(dt),
                           torch.from_numpy(a), cfg)
    assert y.dtype == st.dtype == torch.float32
    for got, want in ((y, jy), (st, jst), (y, oy), (st, ost)):
        assert_allclose_dtype(_np(got), np.asarray(want, np.float32),
                              dtype="bf16")


def test_ssd_reference_and_init_state_match_reference():
    """The port's sequential oracle against the reference's, and the
    chunked scan continued from a state against the reference's."""
    cfg, jcfg = _ssd_pair(16, "float32")
    x, bm, cm, dt, a = _ssd_inputs(s=32)
    jin = [jnp.asarray(v) for v in (x, bm, cm, dt, a)]
    tin = [torch.from_numpy(v) for v in (x, bm, cm, dt, a)]
    for got, want in zip(m2.ssd_reference(*tin), jm2.ssd_reference(*jin)):
        assert_allclose_dtype(_np(got), np.asarray(want))
    init = np.random.default_rng(2).standard_normal(
        (2, 4, 16, 8)).astype(np.float32)
    want = jm2._ssd_chunked(*jin, jcfg, init_state=jnp.asarray(init))
    got = m2.ssd_chunked(*tin, cfg, init_state=torch.from_numpy(init))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g_), np.asarray(w_), rtol=SSD_RTOL,
                                   atol=SSD_ATOL)


def test_ssd_chunked_refuses_a_ragged_chunk():
    cfg, _ = _ssd_pair(16, "float32")
    x, bm, cm, dt, a = (torch.from_numpy(v) for v in _ssd_inputs(s=40))
    with pytest.raises(ValueError, match="multiple"):
        m2.ssd_chunked(x, bm, cm, dt, a, cfg)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

D_MODEL = 32
BLOCK_CFG = SSMConfig(d_state=16, n_groups=1, head_dim=8, chunk_size=16)
CONV_DIM = m2.conv_dim(D_MODEL, BLOCK_CFG)


def _block(cfg: SSMConfig = BLOCK_CFG, dtype=torch.float32, seed=0):
    """(reference params, port ``Mamba2`` with the same weights)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params = jm2.init_mamba2(jax.random.PRNGKey(seed), D_MODEL,
                             JSSMConfig(**dataclasses.asdict(cfg)), jdt)
    # the reference draws zeros for conv_b and a constant dt_bias; move
    # them off their init so that the test sees them
    rng = np.random.default_rng(seed)
    params["conv_b"] = jnp.asarray(
        rng.standard_normal(params["conv_b"].shape) * 0.1, jnp.float32)
    params["dt_bias"] = params["dt_bias"] + jnp.asarray(
        rng.standard_normal(params["dt_bias"].shape) * 0.5, jnp.float32)
    params["norm"]["scale"] = jnp.asarray(
        rng.standard_normal(params["norm"]["scale"].shape) * 0.1,
        jnp.float32)
    flat = {}
    ttr.flatten_into(flat, "", params)
    flat = {n[1:]: np.asarray(v, np.float32) for n, v in flat.items()}
    block = m2.Mamba2(D_MODEL, cfg, dtype=dtype, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    return params, ttr.load_flat(block, flat)


def _x(shape, seed=3):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5
         ).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_block_parameters_and_dtypes():
    """The reference's leaves by name; the projections and the conv
    weight in the model's dtype, the rest f32 as the reference keeps them."""
    params, block = _block(dtype=torch.bfloat16)
    names = dict(block.named_parameters())
    assert sorted(names) == sorted(
        ["z_proj", "xbc_proj", "dt_proj", "out_proj", "conv_w", "conv_b",
         "A_log", "D", "dt_bias", "norm.scale"])
    for name, p in names.items():
        want = torch.bfloat16 if name in (
            "z_proj", "xbc_proj", "dt_proj", "out_proj", "conv_w") \
            else torch.float32
        assert p.dtype == want, name
    np.testing.assert_array_equal(
        _np(block.conv_w), np.asarray(params["conv_w"], np.float32))


@pytest.mark.parametrize("s", [7, 16, 20, 32, 33])
def test_block_prefill_caches_and_decode_match_reference(s):
    """Prefill within a chunk (7, 16), at a multiple (32) and padded (20,
    33): the output and the cache (final state, conv tail) against the
    reference's; then a decode step from the reference's cache, its output
    and new cache against the reference's, the new state and tail written
    into the cache tensors given."""
    params, block = _block()
    jx, tx = _x((2, s + 1, D_MODEL))
    want, jcache = jm2.mamba2_block(params, jx[:, :s], BLOCK_CFG,
                                    make_cache=True)
    with torch.no_grad():
        got, cache = block(tx[:, :s], make_cache=True)
    assert_allclose_dtype(_np(got), np.asarray(want))
    assert_allclose_dtype(_np(cache.state), np.asarray(jcache.state))
    assert cache.conv.shape == jcache.conv.shape == (2, CONV_DIM, 3)
    assert_allclose_dtype(_np(cache.conv), np.asarray(jcache.conv))
    assert int(cache.length) == s

    jout, jnew = jm2.mamba2_block(params, jx[:, s:s + 1], BLOCK_CFG,
                                  cache=jcache)
    mine = m2.SSMCache(torch.tensor(np.asarray(jcache.state)),
                       torch.tensor(np.asarray(jcache.conv)),
                       torch.tensor(s, dtype=torch.int32))
    with torch.no_grad():
        out, new = block(tx[:, s:s + 1], cache=mine)
    assert new.state is mine.state and new.conv is mine.conv
    assert_allclose_dtype(_np(out), np.asarray(jout))
    assert_allclose_dtype(_np(mine.state), np.asarray(jnew.state))
    assert_allclose_dtype(_np(mine.conv), np.asarray(jnew.conv))
    assert int(new.length) == int(jnew.length) == s + 1


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_keeps_the_full_conv_tail(s):
    """A prompt shorter than ``d_conv - 1``: the port's tail is (B,
    conv_dim, 3), and its prefill plus decode steps equal the reference's
    block over the whole sequence (the reference's own cache is narrower
    here, so its decode cannot be the yardstick)."""
    params, block = _block()
    n = 4
    jx, tx = _x((2, s + n, D_MODEL), seed=5)
    want, _ = jm2.mamba2_block(params, jx, BLOCK_CFG)
    with torch.no_grad():
        got, cache = block(tx[:, :s], make_cache=True)
        assert cache.conv.shape == (2, CONV_DIM, 3)
        outs = [got]
        for t in range(s, s + n):
            out, cache = block(tx[:, t:t + 1], cache=cache)
            outs.append(out)
    assert_allclose_dtype(_np(torch.cat(outs, 1)), np.asarray(want),
                          scale=2)


@pytest.mark.parametrize("s", [12, 33])
def test_block_gradients_match_reference(s):
    """d out.sum() for x and every leaf against ``jax.grad`` (one chunk and
    padded to three), each within LEAF_LIMIT of its largest magnitude."""
    params, block = _block()
    jx, tx = _x((2, s, D_MODEL), seed=7)
    jgp, jgx = jax.grad(
        lambda p, x: jm2.mamba2_block(p, x, BLOCK_CFG)[0].sum(),
        argnums=(0, 1))(params, jx)
    tx.requires_grad_(True)
    out, _ = block(tx)
    names = [n for n, _ in block.named_parameters()]
    grads = torch.autograd.grad(out.sum(), [tx] + [
        p for _, p in block.named_parameters()])
    flat = {}
    ttr.flatten_into(flat, "", jax.tree.map(np.asarray, jgp))
    want = {n[1:]: v for n, v in flat.items()}
    assert sorted(want) == sorted(names)
    errs = {"x": _leaf_err(_np(grads[0]), np.asarray(jgx))}
    errs.update({n: _leaf_err(_np(g), want[n])
                 for n, g in zip(names, grads[1:])})
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_LIMIT, (worst, errs[worst])


def test_block_bf16_prefill_and_decode_in_the_bf16_band():
    """bf16 weights and x with a bf16 ``compute_dtype``: prefill (padded)
    and a decode step against the reference's in the bf16 band, and the
    decode's caches in f32."""
    cfg = dataclasses.replace(BLOCK_CFG, compute_dtype="bfloat16")
    params, block = _block(cfg, torch.bfloat16)
    jx, _ = _x((2, 21, D_MODEL), seed=9)
    jx = jx.astype(jnp.bfloat16)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).bfloat16()
    jcfg = JSSMConfig(**dataclasses.asdict(cfg))
    want, jcache = jm2.mamba2_block(params, jx[:, :20], jcfg,
                                    make_cache=True)
    jout, _ = jm2.mamba2_block(params, jx[:, 20:], jcfg, cache=jcache)
    with torch.no_grad():
        got, cache = block(tx[:, :20], make_cache=True)
        out, _ = block(tx[:, 20:], cache=cache)
    assert got.dtype == out.dtype == torch.bfloat16
    assert cache.state.dtype == cache.conv.dtype == torch.float32
    assert_allclose_dtype(_np(got), np.asarray(want, np.float32),
                          dtype="bf16")
    assert_allclose_dtype(_np(out), np.asarray(jout, np.float32),
                          dtype="bf16")


def test_bf16_rounding_at_depth_tracks_the_reference():
    """64 Mamba-2 layers (reduced widths, d_model 128) in bf16 with a bf16
    ``compute_dtype``, against the same weights in f32: the port's bf16
    logits are about as far from its f32 ones as the reference's bf16
    logits are from the reference's f32 ones (relative Frobenius, within
    1.5x), while the two f32 paths agree in the f32 band.  The distance
    itself (about 8 % on both sides) is what bf16 rounding at this depth
    gives with random weights, so a decode-against-prefill check in bf16
    at 64 layers (``chip_smoke.py`` phase 21) cannot hold a few percent."""
    def cfgs(mod, dtype, cd):
        c = mod.reduced()
        return dataclasses.replace(
            c, num_layers=64, d_model=128, dtype=dtype,
            ssm=dataclasses.replace(c.ssm, compute_dtype=cd))
    j16, j32 = cfgs(jmamba, "bfloat16", "bfloat16"), \
        cfgs(jmamba, "float32", "float32")
    t16, t32 = cfgs(mamba2_2_7b, "bfloat16", "bfloat16"), \
        cfgs(mamba2_2_7b, "float32", "float32")
    p16 = jtr.init_lm(j16, jax.random.PRNGKey(0))
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), p16)
    m16 = ttr.TransformerLM(t16, device="cpu").params_from_reference(tree)
    m32 = ttr.TransformerLM(t32, device="cpu").params_from_reference(tree)
    toks = _tokens(t16, (1, 40), 0)
    v = t16.vocab_size

    def fro(a, b):
        a = np.asarray(a, np.float64)[..., :v]
        b = np.asarray(b, np.float64)[..., :v]
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    ref16 = jtr.lm_forward(p16, j16, jnp.asarray(toks))[0]
    ref32 = jtr.lm_forward(p32, j32, jnp.asarray(toks))[0]
    with torch.no_grad():
        got16 = ttr.lm_forward(m16, torch.from_numpy(toks)).numpy()
        got32 = ttr.lm_forward(m32, torch.from_numpy(toks)).numpy()
    ref_noise, port_noise = fro(ref16, ref32), fro(got16, got32)
    assert_allclose_dtype(got32, np.asarray(ref32), scale=LM_SCALE)
    assert port_noise <= 1.5 * ref_noise, (port_noise, ref_noise)
    assert ref_noise > 5e-2, ref_noise


# ---------------------------------------------------------------------------
# Configs and counts
# ---------------------------------------------------------------------------

CONFIGS = {"mamba2-2.7b": (mamba2_2_7b, jmamba),
           "jamba-1.5-large-398b": (jamba_1_5_large, jjamba)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_match_reference(name):
    mod, jmod = CONFIGS[name]
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jget_config(name))
    assert dataclasses.asdict(mod.reduced()) == \
        dataclasses.asdict(jmod.reduced())
    cfg, jcfg = get_config(name), jget_config(name)
    assert [cfg.layer_is_attention(i) for i in range(cfg.num_layers)] == \
        [jcfg.layer_is_attention(i) for i in range(cfg.num_layers)]
    assert [p.kind for p in ttr.layer_positions(cfg)] == \
        [p.kind for p in jtr.layer_positions(jcfg)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_counts_match_reference(name):
    mod, jmod = CONFIGS[name]
    for cfg, jcfg in ((get_config(name), jget_config(name)),
                      (mod.reduced(), jmod.reduced())):
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


def test_mamba2_param_count_is_the_published_one():
    assert get_config("mamba2-2.7b").param_count() == 2_702_063_616


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_meta_skeleton_at_full_width_counts_its_leaves(name):
    """The published configs build on the ``meta`` device (no memory):
    their parameters are ``param_count`` plus the padded vocabulary rows,
    the norm scales outside the SSM blocks and each SSM block's ``conv_b``
    and ``dt_bias``, which the analytic count leaves out."""
    cfg = get_config(name)
    model = ttr.TransformerLM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    s = cfg.ssm
    kinds = [cfg.layer_is_attention(i) for i in range(cfg.num_layers)]
    n_ssm = kinds.count(False)
    ffn = cfg.d_ff > 0 or cfg.moe is not None
    tables = 1 if cfg.tie_embeddings else 2
    extra = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * tables \
        + ((2 if ffn else 1) * cfg.num_layers + 1) * cfg.d_model \
        + n_ssm * (m2.conv_dim(cfg.d_model, s) + s.n_heads(cfg.d_model))
    assert n == cfg.param_count() + extra
    assert [blk.kind == "attn" for blk in model.layers] == kinds
    assert all(blk.has_ffn == ffn for blk in model.layers)
    if name == "mamba2-2.7b":
        assert not hasattr(model.layers[0], "ln2")
        assert model.layers[0].ssm.A_log.dtype == torch.float32
        assert model.layers[0].ssm.z_proj.dtype == torch.bfloat16


def test_init_lm_leaves_match_reference():
    """A mamba2 stack's leaves: the reference's names, shapes and dtypes;
    the random ones with the reference's std, the rest its values."""
    cfg = dataclasses.replace(mamba2_2_7b.reduced(), dtype="float32",
                              d_model=128)
    jcfg = dataclasses.replace(jmamba.reduced(), dtype="float32",
                               d_model=128)
    want = ttr.flatten_reference(
        jax.tree.map(np.asarray, jtr.init_lm(jcfg, jax.random.PRNGKey(1))),
        cfg)
    model = ttr.init_lm(cfg, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    got = {n: _np(p) for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    random = ("table", "z_proj", "xbc_proj", "dt_proj", "out_proj", "conv_w")
    for n, a in got.items():
        assert a.shape == want[n].shape, n
        if n.endswith(random):
            ratio = a.std() / want[n].std()
            assert abs(ratio - 1) < 0.05, (n, ratio)
        else:
            assert_allclose_dtype(a, want[n], err_msg=n)


# ---------------------------------------------------------------------------
# The stacks
# ---------------------------------------------------------------------------

ARCHS = {"mamba2": (mamba2_2_7b, jmamba), "jamba": (jamba_1_5_large, jjamba)}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def stack(request):
    """(cfg, reference cfg, reference params, port model), f32."""
    tmod, jmod = ARCHS[request.param]
    cfg = dataclasses.replace(tmod.reduced(), dtype="float32")
    jcfg = dataclasses.replace(jmod.reduced(), dtype="float32")
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(
        jax.tree.map(np.asarray, params))
    return cfg, jcfg, params, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _n_moe(cfg):
    return sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))


def _k(cfg):
    return cfg.moe.top_k if cfg.moe is not None else 1


def _dropless(cfg):
    """``cfg`` with an MoE capacity that drops nothing (``capacity_factor``
    E: an expert's capacity is t k slots, and a token takes it at most
    once), so that a prefill's MoE layers route as a decode step's do."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _dropless_model(cfg, model):
    out = ttr.TransformerLM(_dropless(cfg), device="cpu")
    out.load_state_dict(model.state_dict())
    return out


def test_stack_layers_and_params_from_reference(stack):
    """Every leaf of the reference's ``init_lm`` loads, layer ``rep *
    period + i`` from slice ``rep`` of ``pos{i}``; a layer is ``attn`` or
    ``ssm`` as the config says, and a mamba2 block has no FFN."""
    cfg, _, params, model = stack
    want = ttr.flatten_reference(jax.tree.map(np.asarray, params), cfg)
    mine = dict(model.named_parameters())
    assert sorted(want) == sorted(mine)
    for name, arr in want.items():
        np.testing.assert_array_equal(_np(mine[name]), np.asarray(arr),
                                      err_msg=name)
    for i, blk in enumerate(model.layers):
        attn = cfg.layer_is_attention(i)
        assert blk.kind == ("attn" if attn else "ssm")
        assert hasattr(blk, "attn") == attn and hasattr(blk, "ssm") != attn
        assert blk.has_ffn == (cfg.d_ff > 0 or cfg.layer_is_moe(i))


def test_stack_forward_prefill_decode_match_reference(stack, monkeypatch):
    """``lm_forward`` over 40 tokens (padded to three chunks), then a
    33-token ``lm_prefill`` and 7 ``lm_decode_step``s, against the
    reference's; the decode caches are the ones given, written in place.
    A hybrid's logits only where no MoE route differs upstream."""
    cfg, jcfg, params, model = stack
    k, n_moe = _k(cfg), _n_moe(cfg)
    toks = _tokens(cfg, (2, 40), 1)
    routes = Routes(monkeypatch)
    want, _ = jtr.lm_forward(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got = ttr.lm_forward(model, torch.from_numpy(toks))
    mask, _ = routes.comparable(k, 2, [(list(range(40)), n_moe)])
    assert mask.mean() >= 0.5
    assert_allclose_dtype(got.numpy()[mask], np.asarray(want)[mask],
                          scale=LM_SCALE)

    routes.port.clear(), routes.ref.clear()
    calls = [(list(range(33)), n_moe)]
    jlg, jcaches, jlen = jtr.lm_prefill(params, jcfg,
                                        jnp.asarray(toks[:, :33]),
                                        cache_size=48)
    with torch.no_grad():
        lg, caches, length = ttr.lm_prefill(
            model, torch.from_numpy(toks[:, :33]), 48)
        given = [tuple(c) for c in caches]
        logits, jlogits = [lg], [jlg]
        for t in range(33, 40):
            jlg, jcaches, jlen = jtr.lm_decode_step(
                params, jcfg, jnp.asarray(toks[:, t:t + 1]), jcaches, jlen)
            lg, caches, length = ttr.lm_decode_step(
                model, torch.from_numpy(toks[:, t:t + 1]), caches, length)
            logits.append(lg), jlogits.append(jlg)
            calls.append(([t], n_moe))
    mask, _ = routes.comparable(k, 2, calls)
    routes.close()
    assert all(a is b for pair, new in zip(given, caches)
               for a, b in zip(pair, new))
    got = torch.cat(logits, 1).numpy()
    want = np.concatenate([np.asarray(a) for a in jlogits], 1)
    cols = mask[:, 32:40]
    assert cols.mean() >= 0.5
    assert_allclose_dtype(got[cols], want[cols], scale=LM_SCALE)
    assert int(length) == int(jlen) == 40


def test_stack_decode_matches_forward_per_slot(stack):
    """On the port alone: two slots prefilled one at a time (2 and 21
    tokens: a short tail and a padded scan) into zeroed caches, then
    decode steps over both, against the full forward at each position
    (a hybrid's MoE layers without capacity drops, as decode has none)."""
    cfg, _, _, model = stack
    cfg, model = _dropless(cfg), _dropless_model(cfg, model)
    toks = torch.from_numpy(_tokens(cfg, (2, 24), 2))
    lens = (2, 21)
    with torch.no_grad():
        full = ttr.lm_forward(model, toks)
        caches = ttr.init_caches(cfg, 2, 32, device="cpu")
        for slot, n in enumerate(lens):
            _, c1, _ = ttr.lm_prefill(model, toks[slot:slot + 1, :n], 32)
            for whole, one in zip(caches, c1):
                for w_, o_ in zip(whole, one):
                    w_[slot:slot + 1] = o_
        length = torch.tensor(lens, dtype=torch.int32)
        for step in range(3):
            nxt = torch.stack([toks[i, n + step:n + step + 1]
                               for i, n in enumerate(lens)])
            lg, caches, length = ttr.lm_decode_step(model, nxt, caches,
                                                    length)
            for i, n in enumerate(lens):
                assert_allclose_dtype(lg[i, 0], full[i, n + step],
                                      scale=LM_SCALE)


def test_stack_loss_and_gradients_match_reference(stack, monkeypatch):
    """``lm_loss`` (a hybrid's with its MoE aux) and every gradient leaf
    against ``jax.value_and_grad``; every route must agree."""
    cfg, jcfg, params, model = stack
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)],
                            1)
    routes = Routes(monkeypatch)
    (jloss, jm), jgrad = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jcfg, jnp.asarray(toks),
                              jnp.asarray(labels), ce_chunk=16),
        has_aux=True)(params)
    loss, metrics = ttr.lm_loss(model, torch.from_numpy(toks),
                                torch.from_numpy(labels), ce_chunk=16)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    mask, _ = routes.comparable(_k(cfg), 2, [(list(range(24)), _n_moe(cfg))])
    routes.close()
    assert mask.all(), "a route differs: the gradients are not comparable"
    assert_allclose_dtype(loss.detach(), np.asarray(jloss))
    assert_allclose_dtype(metrics["ce"].detach(), np.asarray(jm["ce"]))
    np.testing.assert_allclose(float(metrics["aux"].detach()),
                               float(jm["aux"]), rtol=0, atol=1e-6)
    want = ttr.flatten_reference(jax.tree.map(np.asarray, jgrad), cfg)
    assert sorted(want) == sorted(names)
    errs = {n: _leaf_err(g.numpy(), want[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_LIMIT, (worst, errs[worst])


def test_stack_train_step_matches_reference(stack, monkeypatch):
    """One AdamW ``make_train_step`` step from the reference's weights:
    the metrics in the f32 band x 10, each parameter leaf within
    LEAF_LIMIT of its largest magnitude (norm scales as the 1 + scale they
    apply).  Every route must agree."""
    cfg, jcfg, params, model = stack
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, weight_decay=0.0,
              eps=1e-6)
    opt, jopt_cfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    batch = {"tokens": toks,
             "labels": np.roll(toks, -1, 1).astype(np.int32)}
    routes = Routes(monkeypatch)
    state = make_train_state(
        {n: p.detach().clone() for n, p in model.named_parameters()}, opt)
    state, metrics = tsteps.make_train_step(cfg, opt)(state, batch)
    jstate, jmetrics = jsteps.make_train_step(jcfg, jopt_cfg)(
        jopt.make_train_state(params, jopt_cfg),
        {k: jnp.asarray(v) for k, v in batch.items()})
    mask, _ = routes.comparable(_k(cfg), 2, [(list(range(20)),
                                              _n_moe(cfg))])
    routes.close()
    assert mask.all(), "a route differs: the steps are not comparable"
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert_allclose_dtype(metrics[key], np.asarray(jmetrics[key]),
                              scale=10, err_msg=key)
    want = ttr.flatten_reference(jax.tree.map(np.asarray, jstate.params),
                                 cfg)
    scales = {n for n in want if n.endswith(".scale")}
    errs = {n: _leaf_err(p.numpy() + (n in scales), want[n] + (n in scales))
            for n, p in state.params.items()}
    assert all(e <= LEAF_LIMIT for e in errs.values()), \
        {n: e for n, e in errs.items() if e > LEAF_LIMIT}


def test_step_makers_take_the_ssm_and_hybrid_families(stack):
    """``launch/steps.py`` runs the ssm and hybrid families through
    ``TransformerLM``: ``make_prefill_step`` and ``make_decode_step`` bit
    for bit ``lm_prefill`` and ``lm_decode_step``, ``make_eval_step`` the
    loss's metrics."""
    cfg, _, _, model = stack
    assert cfg.family in ("ssm", "hybrid")
    toks = torch.from_numpy(_tokens(cfg, (2, 20), 5))
    with torch.no_grad():
        lg, caches, length = tsteps.make_prefill_step(cfg, 24)(
            model, {"tokens": toks[:, :19]})
        want, wcaches, wlength = ttr.lm_prefill(model, toks[:, :19], 24)
        assert torch.equal(lg, want) and int(length) == int(wlength) == 19
        lg, _, length = tsteps.make_decode_step(cfg)(
            model, {"token": toks[:, 19:], "caches": caches,
                    "length": length})
        want, _, _ = ttr.lm_decode_step(model, toks[:, 19:], wcaches,
                                        wlength)
        assert torch.equal(lg, want) and int(length) == 20
        params = {n: p.detach() for n, p in model.named_parameters()}
        metrics = tsteps.make_eval_step(cfg)(
            params, {"tokens": toks, "labels": torch.roll(toks, -1, 1)})
        _, wm = ttr.lm_loss(model, toks, torch.roll(toks, -1, 1))
    assert sorted(metrics) == ["aux", "ce"]
    assert torch.equal(metrics["ce"], wm["ce"])
    assert torch.equal(metrics["aux"], wm["aux"])


def test_caches_of_both_kinds(stack):
    """``init_caches`` gives each layer its kind: K and V in the model's
    dtype at ``cache_size`` for attention, an f32 state and a 3-column
    f32 conv tail for an SSM layer, whatever ``cache_size``."""
    cfg, _, _, _ = stack
    caches = ttr.init_caches(cfg, 3, 40, device="cpu")
    s = cfg.ssm
    for i, (first, second) in enumerate(caches):
        if cfg.layer_is_attention(i):
            a = cfg.attention
            assert first.shape == second.shape == (3, a.num_kv_heads, 40,
                                                   a.head_dim)
        else:
            assert first.shape == (3, s.n_heads(cfg.d_model), s.d_state,
                                   s.head_dim)
            assert second.shape == (3, m2.conv_dim(cfg.d_model, s), 3)
            assert first.dtype == second.dtype == torch.float32
        assert not first.any() and not second.any()


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------


def _serve(engine_cls, request_cls, cfg, weights, reqs, **kw):
    eng = engine_cls(cfg, weights, **kw)
    for rid, prompt, max_tokens in reqs:
        eng.submit(request_cls(rid=rid, prompt=prompt, max_tokens=max_tokens))
    done = eng.run()
    return {r.rid: r.output for r in done}, eng.stats()


@pytest.mark.parametrize("max_batch", [1, 2])
def test_engine_greedy_tokens_match_reference(stack, max_batch):
    """Five requests of 3 to 35 tokens (within a chunk, padded, a
    multiple) through fewer slots: the reference engine's greedy tokens."""
    cfg, jcfg, params, model = stack
    reqs = [(i, _tokens(cfg, n, 10 + i), 3 + i)
            for i, n in enumerate((3, 16, 35, 5, 32))]
    want, jstats = _serve(JServeEngine, JRequest, jcfg, params, reqs,
                          max_batch=max_batch, cache_size=48)
    got, stats = _serve(ServeEngine, Request, cfg, model, reqs,
                        max_batch=max_batch, cache_size=48)
    assert got == want
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert stats["served"] == 5


def _reprefill_greedy(params, jcfg, prompt, n):
    """The oracle for a short prompt: greedy tokens from the reference's
    ``lm_prefill`` over the growing sequence, one whole prefill a token."""
    seq, out = list(prompt), []
    for _ in range(n):
        lg, _, _ = jtr.lm_prefill(params, jcfg,
                                  jnp.asarray(np.array([seq], np.int32)),
                                  cache_size=len(seq))
        tok = int(np.asarray(lg)[0, -1].argmax())
        out.append(tok)
        seq.append(tok)
    return out


def test_engine_short_prompts_match_greedy_reprefill(stack):
    """1- and 2-token prompts beside a longer one in a two-slot engine:
    each short request's greedy tokens are the reference's re-prefill
    oracle's (a
    hybrid's MoE layers without capacity drops on both sides, as a decode
    step has none)."""
    cfg, jcfg, params, model = stack
    cfg, jcfg, model = _dropless(cfg), _dropless(jcfg), \
        _dropless_model(cfg, model)
    reqs = [(0, _tokens(cfg, 1, 20), 4), (1, _tokens(cfg, 19, 21), 3),
            (2, _tokens(cfg, 2, 22), 4)]
    got, _ = _serve(ServeEngine, Request, cfg, model, reqs, max_batch=2,
                    cache_size=40)
    assert [len(got[rid]) for rid, _, _ in reqs] == [4, 3, 4]
    for rid, prompt, n in reqs:
        if len(prompt) < 3:
            assert got[rid] == _reprefill_greedy(params, jcfg, prompt, n), \
                rid


def test_reference_engine_misserves_a_two_token_prompt():
    """The reference caveat the port departs from (ROADMAP "Reference
    caveats"): after a 2-token prompt the reference keeps a 1-column conv
    tail (its slice starts at s - 3 = -1), its engine broadcasts it across
    the slot's 3 columns, and its
    greedy tokens leave the re-prefill oracle's; the port's engine, on
    the same weights, serves the oracle's tokens (reduced mamba2-2.7b in
    its own bf16, seed 0, prompt ``default_rng(0)``, 4 greedy tokens)."""
    jcfg, cfg = jmamba.reduced(), mamba2_2_7b.reduced()
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 2)
    _, jcaches, _ = jtr.lm_prefill(params, jcfg,
                                   jnp.asarray(prompt[None], jnp.int32),
                                   cache_size=2)
    assert jcaches["pos0"]["conv"].shape[-1] == 1
    reqs = [(0, prompt, 4)]
    ref, _ = _serve(JServeEngine, JRequest, jcfg, params, reqs, max_batch=2,
                    cache_size=64)
    got, _ = _serve(ServeEngine, Request, cfg, model, reqs, max_batch=2,
                    cache_size=64)
    want = _reprefill_greedy(params, jcfg, prompt, 4)
    assert ref[0] != want and got[0] == want


def test_engine_cache_write_never_broadcasts(monkeypatch):
    """A prefill cache narrower than the slot's (the reference's 1-column
    tail after a 1-token prompt) is refused, not broadcast."""
    cfg = dataclasses.replace(mamba2_2_7b.reduced(), dtype="float32")
    model = ttr.TransformerLM(cfg, device="cpu")
    orig = engine_mod.lm_prefill

    def narrow(*a, **kw):
        logits, caches, length = orig(*a, **kw)
        return logits, [(s, c[:, :, -1:]) for s, c in caches], length
    monkeypatch.setattr(engine_mod, "lm_prefill", narrow)
    eng = ServeEngine(cfg, model, max_batch=2, cache_size=16)
    eng.submit(Request(rid=0, prompt=np.array([3]), max_tokens=2))
    with pytest.raises(ValueError, match="does not fill"):
        eng.run()


def test_launchers_take_the_new_archs():
    assert {"mamba2-2.7b", "jamba-1.5-large-398b"} <= set(launch_serve.MODULES)
    cfg = train_lm.make_config("mamba2-2.7b", width="full", layers=8)
    assert (cfg.d_model, cfg.num_layers, cfg.dtype, cfg.ssm.compute_dtype) \
        == (2560, 8, "float32", "bfloat16")
    assert train_lm.make_config("jamba-1.5-large-398b").family == "hybrid"
