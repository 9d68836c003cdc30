"""K5's plain version and the port's attention against the JAX package.

``flash_attention_plain`` (what the CUDA kernel is held against on the
card) must match the Pallas ``flash_attention`` run in interpret mode, at
``tests/test_kernels.py``'s own cases, and both packages' ``mha_ref``.  The
port's ``direct_attention``, ``decode_attention`` and ``attention_block``
(prefill with ``make_cache``, decode with scalar and per-slot lengths) must
match the JAX functions on the same projected weights.  The CUDA kernel
itself needs a card: tests/test_torch_cuda.py holds it there.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.configs import gemma2_9b as jgemma
from repro.kernels.flash_attention import flash_attention as flash_pallas
from repro.kernels.ref import mha_ref as jmha_ref
from repro.nn import attention as jattn
from repro_torch.configs import gemma2_9b
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mha_ref
from repro_torch.nn import attention as tattn

torch.set_num_threads(2)

RNG = np.random.default_rng(13)
#: shared memory of one H100 SM; the card reserves 1 KB of it per block
H100_SMEM_PER_SM = 233472

#: tests/test_kernels.py CASES: b, hq, hkv, sq, sk, d, causal, window, cap
CASES = [
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),
    (1, 8, 4, 100, 260, 32, True, 0, 50.0),
    (2, 2, 1, 64, 192, 64, True, 48, 0.0),
    (1, 4, 4, 1, 300, 64, True, 0, 0.0),          # decode shape
    (1, 2, 2, 96, 96, 128, False, 0, 0.0),        # non-causal (encoder)
]


def _qkv(b, hq, hkv, sq, sk, d, dtype=np.float32):
    return (RNG.standard_normal((b, hq, sq, d)).astype(dtype),
            RNG.standard_normal((b, hkv, sk, d)).astype(dtype),
            RNG.standard_normal((b, hkv, sk, d)).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap", CASES)
def test_plain_matches_pallas_and_ref(b, hq, hkv, sq, sk, d, causal, window,
                                      cap):
    q, k, v = _qkv(b, hq, hkv, sq, sk, d)
    want = flash_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window, softcap=cap,
                        tile_q=64, tile_k=64)
    # small chunks, so the online softmax crosses several KV blocks
    got = k5.flash_attention_plain(*_t(q, k, v), causal=causal,
                                   window=window, softcap=cap, q_chunk=48,
                                   kv_chunk=40)
    assert_allclose_dtype(got, want, scale=20)
    assert_allclose_dtype(mha_ref(*_t(q, k, v), causal=causal,
                                  sliding_window=window, logit_softcap=cap),
                          jmha_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   sliding_window=window, logit_softcap=cap),
                          scale=20)
    # the wrapper takes the plain version for CPU tensors
    n = k5.flash_attention.launches
    assert_allclose_dtype(
        ops.flash_attention(*_t(q, k, v), causal=causal, window=window,
                            softcap=cap, backend="torch"), want, scale=20)
    assert_allclose_dtype(
        k5.flash_attention(*_t(q, k, v), causal=causal, window=window,
                           softcap=cap), want, scale=20)
    assert k5.flash_attention.launches == n


def test_plain_kv_len_matches_pallas():
    b, hq, hkv, sq, sk, d = 2, 4, 2, 8, 192, 32
    q, k, v = _qkv(b, hq, hkv, sq, sk, d)
    kvl = np.asarray([50, 192], np.int32)
    want = flash_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(kvl), tile_q=64, tile_k=64)
    got = k5.flash_attention_plain(*_t(q, k, v, kvl), kv_chunk=64)
    assert_allclose_dtype(got, want, scale=20)
    assert_allclose_dtype(mha_ref(*_t(q, k, v), kv_len=torch.tensor(kvl)),
                          want, scale=20)


def test_plain_all_masked_rows_give_zero():
    # kv_len 3 < Sq 8: under causal the first 5 rows see no key at all
    q, k, v = _qkv(1, 2, 1, 8, 16, 16)
    got = k5.flash_attention_plain(*_t(q, k, v),
                                   torch.tensor([3], dtype=torch.int32))
    assert torch.isfinite(got).all()
    assert (got[:, :, :5] == 0).all() and (got[:, :, 5:] != 0).all()


@pytest.mark.parametrize("dtype,scale", [(np.float32, 20), ("bf16", 1)])
def test_plain_dtypes_match_pallas(dtype, scale):
    q, k, v = _qkv(1, 2, 2, 64, 64, 32)
    if dtype == "bf16":
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(torch.bfloat16) for a in (jq, jk, jv))
    else:
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        tq, tk, tv = _t(q, k, v)
    want = flash_pallas(jq, jk, jv, tile_q=32, tile_k=32)
    got = k5.flash_attention_plain(tq, tk, tv, q_chunk=32, kv_chunk=32)
    assert got.dtype == tq.dtype
    assert_allclose_dtype(got.float(), np.asarray(want.astype(jnp.float32)),
                          dtype=jq.dtype, scale=scale)
    ref = mha_ref(tq.float(), tk.float(), tv.float())
    assert_allclose_dtype(got.float(), ref, dtype=jq.dtype, scale=scale)


@pytest.mark.parametrize("d", k5.HEAD_DIMS)
@pytest.mark.parametrize("dtype,group", [(torch.float32, 1),
                                         (torch.bfloat16, 1),
                                         (torch.bfloat16, 2),
                                         (torch.bfloat16, 4)])
def test_flash_shared_memory_and_tiles(d, dtype, group):
    """K5's shared memory at every head dim fits the H100's 227 KB per
    block.  The bf16 kernel's tiles are wgmma-shaped (64 query rows, keys in
    k16 steps, K/V tiles in whole 1024-byte swizzle atoms); at d = 256 an
    even GQA group puts two heads in a CTA, otherwise two CTAs share an SM
    (the card reserves 1 KB per block)."""
    need = k5.smem_bytes(d, dtype, group)
    assert 0 < need <= k5._H100_SMEM_OPTIN
    tq, tk, heads = k5.tiles(d, dtype, group)
    if dtype == torch.bfloat16:
        assert tq == 64 and tk % 16 == 0 and tk * d * 2 % 1024 == 0
        assert heads == (2 if d == 256 and group % 2 == 0 else 1)
        assert need == (heads * tq * d + 4 * tk * d) * 2 + 1024
        if heads == 1:
            assert 2 * (need + 1024) <= H100_SMEM_PER_SM
    else:
        assert (tq, tk, heads) == (64, 32, 1)


def test_cuda_tier_on_cpu_tensors_raises():
    q, k, v = _t(*_qkv(1, 2, 1, 4, 4, 16))
    with pytest.raises(ValueError, match="cuda"):
        ops.flash_attention(q, k, v, backend="cuda")
    cfg = dataclasses.replace(gemma2_9b.reduced(), dtype="float32")
    p = _weights(cfg.d_model, cfg.attention)[1]
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="cuda"):
        tattn.attention_block(p, x, cfg.attention, impl="cuda")


# ---------------------------------------------------------------------------
# The attention block against the reference, on the same weights
# ---------------------------------------------------------------------------


def _weights(d_model, a):
    shapes = {"wq": (d_model, a.q_dim), "wk": (d_model, a.kv_dim),
              "wv": (d_model, a.kv_dim), "wo": (a.q_dim, d_model)}
    w = {n: (RNG.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for n, s in shapes.items()}
    jp = {n: {"w": jnp.asarray(a_)} for n, a_ in w.items()}
    tp = SimpleNamespace(**{n: torch.from_numpy(a_) for n, a_ in w.items()})
    return jp, tp


CFG = dataclasses.replace(gemma2_9b.reduced(), dtype="float32")
JCFG = dataclasses.replace(jgemma.reduced(), dtype="float32")


@pytest.mark.parametrize("causal,window,cap,kv_len", [
    (True, 0, 0.0, None), (True, 5, 50.0, None), (False, 0, 0.0, None),
    (True, 0, 50.0, 20)])
def test_direct_attention_matches_reference(causal, window, cap, kv_len):
    q, k, v = _qkv(2, 4, 2, 12, 24, 16)
    want = jattn.direct_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, cap=cap, kv_len=kv_len)
    got = tattn.direct_attention(*_t(q, k, v), causal=causal, window=window,
                                 cap=cap, kv_len=kv_len)
    assert_allclose_dtype(got, want, scale=10)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_matches_reference(per_slot, window):
    k, v = (RNG.standard_normal((3, 2, 20, 16)).astype(np.float32)
            for _ in range(2))
    q = RNG.standard_normal((3, 4, 1, 16)).astype(np.float32)
    length = np.asarray([5, 20, 11] if per_slot else 9, np.int32)
    want = jattn.decode_attention(
        jnp.asarray(q), jattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(length)),
        window=window, cap=50.0)
    got = tattn.decode_attention(
        torch.from_numpy(q), tattn.KVCache(*_t(k, v, length)),
        window=window, cap=50.0)
    assert_allclose_dtype(got, want, scale=10)


@pytest.mark.parametrize("window,impl,s", [
    (0, "auto", 12), (16, "direct", 12), (5, "torch", 40)])
def test_attention_block_prefill_and_decode(window, impl, s, monkeypatch):
    a = CFG.attention
    jp, tp = _weights(CFG.d_model, a)
    x = RNG.standard_normal((2, s, CFG.d_model)).astype(np.float32)
    if s > 32:   # take the torch tier's long path at a small size
        monkeypatch.setattr(tattn, "DIRECT_MAX_SEQ", 32)
    jout, jcache = jattn.attention_block(jp, jnp.asarray(x), JCFG.attention,
                                         layer_window=window,
                                         make_cache=True, cache_size=s + 4)
    tout, tcache = tattn.attention_block(tp, torch.from_numpy(x), a,
                                         layer_window=window,
                                         make_cache=True, cache_size=s + 4,
                                         impl=impl)
    assert_allclose_dtype(tout, jout, scale=10)
    assert_allclose_dtype(tcache.k, jcache.k, scale=10)
    assert_allclose_dtype(tcache.v, jcache.v, scale=10)
    assert int(tcache.length) == int(jcache.length) == s

    # decode, uniform (scalar) length, then per-slot lengths
    x1 = RNG.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
    jout, jc = jattn.attention_block(jp, jnp.asarray(x1), JCFG.attention,
                                     layer_window=window, cache=jcache)
    tout, tc = tattn.attention_block(tp, torch.from_numpy(x1), a,
                                     layer_window=window, cache=tcache)
    assert_allclose_dtype(tout, jout, scale=10)
    assert_allclose_dtype(tc.k, jc.k, scale=10)
    assert int(tc.length) == int(jc.length) == s + 1

    lens = np.asarray([s - 3, s + 1], np.int32)
    jout, jc = jattn.attention_block(
        jp, jnp.asarray(x1), JCFG.attention, layer_window=window,
        cache=jattn.KVCache(jc.k, jc.v, jnp.asarray(lens)))
    tout, tc = tattn.attention_block(
        tp, torch.from_numpy(x1), a, layer_window=window,
        cache=tattn.KVCache(tc.k, tc.v, torch.from_numpy(lens)))
    assert_allclose_dtype(tout, jout, scale=10)
    assert_allclose_dtype(tc.k, jc.k, scale=10)
    assert_allclose_dtype(tc.v, jc.v, scale=10)
    assert tc.length.tolist() == np.asarray(jc.length).tolist()
