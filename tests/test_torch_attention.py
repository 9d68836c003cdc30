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
from test_torch_kernels import _round_to_zero, _tf32_rna

torch.set_num_threads(2)

RNG = np.random.default_rng(13)
NEG = np.float32(k5.NEG_INF)
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
    by_shape = dict(k5.flash_attention.by_shape)
    assert_allclose_dtype(
        ops.flash_attention(*_t(q, k, v), causal=causal, window=window,
                            softcap=cap, backend="torch"), want, scale=20)
    assert_allclose_dtype(
        k5.flash_attention(*_t(q, k, v), causal=causal, window=window,
                           softcap=cap), want, scale=20)
    assert k5.flash_attention.launches == n
    assert dict(k5.flash_attention.by_shape) == by_shape


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
        # TF32 hi/lo images of q (64 rows) and of one 32-key K or V^T tile,
        # and the raw f32 tile cp.async brings in; two CTAs an SM below 256
        dp = -(-d // 32) * 32
        assert (tq, tk, heads) == (64, 32, 1)
        assert need == 1024 + (2 * 64 * dp + 2 * 32 * dp + 32 * d) * 4
        if d < 256:
            assert 2 * (need + 1024) <= H100_SMEM_PER_SM


# ---------------------------------------------------------------------------
# The f32 kernel's arithmetic, emulated: why 3xTF32 and why the control fails
# ---------------------------------------------------------------------------

#: chip_smoke.py's f32 limits for K5: each row's largest error over that
#: row's largest magnitude, and the relative Frobenius error
F32_ROW_LIMIT, F32_FRO_LIMIT = 3e-5, 3e-6


def _split(a):
    hi = _tf32_rna(a)
    return hi, _tf32_rna(a - hi)


def _tc_product(a, b, terms):
    """``a @ b.T`` on the tensor cores as tf32x3_kernel issues it: per k8
    step the exact products A_lo B_hi, A_hi B_lo, A_hi B_hi (or A_hi B_hi
    alone), each added into a fresh accumulator rounding toward zero."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in pairs:
            t = x[:, k0:k0 + 8].astype(np.float64) @ \
                y[:, k0:k0 + 8].astype(np.float64).T
            acc = _round_to_zero(acc.astype(np.float64) + t)
    return acc


def _emulate_tf32x3(q, k, v, *, causal, window, cap, terms):
    """tf32x3_kernel's f32 arithmetic in numpy, for B = 1: 64-row q tiles,
    32-key KV tiles (only those with an unmasked key), S per 64 columns of
    D in a fresh accumulator with the partials added to nearest (at D = 256
    two warpgroups' sums of two slices each, added last), tanhf / expf in
    f32, P V per tile and 64 / 32 output columns in a fresh accumulator,
    O = fma(O, alpha, partial)."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    f32 = np.float32
    out = np.zeros(q.shape, f32)
    nc = 64 if d == 256 else min(d, 32)
    for h in range(hq):
        kh, vh = k[0, h // (hq // hkv)], v[0, h // (hq // hkv)]
        for q0 in range(0, sq, 64):
            nq = min(64, sq - q0)
            qs = np.zeros((64, d), f32)
            qs[:nq] = q[0, h, q0:q0 + nq] * f32(d ** -0.5)
            q_lo = sk - sq + q0
            k_end = min(sk, q_lo + nq) if causal else sk
            k_beg = max(0, q_lo - window + 1) if window > 0 else 0
            k_beg -= k_beg % 32
            m = np.full(64, NEG, f32)
            l_sum = np.zeros(64, f32)
            o = np.zeros((64, d), f32)
            for k0 in range(k_beg, k_end, 32):
                kt, vt = np.zeros((32, d), f32), np.zeros((32, d), f32)
                n = min(32, sk - k0)
                kt[:n], vt[:n] = kh[k0:k0 + n], vh[k0:k0 + n]
                parts = [_tc_product(qs[:, c:c + 64], kt[:, c:c + 64], terms)
                         for c in range(0, d, 64)]
                if d == 256:
                    s = (parts[0] + parts[1]) + (parts[2] + parts[3])
                else:
                    s = parts[0]
                    for p_ in parts[1:]:
                        s = s + p_
                if cap > 0:
                    s = f32(cap) * np.tanh(s / f32(cap))
                qpos = (q_lo + np.arange(64))[:, None]
                kpos = (k0 + np.arange(32))[None, :]
                ok = kpos < sk
                if causal:
                    ok = ok & (kpos <= qpos)
                if window > 0:
                    ok = ok & (kpos > qpos - window)
                s = np.where(ok, s, NEG).astype(f32)
                m_new = np.maximum(m, s.max(1))
                m_safe = np.where(m_new <= NEG / 2, f32(0), m_new)
                alpha = np.where(m <= NEG / 2, f32(0),
                                 np.exp(m - m_safe)).astype(f32)
                p = np.exp(s - m_safe[:, None]).astype(f32)
                l_sum = (l_sum * alpha + p.sum(1, dtype=f32)).astype(f32)
                m = m_new
                for c in range(0, d, nc):
                    part = _tc_product(p, vt[:, c:c + nc].T.copy(), terms)
                    o[:, c:c + nc] = (o[:, c:c + nc].astype(np.float64)
                                      * alpha[:, None] + part).astype(f32)
            denom = np.where(l_sum == 0, f32(1), l_sum)
            out[0, h, q0:q0 + nq] = (o / denom[:, None])[:nq]
    return out


@pytest.mark.parametrize("d,window", [(256, 0), (128, 100)])
def test_three_tf32_products_hold_the_f32_limits(d, window):
    """Why K5's f32 kernel takes three TF32 products per k8 step with fresh
    accumulators, and why chip_smoke.py's one-product control must fail:
    on causal attention with a softcap of 50 over 300 keys (10 KV tiles),
    the emulated 3xTF32 kernel stays within the f32 per-row and Frobenius
    limits of the plain version, and one TF32 product misses both."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal(shp).astype(np.float32)
               for shp in ((1, 2, 300, d), (1, 1, 300, d), (1, 1, 300, d)))
    kw = dict(causal=True, window=window, cap=50.0)
    want = k5.flash_attention_plain(*_t(q, k, v), causal=True,
                                    window=window, softcap=50.0).numpy()

    def errs(got):
        a, b = got.reshape(-1, d), want.reshape(-1, d)
        row = (np.abs(a - b).max(1) / np.abs(b).max(1)).max()
        return row, np.linalg.norm(a - b) / np.linalg.norm(b)

    row3, fro3 = errs(_emulate_tf32x3(q, k, v, terms=3, **kw))
    row1, fro1 = errs(_emulate_tf32x3(q, k, v, terms=1, **kw))
    assert row3 <= F32_ROW_LIMIT and fro3 <= F32_FRO_LIMIT
    assert row1 > F32_ROW_LIMIT and fro1 > F32_FRO_LIMIT


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
