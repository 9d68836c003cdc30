"""K5's backward kernels' design, checked on the CPU.

The kernels (``csrc/flash_attention.cu``: bf16 ``wgmma_bwd_dq_kernel`` and
``wgmma_bwd_dkdv_kernel``, f32 ``tf32x3_bwd_dq_kernel`` and
``tf32x3_bwd_dkdv_kernel``) run only on a card, where
tests/test_torch_cuda.py holds them against ``flash_attention_bwd_plain``.
Here: their shared memory and tiles as ``kernels/flash_attention.py``
mirrors them; the bf16 kernels' arithmetic (P and dS rounded to bf16
before the products, everything else f32) and the f32 kernels' (3xTF32
products, fresh accumulators per slice of D and per tile added in f32),
emulated, against the plain version within the card's limits, with
controls that must fail them; and the tile schedules (which KV tiles the
dq pass visits, which q tiles the dk/dv pass visits, which tiles skip the
per-element masks), emulated, against the masks.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as k5

torch.set_num_threads(2)

#: shared memory of one H100 SM; the card reserves 1 KB of it per block
H100_SMEM_PER_SM = 233472
#: chip_smoke.py's bf16 limits for K5's backward (BWD_ROW_LIMIT,
#: BWD_FRO_LIMIT, BWD_ROW_FLOOR): each row's largest error over that row's
#: largest magnitude floored at 1% of the tensor's, and the relative
#: Frobenius error, the largest over dq, dk and dv
BF16_ROW_LIMIT, BF16_FRO_LIMIT, ROW_FLOOR = 2e-2, 1e-2, 1e-2
#: the same limits in f32
F32_ROW_LIMIT, F32_FRO_LIMIT = 1e-4, 1e-5


@pytest.mark.parametrize("d", k5.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 3, 4])
def test_flash_bwd_shared_memory_and_tiles(d, dtype, group):
    """Both passes fit the H100's 227 KB per block at every head dim and
    group.  bf16 tiles are wgmma-shaped: 64 rows (one M) a warpgroup,
    keys and q rows in k16 steps, every tile in whole 1024-byte swizzle
    atoms; at d = 256 an even group puts two heads in a dq CTA and the
    dk/dv CTA splits D between two warpgroups; below d = 256 two CTAs of
    each bf16 pass share an SM (the card reserves 1 KB per block).  f32
    tiles are 3xTF32-wgmma-shaped: 64 rows (one M) of the resident tile,
    KV and q tiles in k8 steps of 16 (d = 256), 32 or 64 rows, two
    warpgroups a CTA; qs and dO (K and V) raw, the streamed tile and the
    dS (P^T, dS^T) tile as TF32 hi and lo images of whole 1024-byte
    swizzle atoms; below d = 128 (the dk/dv pass: at d = 16) they leave
    room for a second CTA on an SM."""
    need = k5.bwd_smem_bytes(d, dtype, group)
    t = k5.bwd_tiles(d, dtype, group)
    assert set(need) == set(t) == {"dq", "dkdv"}
    for n in need.values():
        assert 0 < n <= k5._H100_SMEM_OPTIN
    rows, keys, heads = t["dq"]
    kv, tq, wgs = t["dkdv"]
    if dtype == torch.bfloat16:
        assert rows == kv == 64 and keys % 16 == 0 and tq % 16 == 0
        for tile_rows in (rows, keys, kv, tq):
            assert tile_rows * d * 2 % 1024 == 0
        assert heads == (2 if d == 256 and group % 2 == 0 else 1)
        assert keys == (32 if d == 256 else 64)
        assert wgs == (2 if d == 256 else 1) and d // wgs <= 128
        assert need["dq"] == 1024 + (2 * heads * 64 * d + 4 * keys * d) * 2 \
            + heads * 64 * 4
        assert need["dkdv"] == 1024 + (2 * 64 * d + 4 * tq * d) * 2 + 4 * tq * 4
    else:
        assert (rows, heads, kv, wgs) == (64, 1, 64, 2)
        assert keys == (16 if d == 256 else 32)
        assert tq == {256: 16, 128: 32}.get(d, 64)
        dp = -(-d // 32) * 32   # rows of d in 32-column swizzle regions
        for tile_rows in (rows, keys, kv, tq):
            assert tile_rows % 8 == 0 and tile_rows * dp * 4 % 1024 == 0
        res = 2 * 64 * d   # the resident tiles, raw
        assert need["dq"] == 1024 + 4 * (res + 4 * keys * dp
                                         + 2 * 64 * max(32, keys) + 2 * 64)
        assert need["dkdv"] == 1024 + 4 * (res + 4 * tq * dp
                                           + 4 * 64 * max(32, tq) + 2 * tq)
    # the bf16 passes share an SM two CTAs at a time below d = 256; of the
    # f32 passes the dq pass does below d = 128, the dk/dv pass at d = 16
    if dtype == torch.bfloat16:
        two = {"dq": d < 256, "dkdv": d < 256}
    else:
        two = {"dq": d < 128, "dkdv": d == 16}
    for name, n in need.items():
        assert (2 * (n + 1024) <= H100_SMEM_PER_SM) == two[name]


# ---------------------------------------------------------------------------
# The bf16 kernels' arithmetic, emulated
# ---------------------------------------------------------------------------


def _mask(sq, sk, n, causal, window):
    """(sq, sk) bool: query i (position n - sq + i) sees key j."""
    qpos = n - sq + torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    m = (kpos < n).expand(sq, sk)
    if causal:
        m = m & (kpos <= qpos)
    if window > 0:
        m = m & (kpos > qpos - window)
    return m


def _emulated_bwd(q, k, v, out, lse, dout, kv_len, *, causal, window, cap,
                  jacobian=True):
    """(dq, dk, dv) in the bf16 kernels' arithmetic: qs = q * D^-0.5
    rounded to bf16; S = qs K^T and dP = dO V^T of bf16 values in f32;
    softcap, P = exp(S - lse), delta = rowsum(dO O) and dS = P (dP -
    delta)(1 - (S / cap)^2) in f32; P and dS rounded to bf16 before dV =
    P^T dO, dK = dS^T qs and dQ = dS K D^-0.5, accumulated in f32 and
    rounded once.  ``jacobian=False`` drops the softcap's Jacobian: a
    control that must fail the limits."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qs = (q * scale).float()
    dq = torch.empty((b, hq, sq, d))
    dk = torch.zeros((b, hkv, sk, d))
    dv = torch.zeros((b, hkv, sk, d))
    for bi in range(b):
        keep = _mask(sq, sk, int(kv_len[bi]), causal, window)
        for h in range(hq):
            kh, vh = k[bi, h // g].float(), v[bi, h // g].float()
            do = dout[bi, h].float()
            s = qs[bi, h] @ kh.T
            jac = torch.ones_like(s)
            if cap > 0:
                th = torch.tanh(s / cap)
                s = cap * th
                if jacobian:
                    jac = 1.0 - th * th
            p = torch.where(keep, torch.exp(torch.where(
                keep, s - lse[bi, h, :, None], 0.0)), 0.0)
            delta = (do * out[bi, h].float()).sum(-1, keepdim=True)
            ds = p * (do @ vh.T - delta) * jac
            pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
            dq[bi, h] = dsb @ kh * scale
            dk[bi, h // g] += dsb.T @ qs[bi, h]
            dv[bi, h // g] += pb.T @ do
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _rel_errs(got, want):
    """(largest per-row error over the row's largest magnitude floored at
    ROW_FLOOR of the tensor's, relative Frobenius error), each the largest
    over the three gradients (chip_smoke.py ``bwd_rel_errs``)."""
    row = fro = 0.0
    for a, w in zip(got, want):
        a, w = a.float().flatten(0, -2), w.float().flatten(0, -2)
        diff = (a - w).abs().amax(-1)
        mag = w.abs().amax(-1).clamp_min(ROW_FLOOR * w.abs().max().item())
        row = max(row, (diff / mag.clamp_min(1e-30)).max().item())
        fro = max(fro, ((a - w).norm() / w.norm().clamp_min(1e-30)).item())
    return row, fro


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,kv_len", [
    (1, 4, 2, 192, 192, 64, True, 0, None),
    (2, 4, 2, 100, 170, 128, True, 70, (150, 170)),
])
def test_bf16_backward_arithmetic_fits_the_limits(b, hq, hkv, sq, sk, d,
                                                  causal, window, kv_len):
    """With q and k of std 3 and softcap 50 (chip_smoke.py's
    BWD_INPUT_SCALE: the logits reach where the cap bends them), the bf16
    kernels' rounding of P and dS keeps every gradient within the card's
    bf16 limits of the plain version; the same arithmetic without the
    softcap's Jacobian exceeds both, so the limits see a wrong dS."""
    rng = np.random.default_rng(29)
    q, k = (torch.from_numpy(rng.standard_normal(shp).astype(np.float32)
                             * 3.0).bfloat16()
            for shp in ((b, hq, sq, d), (b, hkv, sk, d)))
    v, dout = (torch.from_numpy(rng.standard_normal(shp).astype(
        np.float32)).bfloat16() for shp in ((b, hkv, sk, d), (b, hq, sq, d)))
    kvl = torch.tensor(kv_len or (sk,) * b, dtype=torch.int32)
    kw = dict(causal=causal, window=window, softcap=50.0)
    out, lse = k5.flash_attention_plain(q, k, v, kvl, return_lse=True, **kw)
    want = k5.flash_attention_bwd_plain(q, k, v, out, lse, dout, kvl, **kw)
    opts = dict(causal=causal, window=window, cap=50.0)
    got = _emulated_bwd(q, k, v, out, lse, dout, kvl, **opts)
    row, fro = _rel_errs(got, want)
    assert row <= BF16_ROW_LIMIT and fro <= BF16_FRO_LIMIT, (row, fro)
    c_row, c_fro = _rel_errs(
        _emulated_bwd(q, k, v, out, lse, dout, kvl, jacobian=False, **opts),
        want)
    assert c_row > BF16_ROW_LIMIT and c_fro > BF16_FRO_LIMIT, (c_row, c_fro)


# ---------------------------------------------------------------------------
# The f32 kernels' 3xTF32 arithmetic, emulated
# ---------------------------------------------------------------------------


def _tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, by bit masks: cvt.rna.tf32.f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_mm(a, b, terms, out_dtype=torch.float32):
    """a (m, K) @ b (n, K)^T as one fresh tensor-core accumulator: each
    operand split into hi = rna(x) and lo = rna(x - hi); 3xTF32 (terms =
    3) adds A_lo B_hi + A_hi B_lo + A_hi B_hi, lo * lo dropped, one TF32
    product (terms = 1) A_hi B_hi; the products exact, the sum rounded
    once to f32 (and held in ``out_dtype``)."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    out = ah @ bh.T
    if terms == 3:
        out = out + al @ bh.T + ah @ bl.T
    return out.float().to(out_dtype)


def _emulated_f32_bwd(q, k, v, out, lse, dout, kv_len, *, causal, window,
                      cap, terms=3):
    """(dq, dk, dv) in the f32 kernels' arithmetic, their tiles as
    ``bwd_tiles`` gives them: S = qs K^T and dP = dO V^T from a fresh
    accumulator per 32 columns of D (the dq pass's four k8 steps), the
    partials added in f64 and rounded once; softcap, P = exp(S - lse) and
    dS in f32, delta = rowsum(dO O) summed in f64; dQ from a fresh
    accumulator per KV tile, dK and dV per q tile, each added in f32;
    every product ``_tf32_mm``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    t = k5.bwd_tiles(d, torch.float32)
    tk, tq = t["dq"][1], t["dkdv"][1]
    scale = d ** -0.5

    def summed(parts):
        total = None
        for p in parts:
            total = p if total is None else total + p
        return total

    qs = q * scale
    dq = torch.zeros((b, hq, sq, d))
    dk = torch.zeros((b, hkv, sk, d))
    dv = torch.zeros((b, hkv, sk, d))
    for bi in range(b):
        keep = _mask(sq, sk, int(kv_len[bi]), causal, window)
        for h in range(hq):
            kh, vh, do = k[bi, h // g], v[bi, h // g], dout[bi, h]
            qh = qs[bi, h]
            s, dp = (summed(_tf32_mm(x[:, c:c + 32], y[:, c:c + 32], terms,
                                     torch.float64)
                            for c in range(0, d, 32)).float()
                     for x, y in ((qh, kh), (do, vh)))
            jac = torch.ones_like(s)
            if cap > 0:
                th = torch.tanh(s / cap)
                s = cap * th
                jac = 1.0 - th * th
            p = torch.where(keep, torch.exp(torch.where(
                keep, s - lse[bi, h, :, None], 0.0)), 0.0)
            delta = (do.double() * out[bi, h].double()).sum(
                -1, keepdim=True).float()
            ds = p * (dp - delta) * jac
            dq[bi, h] = summed(_tf32_mm(ds[:, c:c + tk], kh[c:c + tk].T,
                                        terms)
                               for c in range(0, sk, tk)) * scale
            for r in range(0, sq, tq):
                dk[bi, h // g] += _tf32_mm(ds[r:r + tq].T, qh[r:r + tq].T,
                                           terms)
                dv[bi, h // g] += _tf32_mm(p[r:r + tq].T, do[r:r + tq].T,
                                           terms)
    return dq, dk, dv


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,kv_len", [
    (1, 4, 2, 192, 192, 64, True, 0, 50.0, None),
    (2, 4, 2, 100, 170, 128, True, 70, 50.0, (150, 170)),
    (1, 2, 1, 130, 130, 256, True, 0, 50.0, None),
    (1, 8, 2, 128, 128, 128, True, 0, 0.0, None),
])
def test_f32_backward_arithmetic_fits_the_limits(b, hq, hkv, sq, sk, d,
                                                 causal, window, cap,
                                                 kv_len):
    """With q and k of std 3 (chip_smoke.py's BWD_INPUT_SCALE), softcap 50
    or none, the f32 kernels' 3xTF32 products and fresh accumulators keep
    every gradient within the card's f32 limits of the plain version, which
    the card's checks evaluate in f64 (so here too); the same tiles with
    one TF32 product instead of three (the kernels' terms=1 control) exceed
    both, so the limits see TF32 rounding."""
    rng = np.random.default_rng(29)
    q, k = (torch.from_numpy(rng.standard_normal(shp).astype(np.float32)
                             * 3.0)
            for shp in ((b, hq, sq, d), (b, hkv, sk, d)))
    v, dout = (torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
               for shp in ((b, hkv, sk, d), (b, hq, sq, d)))
    kvl = torch.tensor(kv_len or (sk,) * b, dtype=torch.int32)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = k5.flash_attention_plain(q, k, v, kvl, return_lse=True, **kw)
    want = k5.flash_attention_bwd_plain(
        *(t.double() for t in (q, k, v, out)), lse, dout.double(), kvl, **kw)
    opts = dict(causal=causal, window=window, cap=cap)
    row, fro = _rel_errs(
        _emulated_f32_bwd(q, k, v, out, lse, dout, kvl, **opts), want)
    assert row <= F32_ROW_LIMIT and fro <= F32_FRO_LIMIT, (row, fro)
    c_row, c_fro = _rel_errs(
        _emulated_f32_bwd(q, k, v, out, lse, dout, kvl, terms=1, **opts),
        want)
    assert c_row > F32_ROW_LIMIT and c_fro > F32_FRO_LIMIT, (c_row, c_fro)


def test_backward_terms_are_checked():
    """``terms`` selects the f32 kernels' arithmetic on a card: 3 (3xTF32,
    the default) or the one-TF32-product control 1, which the plain
    version on the CPU does not compute and bf16 does not take."""
    q = torch.randn((1, 2, 8, 16))
    k = torch.randn((1, 1, 8, 16))
    out, lse = k5.flash_attention_plain(q, k, k, return_lse=True)
    want = k5.flash_attention_bwd_plain(q, k, k, out, lse, q)
    got = k5.flash_attention_bwd(q, k, k, out, lse, q, terms=3)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    for terms, dtype in ((1, torch.float32), (2, torch.float32),
                         (1, torch.bfloat16)):
        qt, kt = q.to(dtype), k.to(dtype)
        with pytest.raises(ValueError, match="terms"):
            k5.flash_attention_bwd(qt, kt, kt, out.to(dtype), lse, qt,
                                   terms=terms)


# ---------------------------------------------------------------------------
# The tile schedules, emulated
# ---------------------------------------------------------------------------


def _dq_tiles(sq, sk, n, causal, window, tk):
    """The dq pass (and the forward): per 64-row q tile, the KV tiles it
    visits as (k0, whole) -- ``wgmma_bwd_dq_kernel``'s k_beg / ntiles and
    its ``whole`` test."""
    out = {}
    for q0 in range(0, sq, 64):
        nq = min(64, sq - q0)
        q_lo = n - sq + q0
        k_end = min(n, sk)
        if causal:
            k_end = min(k_end, q_lo + nq)
        k_beg = max(0, q_lo - window + 1) if window > 0 else 0
        k_beg -= k_beg % tk
        ntiles = (k_end - k_beg + tk - 1) // tk if k_end > k_beg else 0
        out[q0] = [(k0, k0 + tk <= min(n, sk) and
                    (not causal or k0 + tk - 1 <= q_lo) and
                    (window <= 0 or k0 > q_lo + 63 - window))
                   for k0 in range(k_beg, k_beg + ntiles * tk, tk)]
    return out


def _dkdv_tiles(sq, sk, n, causal, window, tq=64):
    """The dk/dv pass: per 64-key tile, the q tiles of ``tq`` rows it visits
    as (q0, whole) -- ``wgmma_bwd_dkdv_kernel``'s and
    ``tf32x3_bwd_dkdv_kernel``'s i_lo / i_hi / ntq and their ``whole``
    test."""
    out = {}
    k_valid = min(n, sk)
    for k0 in range(0, sk, 64):
        i_lo, i_hi = 0, -1
        if k0 < k_valid:
            k_last = min(k0 + 64, k_valid) - 1
            i_lo = max(0, k0 - (n - sq)) if causal else 0
            i_hi = min(sq - 1, k_last + window - 1 - (n - sq)) \
                if window > 0 else sq - 1
        t_lo = i_lo // tq
        ntq = 0 if i_hi < i_lo else i_hi // tq - t_lo + 1
        tiles = []
        for t in range(t_lo, t_lo + ntq):
            q0 = tq * t
            q_lo = n - sq + q0
            tiles.append((q0, k0 + 64 <= k_valid and q0 + tq <= sq and
                          (not causal or k0 + 63 <= q_lo) and
                          (window <= 0 or k0 > q_lo + tq - 1 - window)))
        out[k0] = tiles
    return out


@pytest.mark.parametrize("sq,sk,n,causal,window", [
    (300, 300, 300, True, 0), (300, 300, 300, True, 100),
    (100, 300, 250, True, 64), (64, 192, 50, True, 0),
    (96, 96, 96, False, 0), (17, 17, 17, True, 4), (1, 300, 300, True, 0),
    (130, 130, 130, False, 0), (200, 260, 0, True, 0),
    (256, 256, 256, True, 70), (150, 170, 170, True, 0),
])
def test_backward_schedules_cover_every_unmasked_pair(sq, sk, n, causal,
                                                      window):
    """Each unmasked (query, key) pair lies in exactly one tile that the
    dq pass visits (for the 16-, 32- and 64-key tiles of both dtypes) and
    in exactly one that the dk/dv pass visits (64 keys by 16, 32 or 64 q
    rows), and no tile either pass treats as whole (no per-element mask)
    holds a masked pair, a key past Sk or a row past Sq."""
    keep = _mask(sq, sk, n, causal, window).numpy()
    for tk in (16, 32, 64):
        seen = np.zeros((sq, sk), int)
        for q0, tiles in _dq_tiles(sq, sk, n, causal, window, tk).items():
            for k0, whole in tiles:
                seen[q0:q0 + 64, k0:k0 + tk] += 1
                if whole:   # rows past Sq are neither masked nor stored
                    assert k0 + tk <= sk and \
                        keep[q0:q0 + 64, k0:k0 + tk].all()
        assert (seen[keep] == 1).all()
    for tq in (16, 32, 64):
        seen = np.zeros((sq, sk), int)
        for k0, tiles in _dkdv_tiles(sq, sk, n, causal, window, tq).items():
            for q0, whole in tiles:
                seen[q0:q0 + tq, k0:k0 + 64] += 1
                if whole:
                    assert q0 + tq <= sq and k0 + 64 <= sk and \
                        keep[q0:q0 + tq, k0:k0 + 64].all()
        assert (seen[keep] == 1).all()
