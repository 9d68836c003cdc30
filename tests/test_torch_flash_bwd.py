"""K5's backward kernels' design, checked on the CPU.

The kernels (``csrc/flash_attention.cu``: bf16 ``wgmma_bwd_dq_kernel`` and
``wgmma_bwd_dkdv_kernel``, f32 ``bwd_dq_kernel`` and ``bwd_dkdv_kernel``)
run only on a card, where tests/test_torch_cuda.py holds them against
``flash_attention_bwd_plain``.  Here: their shared memory and tiles as
``kernels/flash_attention.py`` mirrors them; the bf16 kernels' arithmetic
(P and dS rounded to bf16 before the products, everything else f32),
emulated, against the plain version within the card's bf16 limits, with a
control that must fail them; and the tile schedules (which KV tiles the dq
pass visits, which q tiles the dk/dv pass visits, which tiles skip the
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


@pytest.mark.parametrize("d", k5.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 3, 4])
def test_flash_bwd_shared_memory_and_tiles(d, dtype, group):
    """Both passes fit the H100's 227 KB per block at every head dim and
    group.  bf16 tiles are wgmma-shaped: 64 rows (one M) a warpgroup,
    keys and q rows in k16 steps, every tile in whole 1024-byte swizzle
    atoms; at d = 256 an even group puts two heads in a dq CTA and the
    dk/dv CTA splits D between two warpgroups; below d = 256 two CTAs of
    each bf16 pass share an SM (the card reserves 1 KB per block)."""
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
        assert (rows, keys, heads) == (64, 32, 1) and (kv, tq, wgs) == \
            (32, 64, 1)
        common = 2 * d * 33 + 2 * 64 * d + 2 * 64
        assert need == {"dq": 4 * (common + 64 * 33),
                        "dkdv": 4 * (common + 2 * 64 * 33)}
    # the bf16 passes share an SM two CTAs at a time below d = 256; the f32
    # dk/dv pass's P and dS tiles leave it one CTA an SM from d = 128
    two = {"dq": d < 256,
           "dkdv": d < (256 if dtype == torch.bfloat16 else 128)}
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


def _dkdv_tiles(sq, sk, n, causal, window):
    """The dk/dv pass: per 64-key tile, the q tiles it visits as (q0,
    whole) -- ``wgmma_bwd_dkdv_kernel``'s i_lo / i_hi / ntq and its
    ``whole`` test."""
    out = {}
    k_valid = min(n, sk)
    for k0 in range(0, sk, 64):
        i_lo, i_hi = 0, -1
        if k0 < k_valid:
            k_last = min(k0 + 64, k_valid) - 1
            i_lo = max(0, k0 - (n - sq)) if causal else 0
            i_hi = min(sq - 1, k_last + window - 1 - (n - sq)) \
                if window > 0 else sq - 1
        t_lo = i_lo // 64
        ntq = 0 if i_hi < i_lo else i_hi // 64 - t_lo + 1
        tiles = []
        for t in range(t_lo, t_lo + ntq):
            q0 = 64 * t
            q_lo = n - sq + q0
            tiles.append((q0, k0 + 64 <= k_valid and q0 + 64 <= sq and
                          (not causal or k0 + 63 <= q_lo) and
                          (window <= 0 or k0 > q_lo + 63 - window)))
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
    dq pass visits (for 32- and 64-key tiles) and in exactly one that the
    dk/dv pass visits, and no tile either pass treats as whole (no
    per-element mask) holds a masked pair, a key past Sk or a row past
    Sq."""
    keep = _mask(sq, sk, n, causal, window).numpy()
    for tk in (32, 64):
        seen = np.zeros((sq, sk), int)
        for q0, tiles in _dq_tiles(sq, sk, n, causal, window, tk).items():
            for k0, whole in tiles:
                seen[q0:q0 + 64, k0:k0 + tk] += 1
                if whole:   # rows past Sq are neither masked nor stored
                    assert k0 + tk <= sk and \
                        keep[q0:q0 + 64, k0:k0 + tk].all()
        assert (seen[keep] == 1).all()
    seen = np.zeros((sq, sk), int)
    for k0, tiles in _dkdv_tiles(sq, sk, n, causal, window).items():
        for q0, whole in tiles:
            seen[q0:q0 + 64, k0:k0 + 64] += 1
            if whole:
                assert q0 + 64 <= sq and k0 + 64 <= sk and \
                    keep[q0:q0 + 64, k0:k0 + 64].all()
    assert (seen[keep] == 1).all()
