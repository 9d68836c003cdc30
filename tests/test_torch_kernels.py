"""The kernels' plain versions against the JAX package's Pallas kernels.

``seg_agg_plain`` / ``fused_agg_combine_plain`` (what the CUDA kernels are
held against on the card) must match ``seg_agg_blocked`` /
``fused_agg_combine_blocked`` run in interpret mode, as tests/test_kernels.py
runs them, and the ``ref.py`` oracles of both packages.  The Pallas kernels
take pre-gathered rows, so the rows are gathered here with numpy; the
port's kernels gather ``x`` themselves.  The CUDA kernels need a card:
tests/test_torch_cuda.py holds them against these plain versions there.
"""

import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA, reduced_graph
from repro.core.dataflow import block_graph as jblock_graph
from repro.graph.datasets import make_synthetic_graph
from repro.kernels import ref as jref
from repro.kernels.fused_agg_combine import fused_agg_combine_blocked
from repro.kernels.seg_agg import seg_agg_blocked
from repro_torch.kernels import fused_agg_combine as k2
from repro_torch.kernels import ref as tref
from repro_torch.kernels import seg_agg as k1

torch.set_num_threads(2)

RNG = np.random.default_rng(7)
GRAPH = make_synthetic_graph(reduced_graph(CORA, 512, 64))


def _layout(kind, tile_m):
    """(src, dstl, mask) numpy arrays: the reference's blocked layout of a
    reduced Cora ("graph"), or random slots with unsorted local rows and
    ~20% pad slots ("random"), as tests/test_kernels.py draws them."""
    if kind == "graph":
        bg = jblock_graph(GRAPH, tile_m)
        return (np.asarray(bg.src), np.asarray(bg.dstl), np.asarray(bg.mask),
                GRAPH.num_vertices)
    nblocks, emax, v = 3, 40, 97
    return (RNG.integers(0, v, (nblocks, emax)).astype(np.int32),
            RNG.integers(0, tile_m, (nblocks, emax)).astype(np.int32),
            (RNG.random((nblocks, emax)) < 0.8).astype(np.float32), v)


def _pallas_inputs(x, src, dstl, mask, tile_e=8):
    """Rows gathered on the host and emax padded to a tile_e multiple."""
    nblocks, emax = src.shape
    pad = -emax % tile_e
    rows = np.pad(x[src], ((0, 0), (0, pad), (0, 0)))
    return (rows, np.pad(dstl, ((0, 0), (0, pad))),
            np.pad(mask, ((0, 0), (0, pad))))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("kind,tile_m,f", [("graph", 32, 7), ("graph", 128, 64),
                                           ("random", 16, 33)])
def test_seg_agg_plain_matches_pallas_kernel(kind, tile_m, f):
    src, dstl, mask, v = _layout(kind, tile_m)
    x = RNG.standard_normal((v, f)).astype(np.float32)
    rows, seg_p, mask_p = _pallas_inputs(x, src, dstl, mask)
    want = seg_agg_blocked(rows, seg_p, mask_p, tile_m=tile_m,
                           tile_e=rows.shape[1], interpret=True)
    got = k1.seg_agg_plain(*_t(x, src, dstl, mask), tile_m=tile_m)
    assert got.shape == tuple(want.shape)
    assert_allclose_dtype(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,tile_m", [("graph", 32), ("random", 16)])
def test_seg_agg_plain_matches_oracles_with_weight(kind, tile_m):
    src, dstl, mask, v = _layout(kind, tile_m)
    nblocks, emax = src.shape
    x = RNG.standard_normal((v, 24)).astype(np.float32)
    weight = RNG.random((nblocks, emax)).astype(np.float32)
    gseg = (dstl + np.arange(nblocks)[:, None] * tile_m).reshape(-1)
    rows = (x[src] * weight[..., None]).reshape(-1, 24)
    want_j = jref.seg_agg_ref(rows, gseg, mask.reshape(-1), nblocks * tile_m)
    want_t = tref.seg_agg_ref(*_t(rows, gseg, mask.reshape(-1)),
                              nblocks * tile_m)
    got = k1.seg_agg_plain(*_t(x, src, dstl, mask, weight), tile_m=tile_m)
    assert_allclose_dtype(want_t.numpy(), np.asarray(want_j))
    assert_allclose_dtype(got.numpy(), np.asarray(want_j))


def test_seg_agg_plain_skips_pad_slots():
    """Pad slots point at row 0 with mask 0: a non-finite row 0 must not
    reach the output (skipped, not multiplied by 0, which gives NaN)."""
    src, dstl, mask, v = _layout("graph", 32)
    src = np.where(mask > 0, np.maximum(src, 1), 0).astype(np.int32)
    x = RNG.standard_normal((v, 8)).astype(np.float32)
    x[0] = np.inf
    got = k1.seg_agg_plain(*_t(x, src, dstl, mask), tile_m=32)
    assert torch.isfinite(got).all()
    got = k2.fused_agg_combine_plain(*_t(x, src, dstl, mask, np.eye(8, 4,
                                     dtype=np.float32)), tile_m=32)
    assert torch.isfinite(got).all()


def test_seg_agg_plain_chunking_is_exact(monkeypatch):
    """The plain version folds a chunk of blocks at a time; the chunk size
    does not change a bit of the result."""
    src, dstl, mask, v = _layout("graph", 32)
    x = RNG.standard_normal((v, 16)).astype(np.float32)
    whole = k1.seg_agg_plain(*_t(x, src, dstl, mask), tile_m=32)
    monkeypatch.setattr(k1, "PLAIN_CHUNK_BYTES", 1)     # one block a step
    stepped = k1.seg_agg_plain(*_t(x, src, dstl, mask), tile_m=32)
    assert_allclose_dtype(stepped.numpy(), whole.numpy(), bitwise=True)


@pytest.mark.parametrize("kind,tile_m,fi,fo", [("graph", 32, 64, 7),
                                               ("graph", 32, 300, 16),
                                               ("random", 16, 40, 24)])
def test_fused_agg_combine_plain_matches_pallas_kernel(kind, tile_m, fi, fo):
    """scale=10, as tests/test_kernels.py uses for this kernel: the Pallas
    kernel reduces through a one-hot matmul and then multiplies, the plain
    version adds the rows and multiplies -- two f32 summation orders."""
    src, dstl, mask, v = _layout(kind, tile_m)
    x = RNG.standard_normal((v, fi)).astype(np.float32)
    w = (RNG.standard_normal((fi, fo)) * 0.1).astype(np.float32)
    rows, seg_p, mask_p = _pallas_inputs(x, src, dstl, mask)
    want = fused_agg_combine_blocked(rows, seg_p, mask_p, w, tile_m=tile_m,
                                     tile_e=rows.shape[1], interpret=True)
    got = k2.fused_agg_combine_plain(*_t(x, src, dstl, mask, w),
                                     tile_m=tile_m)
    assert got.shape == tuple(want.shape)
    assert_allclose_dtype(got.numpy(), np.asarray(want), scale=10)
    nblocks = src.shape[0]
    gseg = (dstl + np.arange(nblocks)[:, None] * tile_m).reshape(-1)
    oracle = jref.fused_agg_combine_ref(x[src].reshape(-1, fi), gseg,
                                        mask.reshape(-1), w, nblocks * tile_m)
    toracle = tref.fused_agg_combine_ref(
        *_t(x[src].reshape(-1, fi), gseg, mask.reshape(-1), w),
        nblocks * tile_m)
    assert_allclose_dtype(got.numpy(), np.asarray(oracle))
    assert_allclose_dtype(toracle.numpy(), np.asarray(oracle))


def test_wrappers_take_the_plain_version_on_cpu():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing: its count stays put."""
    src, dstl, mask, v = _layout("graph", 32)
    x = RNG.standard_normal((v, 16)).astype(np.float32)
    w = RNG.standard_normal((16, 5)).astype(np.float32)
    n1, n2 = k1.seg_agg.launches, k2.fused_agg_combine.launches
    a = k1.seg_agg(*_t(x, src, dstl, mask), tile_m=32)
    b = k2.fused_agg_combine(*_t(x, src, dstl, mask, w), tile_m=32)
    assert_allclose_dtype(
        a.numpy(), k1.seg_agg_plain(*_t(x, src, dstl, mask),
                                    tile_m=32).numpy(), bitwise=True)
    assert_allclose_dtype(
        b.numpy(), k2.fused_agg_combine_plain(*_t(x, src, dstl, mask, w),
                                              tile_m=32).numpy(),
        bitwise=True)
    assert (k1.seg_agg.launches, k2.fused_agg_combine.launches) == (n1, n2)


def test_fused_shared_memory_budget():
    """The fused kernel's per-block shared memory (``smem_bytes``, what the
    kernel reserves; it has no static shared memory) lets two CTAs share an
    H100 SM at every width: at Reddit's tile_m = 32 layout (emax 1760) a
    CTA stages up to 3328 slots at F_out = 128 (the mean CTA holds 3188)
    and all 3520 at F_out = 41 and 7; a layout with more slots stages as
    many as fit; W wider than 128 columns runs in 128-column launches of
    the same size."""
    assert k2.slot_capacity(32, 1760, 128) == 3328
    assert k2.slot_capacity(32, 1760, 41) == k2.slot_capacity(32, 1760, 7) \
        == 2 * 1760
    for tile_m, emax, f_out in [(32, 1760, 128), (32, 1760, 256),
                                (256, 14000, 128), (128, 100000, 1024),
                                (16, 50, 5)]:
        cap = k2.slot_capacity(tile_m, emax, f_out)
        assert 0 <= cap <= (64 // tile_m if tile_m <= 64 else 1) * emax
        assert k2.smem_bytes(f_out, cap) <= k2.SMEM_TWO_PER_SM
    assert k2.smem_bytes(1024, 7) == k2.smem_bytes(128, 7)
    assert k2.scratch_bytes(602, 128) == 10 * 512 * 128
    assert k2.scratch_bytes(3703, 1024) == k2.scratch_bytes(3703, 128)


@pytest.mark.parametrize("f_out,nt", [(1, 8), (7, 8), (16, 8), (17, 16),
                                      (41, 24), (48, 24), (49, 32),
                                      (64, 32), (65, 48), (96, 48),
                                      (97, 64), (128, 64)])
def test_fused_warpgroup_columns(f_out, nt):
    """Each of the two warpgroups owns nt columns (an instantiated wgmma
    width): together F_out rounded up to 8, and less than one width step
    more than that."""
    assert k2.cols_per_wg(f_out) == nt
    assert 2 * nt >= -(-f_out // 8) * 8
    assert nt in k2.WG_COLS
    assert nt == k2.WG_COLS[0] or 2 * k2.WG_COLS[k2.WG_COLS.index(nt) - 1] \
        < -(-f_out // 8) * 8


def _tf32_rna(a):
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on the bit pattern -- what cvt.rna.tf32.f32 does."""
    b = np.asarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _round_to_zero(v):
    """f64 values rounded to f32 toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def _tf32_product(a, w, terms):
    """``a @ w`` as the kernel forms it: hi = rna(v), lo = rna(v - hi) for
    both operands; per k8 step the exact sum of A_lo W_hi + A_hi W_lo +
    A_hi W_hi (terms=3) or A_hi W_hi alone (terms=1), added into the
    slice's accumulator rounding toward zero, as the tensor cores add; per
    64-column slice the partial added into an f32 running sum to
    nearest."""
    ah = _tf32_rna(a)
    al = _tf32_rna(a - ah)
    wh = _tf32_rna(w)
    wl = _tf32_rna(w - wh)
    f64 = np.float64
    total = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for s0 in range(0, a.shape[1], 64):
        part = np.zeros_like(total)
        for s in range(s0, min(s0 + 64, a.shape[1]), 8):
            k = slice(s, s + 8)
            t = ah[:, k].astype(f64) @ wh[k].astype(f64)
            if terms == 3:
                t += al[:, k].astype(f64) @ wh[k].astype(f64)
                t += ah[:, k].astype(f64) @ wl[k].astype(f64)
            part = _round_to_zero(part.astype(f64) + t)
        total = (total + part).astype(np.float32)
    return total


@pytest.mark.parametrize("k", [602, 3703])
def test_three_tf32_products_hold_the_f32_limits(k):
    """Why the kernel takes three TF32 products and why chip_smoke.py's
    one-product control must fail: on a (64, K) @ (K, 128) product shaped
    like Reddit's and Citeseer's fused layers (aggregates of ~50 N(0, 1)
    rows, W ~ N(0, 2 / K)), 3xTF32 stays inside the per-row and Frobenius
    limits against the f32 product, and one TF32 product does not."""
    rng = np.random.default_rng(k)
    a = (rng.standard_normal((64, k)) * 7).astype(np.float32)
    w = (rng.standard_normal((k, 128)) * np.sqrt(2 / k)).astype(np.float32)
    want = a @ w

    def errs(got):
        row = (np.abs(got - want).max(1) / np.abs(want).max(1)).max()
        return row, np.linalg.norm(got - want) / np.linalg.norm(want)

    row3, fro3 = errs(_tf32_product(a, w, 3))
    row1, fro1 = errs(_tf32_product(a, w, 1))
    assert row3 <= k2.ROW_LIMIT and fro3 <= k2.FRO_LIMIT
    assert row1 > k2.ROW_LIMIT and fro1 > k2.FRO_LIMIT


@pytest.mark.parametrize("f", [1, 5, 7, 8, 41, 63, 64, 65, 128, 602,
                               1433, 3703])
def test_seg_agg_slices_cover_f(f):
    """The column slices cover F exactly (the last one non-empty) and are
    at most MAX_SLICE wide; the load shape covers a slice."""
    w = k1.slice_cols(f)
    n = -(-f // w)
    assert 1 <= w <= min(f, k1.MAX_SLICE)
    assert (n - 1) * w < f <= n * w
    vec, c = k1.launch_params(f, w, 4, 16)
    assert f % vec == 0 and w % vec == 0
    assert k1.UNIT_LANES * vec * c >= w and vec * c <= 8


def test_seg_agg_slices_at_reddit():
    """Reddit on the H100: 64-column slices at F = 128 and 602 (16- and
    8-byte loads), one slice at F = 41 (4-byte loads); an unaligned x
    drops to narrower loads."""
    assert [k1.slice_cols(f) for f in (128, 602, 41)] == [64, 64, 41]
    assert k1.launch_params(128, 64, 4, 16) == (4, 2)
    assert k1.launch_params(602, 64, 4, 16) == (2, 4)
    assert k1.launch_params(41, 41, 4, 16) == (1, 6)
    assert k1.launch_params(128, 64, 4, 8) == (2, 4)
    assert k1.launch_params(128, 64, 4, 4) == (1, 8)


# ---------------------------------------------------------------------------
# bf16 and the mixed pair (bf16 and int8-agg plans, fused dedup in bf16)
# ---------------------------------------------------------------------------

def _bf16(a):
    """(numpy array of the reference's bf16, torch bf16 tensor) of one
    array rounded to bf16 once."""
    import jax.numpy as jnp
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return np.asarray(t.float().numpy()).astype(jnp.bfloat16), t


@pytest.mark.parametrize("kind,tile_m,f", [("graph", 32, 7), ("graph", 128, 64),
                                           ("random", 16, 33)])
def test_seg_agg_plain_bf16_matches_pallas_kernel(kind, tile_m, f):
    """bf16 rows: both fold in f32 and round once to bf16, so the outputs
    are bf16 and agree within the bf16 band (mostly exactly)."""
    rng = np.random.default_rng(17)
    src, dstl, mask, v = _layout(kind, tile_m)
    xj, xt = _bf16(rng.standard_normal((v, f)))
    rows, seg_p, mask_p = _pallas_inputs(xj, src, dstl, mask)
    want = seg_agg_blocked(rows, seg_p, mask_p, tile_m=tile_m,
                           tile_e=rows.shape[1], interpret=True)
    got = k1.seg_agg_plain(xt, *_t(src, dstl, mask), tile_m=tile_m)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert_allclose_dtype(got.float().numpy(), np.asarray(want, np.float32),
                          "bf16")
    assert np.mean(got.float().numpy() == np.asarray(want, np.float32)) > 0.9


@pytest.mark.parametrize("pair", ["bf16", "mixed"])
@pytest.mark.parametrize("kind,tile_m,fi,fo", [("graph", 32, 64, 7),
                                               ("graph", 32, 300, 16),
                                               ("random", 16, 40, 24)])
def test_fused_plain_bf16_matches_pallas_kernel(pair, kind, tile_m, fi, fo):
    """(bf16 rows, bf16 W) and (f32 rows, bf16 W): the output takes W's
    dtype, bf16, in both, after an f32 fold and an f32 product."""
    rng = np.random.default_rng(19)
    src, dstl, mask, v = _layout(kind, tile_m)
    x = rng.standard_normal((v, fi)).astype(np.float32)
    wj, wt = _bf16(rng.standard_normal((fi, fo)) * 0.1)
    if pair == "bf16":
        xj, xt = _bf16(x)
    else:
        xj, xt = x, torch.from_numpy(x)
    rows, seg_p, mask_p = _pallas_inputs(xj, src, dstl, mask)
    want = fused_agg_combine_blocked(rows, seg_p, mask_p, wj, tile_m=tile_m,
                                     tile_e=rows.shape[1], interpret=True)
    got = k2.fused_agg_combine_plain(xt, *_t(src, dstl, mask), wt,
                                     tile_m=tile_m)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert_allclose_dtype(got.float().numpy(), np.asarray(want, np.float32),
                          "bf16")
    assert np.mean(got.float().numpy() == np.asarray(want, np.float32)) > 0.9


def test_bf16_launch_params_and_entries():
    """Byte-based loads: bf16 F = 128 takes 16-byte loads (8 elements),
    F = 602 (1,204-byte rows) 4-byte, F = 41 (82-byte rows) 2-byte, each
    covering a slice with a lane holding at most 8 values; K2's lanes load
    at most 4 elements.  The wrappers pick their C entry by dtype and raise
    TypeError for what the kernels do not take."""
    assert k1.launch_params(128, 64, 2, 16) == (8, 1)
    assert k1.launch_params(602, 64, 2, 16) == (2, 4)
    assert k1.launch_params(41, 41, 2, 16) == (1, 6)
    assert k1.launch_params(128, 64, 2, 4) == (2, 4)
    assert k1.launch_params(128, 64, 2, 2) == (1, 8)
    for f in (1, 7, 41, 64, 128, 602, 1433):
        w = k1.slice_cols(f)
        for align in (2, 4, 8, 16):
            vec, c = k1.launch_params(f, w, 2, align)
            assert f % vec == 0 and w % vec == 0 and 2 * vec <= align
            assert k1.UNIT_LANES * vec * c >= w and vec * c <= k1.LANE_ELEMS
    assert [k2.load_vec(f, 2, 16) for f in (602, 128, 41)] == [2, 4, 1]
    assert [k2.load_vec(f, 4, 16) for f in (602, 128, 41)] == [2, 4, 1]
    assert k1._entry("seg_agg", torch.bfloat16) == "seg_agg_bf16"
    assert k1._entry("seg_agg", torch.float32) == "seg_agg_f32"
    with pytest.raises(TypeError, match="float16"):
        k1._entry("seg_agg", torch.float16)
    assert [k2.pair_code(a, b) for a, b in k2.PAIRS] == [0, 1, 2]
    with pytest.raises(TypeError, match="W torch.float32"):
        k2.pair_code(torch.bfloat16, torch.float32)


def test_host_regrouping_entries_match_reference():
    """ops.seg_agg (regroups on the host per call) and
    ops.seg_agg_pregrouped (blocked rows, any slot order) against the
    reference's, whose Pallas kernel runs in interpret mode."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(23)
    g = GRAPH
    rows = rng.standard_normal((g.num_edges, 12)).astype(np.float32)
    seg = np.asarray(g.dst)
    want = jops.seg_agg(rows, seg, g.num_vertices, tile_m=32, tile_e=8)
    got = tops.seg_agg(*_t(rows, seg), g.num_vertices, 32, backend="torch")
    assert got.shape == (g.num_vertices, 12)
    assert_allclose_dtype(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="sorted"):
        tops.seg_agg(*_t(rows, seg[::-1].copy()), g.num_vertices,
                     backend="torch")
    src, dstl, mask, v = _layout("random", 16)
    x = rng.standard_normal((v, 9)).astype(np.float32)
    blocked, seg_p, mask_p = _pallas_inputs(x, src, dstl, mask)
    want = jops.seg_agg_pregrouped(blocked, seg_p, mask_p, 16, tile_e=8)
    got = tops.seg_agg_pregrouped(*_t(blocked, seg_p, mask_p), 16,
                                  backend="torch")
    assert_allclose_dtype(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tops.seg_agg(*_t(rows, seg), g.num_vertices, backend="cuda")
