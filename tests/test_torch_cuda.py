"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``: every test here needs a CUDA card and nvcc, and skips
without one.  Imports torch only (no JAX), so it runs on the machine with
the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same comparisons at the main path's full-size
shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import CORA, reduced_graph
from repro_torch.config import MoEConfig
from repro_torch.configs import (arctic_480b, gemma2_9b, granite_3_8b,
                                 jamba_1_5_large, mamba2_2_7b,
                                 seamless_m4t_medium)
from repro_torch.core import dataflow
from repro_torch.core import plan as tplan
from repro_torch.core.dataflow import block_graph_arrays
from repro_torch.graph.datasets import make_features, make_synthetic_graph
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import fused_agg_combine as k2
from repro_torch.kernels import ops
from repro_torch.kernels import seg_agg as k1
from repro_torch.models import encdec, mamba2, moe
from repro_torch.models import transformer as ttr
from repro_torch.models.gcn import make_paper_model
from repro_torch.nn import layers

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

#: unit f32 band times 10: kernel and plain version add in other orders
TOL = 1e-4
#: the bf16 band: both versions compute in f32 and round once to bf16, so
#: they differ by about one bf16 ulp of the largest magnitude
BF16_TOL = 3e-2
#: K5's per-row limits (chip_smoke.py ROW_LIMIT): each row's largest error
#: over that row's largest magnitude.  The bands above scale with the whole
#: output's largest magnitude, which rows with few keys set; these hold a
#: row that averages many keys to its own scale
ROW_LIMIT = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
#: K1's and K2's bf16 outputs per row (chip_smoke.py AGG_BF16_ROW_LIMIT):
#: kernel and plain version both round an f32 sum once, and the two f32
#: sums differ by a few f32 ulps (other addition orders, 3xTF32), so an
#: element rounds to the same bf16 or to its neighbour: at most one bf16
#: ulp, 2^-7 = 7.8e-3 of the row's largest magnitude
AGG_BF16_ROW_LIMIT = 1e-2
#: the int8-agg band: the tiers' f32 sums differ by ulps, and a value near
#: a step of the int8 grid then lands on the neighbouring step of the other
#: tier's quantization, one step of max|row| / 127
INT8_TOL = 2e-2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the cuda tier has no CPU mode)")
    spec = reduced_graph(CORA, 1000, 256)
    g = make_synthetic_graph(spec, device="cuda")
    return spec, g, make_features(spec, device="cuda")


def _close(a, b, tol=TOL):
    torch.cuda.synchronize()
    scale = max(1.0, b.abs().max().item())
    assert (a.float() - b.float()).abs().max().item() <= tol * scale


def _rows_close(a, b, limit):
    """Each row (last dim) of ``a`` within ``limit`` of that row's largest
    magnitude in ``b``; a row of ``b`` that is all 0 is 0 in ``a`` too."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    diff, mag = (a - b).abs().amax(-1), b.abs().amax(-1)
    assert (diff <= limit * mag).all()


@pytest.mark.parametrize("f", [1, 7, 41, 128, 300, 602])
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_agg_kernel_matches_plain(card, f, weighted):
    spec, g, _ = card
    plan = make_paper_model("gcn", spec, device="cuda").plan_for(g)
    bg = plan.layers[0].agg_layout
    gen = torch.Generator(device="cuda").manual_seed(f)
    x = torch.randn((g.num_vertices, f), generator=gen, device="cuda")
    w = torch.rand(g.num_edges, generator=gen, device="cuda") \
        if weighted else None
    n = k1.seg_agg.launches
    _close(ops.seg_agg_planned(bg, x, w, backend="cuda"),
           ops.seg_agg_planned(bg, x, w, backend="torch"))
    assert k1.seg_agg.launches == n + 1


def _ragged_layout(v=700, tile_m=128, seed=3):
    """A power-law blocked layout on the card whose second block gets no
    edge at all and whose other blocks have rows without edges."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, v + 1, dtype=np.float64) ** -1.1
    dst = np.sort(rng.choice(v, size=6000, p=p / p.sum()))
    dst = dst[(dst < tile_m) | (dst >= 2 * tile_m)]
    src = rng.integers(0, v, size=len(dst))
    return block_graph_arrays(src, dst, v, tile_m, device="cuda")


@pytest.mark.parametrize("f,width", [(128, 8), (128, 24), (41, 16), (41, 1),
                                     (602, 40), (602, 64), (7, 3)])
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_agg_kernel_column_slices(card, f, width, weighted):
    """More than one column slice (the last narrower where the width does
    not divide F), on a layout with an empty block and empty rows; two
    launches are bitwise equal."""
    bg = _ragged_layout()
    gen = torch.Generator(device="cuda").manual_seed(f + width)
    x = torch.randn((bg.num_vertices, f), generator=gen, device="cuda")
    w = torch.rand(bg.src.shape, generator=gen, device="cuda") \
        if weighted else None
    args = (x, bg.src, bg.dstl, bg.mask, w)
    n = k1.seg_agg.launches
    got = k1._launch(*args, bg.tile_m, width)
    again = k1._launch(*args, bg.tile_m, width)
    assert k1.seg_agg.launches == n + 2
    want = k1.seg_agg_plain(*args, tile_m=bg.tile_m)
    _close(got, want)
    assert torch.equal(got, again)
    assert not got[bg.tile_m:2 * bg.tile_m].any()


@pytest.mark.parametrize("fi,fo", [(256, 128), (128, 7), (300, 41)])
def test_fused_kernel_matches_plain(card, fi, fo):
    spec, g, _ = card
    plan = make_paper_model("gcn", spec, device="cuda",
                            fused=True).plan_for(g)
    bg = plan.layers[0].blocked
    gen = torch.Generator(device="cuda").manual_seed(fi + fo)
    x = torch.randn((g.num_vertices, fi), generator=gen, device="cuda")
    w = torch.randn((fi, fo), generator=gen, device="cuda") * 0.1
    n = k2.fused_agg_combine.launches
    got = k2.fused_agg_combine(x, bg.src, bg.dstl, bg.mask, w,
                               tile_m=bg.tile_m)
    want = k2.fused_agg_combine_plain(x, bg.src, bg.dstl, bg.mask, w,
                                      tile_m=bg.tile_m)
    _close(got, want)
    _rows_close(got, want, k2.ROW_LIMIT)
    assert k2.fused_agg_combine.launches == n + 1


def _fused_case(tile_m, nblocks, fi, fo, seed, coef=False):
    """A ragged layout of ``nblocks`` blocks (the second empty, rows
    without edges elsewhere), x and W on the card; ``coef`` gives the
    valid slots masks other than 1."""
    bg = _ragged_layout(v=nblocks * tile_m - tile_m // 3, tile_m=tile_m,
                        seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mask = bg.mask
    if coef:
        mask = torch.where(mask != 0, 0.5 + torch.rand(
            mask.shape, generator=gen, device="cuda"), 0.0)
    x = torch.randn((bg.num_vertices, fi), generator=gen, device="cuda")
    w = torch.randn((fi, fo), generator=gen, device="cuda") * (2 / fi) ** .5
    return bg, (x, bg.src, bg.dstl, mask, w)


@pytest.mark.parametrize("tile_m,nblocks,fi,fo,coef", [
    # several blocks a CTA (tile_m < 64), the last CTA partial (odd
    # nblocks); one block a CTA; a block of several 64-row CTAs
    (32, 7, 7, 7, False), (32, 7, 602, 41, False), (32, 9, 1433, 128, True),
    (32, 5, 128, 256, False), (64, 5, 602, 128, False), (64, 3, 7, 41, True),
    (128, 3, 1433, 7, False), (128, 3, 602, 256, False),
    (256, 3, 602, 41, False), (256, 3, 128, 128, True),
    # tile_m that does not divide 64 or is a multiple of it: padded rows;
    # four blocks a CTA; F_out past one launch's 256 columns
    (48, 5, 41, 7, False), (96, 3, 602, 41, False), (16, 13, 128, 128, False),
    (32, 3, 64, 300, False),
])
def test_fused_kernel_edges(card, tile_m, nblocks, fi, fo, coef):
    """K2 against its plain version at its edges: blocks a CTA, N padding
    (F_out 7, 41, 128, 256, 300), K tails (F_in 7, 41, 602, 1433), empty
    blocks and rows, masks other than 1; within TOL and the per-row
    limit, two launches bitwise equal, an empty block exactly 0."""
    bg, args = _fused_case(tile_m, nblocks, fi, fo, fi + fo + tile_m, coef)
    n = k2.fused_agg_combine.launches
    got = k2.fused_agg_combine(*args, tile_m=bg.tile_m)
    again = k2.fused_agg_combine(*args, tile_m=bg.tile_m)
    assert k2.fused_agg_combine.launches == n + 2
    want = k2.fused_agg_combine_plain(*args, tile_m=bg.tile_m)
    assert got.shape == want.shape == (bg.nblocks * tile_m, fo)
    _close(got, want)
    _rows_close(got, want, k2.ROW_LIMIT)
    assert torch.equal(got, again)
    assert not got[tile_m:2 * tile_m].any()
    # indices read from L2 instead of shared memory: the same sums
    assert torch.equal(got, k2._launch(*args, bg.tile_m, cap=0))


def test_fused_kernel_pad_slots_do_not_leak(card):
    """Pad slots point at row 0 with mask 0: a non-finite x[0] must not
    reach the output (pad slots are skipped, never multiplied by 0)."""
    bg, (x, src, dstl, mask, w) = _fused_case(32, 7, 602, 41, 5)
    src = torch.where(mask != 0, src.clamp_min(1), 0).to(torch.int32)
    x[0] = float("inf")
    got = k2.fused_agg_combine(x, src, dstl, mask, w, tile_m=bg.tile_m)
    assert torch.isfinite(got).all()
    _close(got, k2.fused_agg_combine_plain(x, src, dstl, mask, w,
                                           tile_m=bg.tile_m))


def test_fused_one_tf32_product_fails_the_limits(card):
    """The control: one TF32 product instead of three is off by more than
    the per-row limit, so the check sees TF32 rounding."""
    bg, args = _fused_case(32, 9, 1433, 128, 11)
    want = k2.fused_agg_combine_plain(*args, tile_m=bg.tile_m)
    n = k2.fused_agg_combine.launches
    one = k2._launch(*args, bg.tile_m, terms=1)
    assert k2.fused_agg_combine.launches == n
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        _rows_close(one, want, k2.ROW_LIMIT)


def test_fused_kernel_refuses_bad_input(card):
    bg, (x, src, dstl, mask, w) = _fused_case(32, 3, 64, 8, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_agg_combine(x.t().contiguous().t(), src, dstl, mask, w,
                             tile_m=32)
    with pytest.raises(TypeError):
        k2.fused_agg_combine(x, src, dstl, mask, w.double(), tile_m=32)
    with pytest.raises(ValueError, match="terms"):
        k2._launch(x, src, dstl, mask, w, 32, terms=2)


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_model_cuda_tier_matches_torch_tier(card, name, fused):
    spec, g, x = card
    m = make_paper_model(name, spec, device="cuda", fused=fused,
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _close(m(g, x), m(g, x, plan=m.plan_for(g, backend="torch")))


def test_kernel_refuses_gradients(card):
    """K2 has no backward: a fused forward that needs a gradient raises.
    K1 differentiates (its autograd Function), so the unfused forward
    keeps the gradient (test_k1_backward_matches_plain)."""
    spec, g, x = card
    m = make_paper_model("gcn", spec, device="cuda", fused=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        m(g, x)
    assert make_paper_model("gcn", spec, device="cuda")(g, x).grad_fn \
        is not None


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the cuda tier has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,kv_len", [
    (2, 4, 2, 128, 128, 64, True, 0, 0.0, None),
    (1, 8, 4, 100, 260, 32, True, 0, 50.0, None),
    (2, 2, 1, 64, 192, 64, True, 48, 0.0, None),
    (1, 4, 4, 1, 300, 64, True, 0, 0.0, None),      # decode shape
    (1, 2, 2, 96, 96, 128, False, 0, 0.0, None),    # non-causal
    (2, 4, 2, 8, 192, 256, True, 0, 50.0, (50, 192)),
    (1, 2, 1, 17, 17, 16, True, 4, 50.0, None),
    (1, 2, 1, 40, 40, 64, True, 0, 0.0, (3, )),     # rows with no key
    (1, 14, 2, 130, 130, 128, True, 0, 0.0, None),  # arctic's group of 7
    # internvl2-1b's group of 7 at D 64: a prefill of patches + prompt off
    # the 64-row tiles with a ragged kv_len, and its decode shape
    (2, 14, 2, 301, 301, 64, True, 0, 0.0, (250, 301)),
    (3, 14, 2, 1, 290, 64, True, 0, 0.0, (257, 270, 290)),
    # gemma-7b's group 1 at D 256 past 256 keys (32-key bf16 tiles)
    (1, 4, 4, 520, 520, 256, True, 0, 0.0, None),
    (1, 16, 2, 200, 200, 128, True, 0, 0.0, None),  # deepseek's group of 8
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(gpu, b, hq, hkv, sq, sk, d, causal,
                                    window, cap, kv_len, dtype):
    gen = torch.Generator(device=gpu).manual_seed(sq * d)
    q = torch.randn((b, hq, sq, d), generator=gen, device=gpu).to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=gen, device=gpu).to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=gen, device=gpu).to(dtype)
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                   device=gpu)
    kw = dict(causal=causal, window=window, softcap=cap)
    n = k5.flash_attention.launches
    got = k5.flash_attention(q, k, v, kvl, **kw)
    assert k5.flash_attention.launches == n + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    want = k5.flash_attention_plain(q, k, v, kvl, **kw)
    _close(got, want, TOL if dtype == torch.float32 else BF16_TOL)
    _rows_close(got, want, ROW_LIMIT[dtype])


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,kv_len", [
    # the bf16 kernel's tiles: 64 query rows, 64 keys (32 at d = 256)
    (1, 2, 2, 63, 65, 64, True, 0, 0.0, None),
    (1, 2, 1, 65, 63, 64, False, 0, 0.0, None),
    (1, 4, 1, 64, 64, 16, True, 0, 50.0, None),
    (1, 2, 2, 1, 1, 128, True, 0, 0.0, None),
    (2, 4, 2, 1, 129, 256, True, 0, 50.0, None),
    (1, 2, 1, 129, 31, 256, True, 0, 0.0, None),
    (1, 8, 2, 33, 33, 256, False, 0, 50.0, None),
    (1, 4, 4, 200, 200, 128, True, 40, 0.0, None),   # window edge in a tile
    (1, 4, 2, 130, 130, 256, True, 20, 50.0, None),
    (2, 4, 1, 100, 160, 64, True, 0, 0.0, (60, 160)),  # rows with no key
    (1, 2, 1, 70, 70, 256, True, 0, 0.0, (33,)),
    (1, 2, 2, 127, 127, 32, False, 0, 30.0, None),
    (1, 2, 1, 257, 257, 16, True, 0, 0.0, None),
    # d = 256 with an odd group: one warpgroup a CTA, 32-key tiles
    (1, 2, 2, 65, 97, 256, True, 0, 50.0, None),
    (1, 3, 1, 40, 70, 256, True, 16, 0.0, (50,)),
])
def test_flash_bf16_tile_edges_match_plain(gpu, b, hq, hkv, sq, sk, d,
                                           causal, window, cap, kv_len):
    gen = torch.Generator(device=gpu).manual_seed(sq * d + sk)
    q, k, v = (torch.randn(shp, generator=gen, device=gpu).to(torch.bfloat16)
               for shp in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                   device=gpu)
    kw = dict(causal=causal, window=window, softcap=cap)
    n = k5.flash_attention.launches
    got = k5.flash_attention(q, k, v, kvl, **kw)
    assert k5.flash_attention.launches == n + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    want = k5.flash_attention_plain(q, k, v, kvl, **kw)
    _close(got, want, BF16_TOL)
    _rows_close(got, want, ROW_LIMIT[torch.bfloat16])
    assert torch.equal(got, k5.flash_attention(q, k, v, kvl, **kw))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,kv_len", [
    # the f32 kernel's tiles: 64 query rows, 32 keys; every head dim (two
    # warpgroups a CTA at d = 256)
    (1, 2, 1, 63, 31, 16, True, 0, 50.0, None),
    (1, 2, 2, 65, 33, 32, False, 0, 0.0, None),
    (1, 4, 2, 64, 32, 64, True, 0, 0.0, None),
    (1, 2, 1, 1, 1, 128, True, 0, 0.0, None),
    (2, 4, 2, 1, 129, 256, True, 0, 50.0, None),
    (1, 2, 1, 129, 95, 256, True, 0, 0.0, None),
    (1, 8, 2, 33, 97, 256, False, 0, 50.0, None),
    (1, 2, 2, 127, 127, 128, False, 0, 30.0, None),
    (1, 2, 1, 257, 257, 16, True, 0, 0.0, None),
    # a window edge inside a tile
    (1, 4, 4, 200, 200, 128, True, 40, 0.0, None),
    (1, 4, 2, 130, 130, 256, True, 20, 50.0, None),
    (1, 2, 1, 96, 96, 64, True, 17, 0.0, None),
    # kv_len: rows with no key, a batch shorter than Sk
    (2, 4, 1, 100, 160, 64, True, 0, 0.0, (60, 160)),
    (1, 2, 1, 70, 70, 256, True, 0, 0.0, (33,)),
    (2, 2, 1, 40, 90, 32, True, 8, 50.0, (0, 90)),
])
def test_flash_f32_tile_edges_match_plain(gpu, b, hq, hkv, sq, sk, d,
                                          causal, window, cap, kv_len):
    """K5's 3xTF32 kernel at its tile edges: within TOL and the per-row
    limit of the plain version, finite, counted once a launch, and two
    launches equal bit for bit."""
    gen = torch.Generator(device=gpu).manual_seed(sq * d + sk)
    q, k, v = (torch.randn(shp, generator=gen, device=gpu)
               for shp in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                   device=gpu)
    kw = dict(causal=causal, window=window, softcap=cap)
    n = k5.flash_attention.launches
    got = k5.flash_attention(q, k, v, kvl, **kw)
    again = k5.flash_attention(q, k, v, kvl, **kw)
    assert k5.flash_attention.launches == n + 2
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = k5.flash_attention_plain(q, k, v, kvl, **kw)
    _close(got, want)
    _rows_close(got, want, ROW_LIMIT[torch.float32])
    assert torch.equal(got, again)


@pytest.mark.parametrize("d", [128, 256])
def test_flash_one_tf32_product_fails_the_limits(gpu, d):
    """The control: one TF32 product instead of three misses the f32
    per-row limit and is not counted as a launch, so the check sees TF32
    rounding; the 3xTF32 launch on the same inputs meets it."""
    gen = torch.Generator(device=gpu).manual_seed(d)
    q = torch.randn((1, 4, 256, d), generator=gen, device=gpu)
    k, v = (torch.randn((1, 2, 256, d), generator=gen, device=gpu)
            for _ in range(2))
    want = k5.flash_attention_plain(q, k, v, softcap=50.0)
    n = k5.flash_attention.launches
    one = k5._launch(q, k, v, softcap=50.0, terms=1)
    three = k5._launch(q, k, v, softcap=50.0)
    assert k5.flash_attention.launches == n
    torch.cuda.synchronize()
    _rows_close(three, want, ROW_LIMIT[torch.float32])
    with pytest.raises(AssertionError):
        _rows_close(one, want, ROW_LIMIT[torch.float32])


def test_flash_f32_launches_are_bitwise_equal(gpu):
    """No atomics, a fixed order of every sum: two f32 launches at a
    gemma2-like layer (two warpgroups a CTA, S's halves added through
    shared memory) give the same bits."""
    gen = torch.Generator(device=gpu).manual_seed(7)
    q = torch.randn((1, 4, 1000, 256), generator=gen, device=gpu)
    k, v = (torch.randn((1, 2, 1000, 256), generator=gen, device=gpu)
            for _ in range(2))
    first = k5.flash_attention(q, k, v, softcap=50.0)
    assert all(torch.equal(first, k5.flash_attention(q, k, v, softcap=50.0))
               for _ in range(3))


#: K5's backward against its plain version (chip_smoke.py BWD_ROW_LIMIT,
#: BWD_ROW_FLOOR): each row's largest error over that row's largest
#: magnitude, floored at 1% of the tensor's (a causal first row sees one
#: key and its dq is 0 up to rounding)
BWD_ROW_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bwd_plain_for(dtype, q, k, v, out, lse, dout, kvl, **kw):
    """The yardstick of K5's backward in ``dtype``: the plain version in
    f32 for bf16; for f32 the plain version evaluated in f64 (chip_smoke.py
    phase 18), since its f32 evaluation is itself up to ~1e-4 a row off
    the f64 one at these limits."""
    if dtype == torch.bfloat16:
        return k5.flash_attention_bwd_plain(q, k, v, out, lse, dout, kvl,
                                            **kw)
    return k5.flash_attention_bwd_plain(
        *(t.double() for t in (q, k, v, out)), lse, dout.double(), kvl, **kw)


def _bwd_rows_close(a, b, limit):
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    diff = (a - b).abs().amax(-1)
    mag = b.abs().amax(-1).clamp_min(1e-2 * b.abs().max().item())
    assert (diff <= limit * mag).all() and torch.isfinite(a).all()


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,kv_len", [
    (2, 4, 2, 128, 128, 64, True, 0, 0.0, None),
    (1, 8, 4, 100, 260, 32, True, 0, 50.0, None),
    (2, 2, 1, 64, 192, 64, True, 48, 0.0, None),
    (1, 4, 4, 1, 300, 64, True, 0, 0.0, None),      # decode shape
    (1, 2, 2, 96, 96, 128, False, 0, 0.0, None),    # non-causal
    (2, 4, 2, 8, 192, 256, True, 0, 50.0, (50, 192)),
    (1, 2, 1, 17, 17, 16, True, 4, 50.0, None),
    (1, 16, 8, 300, 300, 256, True, 100, 50.0, None),
    # the bf16 kernels' tile edges: Sq and Sk off the 64-row tiles at the
    # narrow swizzles (D 32 and 16), D 256 with an odd group (one head a
    # dq CTA), a window straddling a 64-key tile, kv_len short of Sk
    (1, 4, 2, 150, 170, 32, True, 0, 50.0, None),
    (1, 4, 4, 130, 130, 16, False, 0, 0.0, None),
    (1, 6, 2, 200, 200, 256, True, 0, 50.0, None),
    (1, 3, 3, 100, 140, 256, True, 0, 0.0, None),
    (1, 8, 4, 256, 256, 128, True, 70, 0.0, None),
    (2, 4, 2, 100, 200, 128, True, 0, 30.0, (120, 200)),
    # internvl2-1b's group of 7 at D 64 (dK and dV summed over 7 heads),
    # odd lengths and a ragged kv_len; gemma-7b's group 1 at D 256 past
    # 256 keys (one head a dq CTA); deepseek's group of 8 at D 128
    (2, 14, 2, 301, 301, 64, True, 0, 0.0, (250, 301)),
    (1, 14, 2, 77, 333, 64, True, 0, 0.0, None),
    (1, 4, 4, 520, 520, 256, True, 0, 0.0, None),
    (1, 16, 2, 200, 200, 128, True, 0, 0.0, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_plain(gpu, b, hq, hkv, sq, sk, d, causal,
                                      window, cap, kv_len, dtype):
    """K5's two backward kernels against ``flash_attention_bwd_plain``
    from K5's own out and lse: two launches a call, each row in its
    limit, a second call bit for bit; the lse against the plain one's."""
    gen = torch.Generator(device=gpu).manual_seed(sq * d + 1)
    q, k, v = (torch.randn(shp, generator=gen, device=gpu).to(dtype)
               for shp in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    dout = torch.randn((b, hq, sq, d), generator=gen, device=gpu).to(dtype)
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                   device=gpu)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = k5.flash_attention(q, k, v, kvl, return_lse=True, **kw)
    assert torch.equal(out, k5.flash_attention(q, k, v, kvl, **kw))
    want_lse = k5.flash_attention_plain(q, k, v, kvl, return_lse=True,
                                        **kw)[1]
    seen = want_lse > -1e29
    assert (lse[~seen] <= -1e29).all()
    lse_limit = 2e-5 if dtype == torch.float32 else 4e-3
    assert (lse - want_lse)[seen].abs().max().item() <= lse_limit
    n = k5.flash_attention_bwd.launches
    got = k5.flash_attention_bwd(q, k, v, out, lse, dout, kvl, **kw)
    assert k5.flash_attention_bwd.launches == n + 2
    want = _bwd_plain_for(dtype, q, k, v, out, lse, dout, kvl, **kw)
    again = k5.flash_attention_bwd(q, k, v, out, lse, dout, kvl, **kw)
    for x, y, z in zip(got, want, again):
        assert x.dtype == dtype and x.shape == y.shape
        _bwd_rows_close(x, y, BWD_ROW_LIMIT[dtype])
        assert torch.equal(x, z)


#: K5's f32 backward's relative Frobenius limit (chip_smoke.py
#: BWD_FRO_LIMIT), the largest over dq, dk and dv
BWD_FRO_LIMIT_F32 = 1e-5


def _bwd_rel_errs(got, want):
    """(largest per-row error over the row's largest magnitude floored at
    1% of the tensor's, relative Frobenius error), each the largest over
    the three gradients (chip_smoke.py ``bwd_rel_errs``)."""
    row = fro = 0.0
    for a, b in zip(got, want):
        a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
        diff = (a - b).abs().amax(-1)
        mag = b.abs().amax(-1).clamp_min(1e-2 * b.abs().max().item())
        row = max(row, (diff / mag.clamp_min(1e-30)).max().item())
        fro = max(fro, ((a - b).norm() / b.norm().clamp_min(1e-30)).item())
    return row, fro


def _f32_bwd_case(gpu, d, group, terms=3):
    """K5's f32 backward at head dim ``d`` and GQA group ``group`` at its
    tile edges: Sq and Sk off the 64-row tiles and the 16- and 32-key ones,
    a batch whose kv_len is short of Sk, a window for even groups and a
    softcap of 50 for odd ones.  Returns (got, again, want, launches)."""
    b, hkv = 2, 2
    hq = hkv * group
    sq = 77 + d // 4
    sk = sq + 53
    kv_len, window = (sk - 13, sk), (40 if group % 2 == 0 else 0)
    cap = 50.0 if group % 2 else 0.0
    gen = torch.Generator(device=gpu).manual_seed(31 * d + group)
    q, dout = (torch.randn((b, hq, sq, d), generator=gen, device=gpu)
               for _ in range(2))
    k, v = (torch.randn((b, hkv, sk, d), generator=gen, device=gpu)
            for _ in range(2))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=gpu)
    kw = dict(causal=True, window=window, softcap=cap)
    out, lse = k5.flash_attention(q, k, v, kvl, return_lse=True, **kw)
    n = k5.flash_attention_bwd.launches
    got = k5.flash_attention_bwd(q, k, v, out, lse, dout, kvl, terms=terms,
                                 **kw)
    launched = k5.flash_attention_bwd.launches - n
    again = k5.flash_attention_bwd(q, k, v, out, lse, dout, kvl, terms=terms,
                                   **kw)
    want = _bwd_plain_for(torch.float32, q, k, v, out, lse, dout, kvl, **kw)
    return got, again, want, launched


@pytest.mark.parametrize("group", [1, 2, 3, 4])
@pytest.mark.parametrize("d", k5.HEAD_DIMS)
def test_flash_f32_backward_tile_edges_match_plain(gpu, d, group):
    """The 3xTF32 backward kernels at every head dim and GQA group, at
    ragged Sq and Sk, a short kv_len, a window or a softcap: finite, within
    the f32 per-row and Frobenius limits of the plain version, two
    launches a call, and a second call bit for bit."""
    got, again, want, launched = _f32_bwd_case(gpu, d, group)
    assert launched == 2
    row, fro = _bwd_rel_errs(got, want)
    assert row <= BWD_ROW_LIMIT[torch.float32] and \
        fro <= BWD_FRO_LIMIT_F32, (row, fro)
    for x, y, z in zip(got, want, again):
        assert x.dtype == torch.float32 and x.shape == y.shape
        assert torch.isfinite(x).all() and torch.equal(x, z)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_f32_backward_one_tf32_product_fails_the_limits(gpu, d):
    """The control: the backward kernels with one TF32 product instead of
    three exceed both f32 limits, so the checks see TF32 rounding; the
    3xTF32 launches on the same inputs meet them."""
    three = _f32_bwd_case(gpu, d, 3)
    one = _f32_bwd_case(gpu, d, 3, terms=1)
    torch.cuda.synchronize()
    row, fro = _bwd_rel_errs(three[0], three[2])
    assert row <= BWD_ROW_LIMIT[torch.float32] and fro <= BWD_FRO_LIMIT_F32
    row, fro = _bwd_rel_errs(one[0], one[2])
    assert row > BWD_ROW_LIMIT[torch.float32] and fro > BWD_FRO_LIMIT_F32
    with pytest.raises(ValueError, match="terms"):
        _f32_bwd_case(gpu, d, 3, terms=2)


def test_flash_backward_all_masked_rows_are_zero(gpu):
    """kv_len 0 masks every key of batch 0: its gradients are 0, not
    NaN, and batch 1's match the plain version."""
    gen = torch.Generator(device=gpu).manual_seed(5)
    q, dout = (torch.randn((2, 4, 40, 128), generator=gen, device=gpu)
               for _ in range(2))
    k, v = (torch.randn((2, 2, 70, 128), generator=gen, device=gpu)
            for _ in range(2))
    kvl = torch.tensor([0, 70], dtype=torch.int32, device=gpu)
    out, lse = k5.flash_attention(q, k, v, kvl, softcap=50.0,
                                  return_lse=True)
    got = k5.flash_attention_bwd(q, k, v, out, lse, dout, kvl, softcap=50.0)
    want = _bwd_plain_for(torch.float32, q, k, v, out, lse, dout, kvl,
                          softcap=50.0)
    for x, y in zip(got, want):
        assert torch.isfinite(x).all() and (x[0] == 0).all()
        _bwd_rows_close(x[1], y[1], BWD_ROW_LIMIT[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_launches_the_backward_kernels(gpu, dtype):
    """Under autograd the cuda tier's K5 is its op's autograd: one forward
    launch (with the lse), two backward launches, the gradients those of
    the plain versions; without a gradient the launch is the serving
    path's, bit for bit."""
    gen = torch.Generator(device=gpu).manual_seed(3)
    q, k, v = (torch.randn(shp, generator=gen, device=gpu).to(dtype)
               .requires_grad_() for shp in ((1, 8, 200, 256),
                                            (1, 4, 200, 256),
                                            (1, 4, 200, 256)))
    dout = torch.randn((1, 8, 200, 256), generator=gen, device=gpu).to(dtype)
    n = (k5.flash_attention.launches, k5.flash_attention_bwd.launches)
    out = ops.flash_attention(q, k, v, window=64, softcap=50.0,
                              backend="cuda")
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert (k5.flash_attention.launches - n[0],
            k5.flash_attention_bwd.launches - n[1]) == (1, 2)
    with torch.no_grad():
        assert torch.equal(out, ops.flash_attention(
            q, k, v, window=64, softcap=50.0, backend="cuda"))
        o, lse = k5.flash_attention(q, k, v, window=64, softcap=50.0,
                                    return_lse=True)
        want = _bwd_plain_for(dtype, q, k, v, o, lse, dout, None, window=64,
                              softcap=50.0)
    for x, y in zip(grads, want):
        _bwd_rows_close(x, y, BWD_ROW_LIMIT[dtype])


def test_unembed_bf16_gradient_matches_f32(gpu):
    """The bf16 logits' f32 product has a gradient: the f32 output
    gradient times the other operand in f32, rounded once to bf16 --
    autograd through the f32 product of the same (exact) values."""
    gen = torch.Generator(device=gpu).manual_seed(7)
    x = torch.randn((64, 128), generator=gen, device=gpu).bfloat16()
    table = torch.randn((1000, 128), generator=gen, device=gpu).bfloat16()
    g = torch.randn((64, 1000), generator=gen, device=gpu)
    xa, ta = x.clone().requires_grad_(), table.clone().requires_grad_()
    out = layers.unembed(ta, xa)
    assert out.dtype == torch.float32
    dx, dt = torch.autograd.grad(out, (xa, ta), g)
    xb, tb = x.float().requires_grad_(), table.float().requires_grad_()
    wx, wt = torch.autograd.grad(xb @ tb.t(), (xb, tb), g)
    _close(out, (xb @ tb.t()).detach())
    assert dx.dtype == dt.dtype == torch.bfloat16
    _close(dx, wx.bfloat16(), BF16_TOL)
    _close(dt, wt.bfloat16(), BF16_TOL)


def test_lm_loss_on_the_card_matches_the_torch_tier(gpu):
    """A reduced f32 gemma2's loss and gradients through K5 and its
    backward against the torch tier's, each leaf within 1e-4 of its
    largest magnitude; K5 launched once forward and twice backward a
    layer."""
    cfg = dataclasses.replace(gemma2_9b.reduced(), dtype="float32")
    model = ttr.init_lm(cfg, generator=torch.Generator(
        device=gpu).manual_seed(0), device=gpu)
    gen = np.random.default_rng(0)
    toks = torch.as_tensor(gen.integers(0, cfg.vocab_size, (2, 40)),
                           device=gpu)
    labels = torch.roll(toks, -1, 1)
    params = list(model.parameters())
    n = (k5.flash_attention.launches, k5.flash_attention_bwd.launches)
    loss, _ = ttr.lm_loss(model, toks, labels)
    grads = torch.autograd.grad(loss, params)
    assert (k5.flash_attention.launches - n[0],
            k5.flash_attention_bwd.launches - n[1]) == \
        (cfg.num_layers, 2 * cfg.num_layers)
    want_loss, _ = ttr.lm_loss(model, toks, labels, attn_impl="torch")
    want = torch.autograd.grad(want_loss, params)
    assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item())
    for g, w in zip(grads, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_flash_kernel_refuses_gradients_and_bad_input(gpu):
    """A direct launch has no backward and refuses a tensor that wants a
    gradient; the wrapper goes through K5's op, whose Autograd kernel runs
    the backward kernels.  Bad input raises either way."""
    q = torch.randn((1, 2, 8, 64), device=gpu, requires_grad=True)
    k = torch.randn((1, 1, 8, 64), device=gpu)
    with pytest.raises(RuntimeError, match="no backward"):
        k5._launch(q, k, k)
    out = k5.flash_attention(q, k, k)
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())
    with torch.no_grad():
        k5.flash_attention(q, k, k)
        with pytest.raises(ValueError, match="contiguous"):
            k5.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                               k, k)
        with pytest.raises(ValueError, match="head dim"):
            k5.flash_attention(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               k[..., :48].contiguous())
        with pytest.raises(TypeError):
            k5.flash_attention(q.half(), k.half(), k.half())
        with pytest.raises(ValueError, match="terms"):
            k5._launch(q, k, k, terms=2)
        with pytest.raises(ValueError, match="terms"):
            k5._launch(q.bfloat16(), k.bfloat16(), k.bfloat16(), terms=1)


#: seamless-m4t-medium's attention at small sizes: D 64, group 1 (MHA),
#: non-causal with Sq < Sk (a prefill's cross-attention), Sq > Sk, Sq = 1
#: (a decode step's), and the encoder's Sq = Sk, off the 64-row tiles
ENCDEC_SHAPES = [
    (2, 4, 4, 100, 300, False),
    (1, 4, 4, 300, 100, False),
    (2, 4, 4, 1, 500, False),
    (1, 2, 2, 130, 130, False),
    (2, 4, 4, 200, 200, True),
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal", ENCDEC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_encdec_shapes_match_plain(gpu, b, hq, hkv, sq, sk, causal,
                                         dtype):
    """K5 forward and both backward kernels at seamless-like shapes
    against the plain versions: the right alignment (kv_len - Sq) must
    mask nothing without ``causal``; forward within the band and the
    per-row limit, backward within the per-row limit (f32 also the
    relative Frobenius limit) of the plain version (in f64 for f32)."""
    d = 64
    gen = torch.Generator(device=gpu).manual_seed(sq * 7 + sk)
    q, dout = (torch.randn((b, hq, sq, d), generator=gen, device=gpu)
               .to(dtype) for _ in range(2))
    k, v = (torch.randn((b, hkv, sk, d), generator=gen, device=gpu)
            .to(dtype) for _ in range(2))
    n = (k5.flash_attention.launches, k5.flash_attention_bwd.launches)
    key = k5.launch_key(q, k, causal, 0, 0.0)
    by = (k5.flash_attention.by_shape[key],
          k5.flash_attention_bwd.by_shape[key])
    out, lse = k5.flash_attention(q, k, v, causal=causal, return_lse=True)
    want = k5.flash_attention_plain(q, k, v, causal=causal)
    _close(out, want, TOL if dtype == torch.float32 else BF16_TOL)
    _rows_close(out, want, ROW_LIMIT[dtype])
    if not causal:   # every query sees every key: SDPA's function too
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            q.float(), k.float(), v.float())
        _close(out, sdpa, TOL if dtype == torch.float32 else BF16_TOL)
    got = k5.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    assert (k5.flash_attention.launches - n[0],
            k5.flash_attention_bwd.launches - n[1]) == (1, 2)
    # the launches by shape count the same launches under this shape's key
    assert (k5.flash_attention.by_shape[key] - by[0],
            k5.flash_attention_bwd.by_shape[key] - by[1]) == (1, 2)
    ref = _bwd_plain_for(dtype, q, k, v, out, lse, dout, None,
                         causal=causal)
    for x, y in zip(got, ref):
        assert x.dtype == dtype and x.shape == y.shape
        _bwd_rows_close(x, y, BWD_ROW_LIMIT[dtype])
    if dtype == torch.float32:
        assert _bwd_rel_errs(got, ref)[1] <= BWD_FRO_LIMIT_F32


def _encdec_case(gpu, dtype="float32"):
    cfg = dataclasses.replace(seamless_m4t_medium.reduced(), dtype=dtype)
    model = encdec.init_encdec(cfg, generator=torch.Generator(
        device=gpu).manual_seed(0), device=gpu)
    gen = np.random.default_rng(0)
    frames = torch.as_tensor(gen.standard_normal((2, 80, cfg.d_model)),
                             dtype=torch.float32, device=gpu)
    toks = torch.as_tensor(gen.integers(0, cfg.vocab_size, (2, 40)),
                           device=gpu)
    return cfg, model, frames, toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_encdec_prefill_matches_torch_tier(gpu, dtype):
    """The reduced seamless on the cuda tier: a prefill launches K5 once
    per encoder layer, decoder self-attention and cross-attention, a
    decode step once per cross-attention; logits against the torch
    tier's in the dtype's band."""
    cfg, model, frames, toks = _encdec_case(gpu, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    with torch.inference_mode():
        n = k5.flash_attention.launches
        lg, caches, memory, length = encdec.encdec_prefill(
            model, frames, toks[:, :39], 48)
        assert k5.flash_attention.launches - n == \
            cfg.encoder_layers + 2 * cfg.num_layers
        want, wc, wm, wl = encdec.encdec_prefill(model, frames, toks[:, :39],
                                                 48, attn_impl="torch")
        _close(lg, want, tol)
        n = k5.flash_attention.launches
        lg2, _, _ = encdec.encdec_decode_step(model, toks[:, 39:], caches,
                                              memory, length)
        assert k5.flash_attention.launches - n == cfg.num_layers
        want2, _, _ = encdec.encdec_decode_step(model, toks[:, 39:], wc, wm,
                                                wl, attn_impl="torch")
        _close(lg2, want2, tol)


def test_reduced_encdec_gradients_match_torch_tier(gpu):
    """``encdec_loss`` through K5 and its backward kernels (the
    checkpointed layers run K5's forward twice) against the torch tier:
    the loss, and each gradient leaf within 1e-4 of its largest
    magnitude."""
    cfg, model, frames, toks = _encdec_case(gpu)
    labels = torch.roll(toks, -1, 1)
    params = list(model.parameters())
    n = (k5.flash_attention.launches, k5.flash_attention_bwd.launches)
    loss, _ = encdec.encdec_loss(model, frames, toks, labels)
    grads = torch.autograd.grad(loss, params)
    n_attn = cfg.encoder_layers + 2 * cfg.num_layers
    assert (k5.flash_attention.launches - n[0],
            k5.flash_attention_bwd.launches - n[1]) == (2 * n_attn,
                                                        2 * n_attn)
    want_loss, _ = encdec.encdec_loss(model, frames, toks, labels,
                                      attn_impl="torch")
    want = torch.autograd.grad(want_loss, params)
    assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item())
    for g, w in zip(grads, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_reduced_gemma2_cuda_tier_matches_torch_tier(gpu):
    cfg = dataclasses.replace(gemma2_9b.reduced(), dtype="float32")
    model = ttr.TransformerLM(cfg, device=gpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=gpu,
                         generator=torch.Generator(device=gpu).manual_seed(1))
    n = k5.flash_attention.launches
    with torch.inference_mode():
        got = ttr.lm_forward(model, toks)
        assert k5.flash_attention.launches == n + cfg.num_layers
        _close(got, ttr.lm_forward(model, toks, attn_impl="torch"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_internvl_image_prompt_on_the_card(gpu, dtype):
    """Reduced internvl2-1b's image+prompt path on the cuda tier against
    the torch tier on the CPU, the same weights and inputs: a prefill of
    NUM_PATCH_TOKENS patch embeddings and a 21-token prompt through
    ``make_prefill_step`` (K5 once a layer, over patches + prompt), then 3
    ``make_decode_step``s of the torch tier's greedy tokens (no K5
    launch); each step's logits in the dtype's band."""
    from repro_torch.configs import internvl2_1b
    from repro_torch.launch import steps
    from repro_torch.models import vlm
    cfg = dataclasses.replace(internvl2_1b.reduced(), dtype=dtype)
    model = ttr.TransformerLM(cfg, device=gpu)
    cpu = ttr.TransformerLM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    embeds = vlm.stub_patch_embeds(torch.Generator().manual_seed(0), 2, cfg,
                                   device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 21),
                         generator=torch.Generator().manual_seed(1))
    size = internvl2_1b.NUM_PATCH_TOKENS + 21 + 3
    tol = TOL if dtype == "float32" else BF16_TOL
    batch = {"embeds": embeds, "tokens": toks}
    with torch.inference_mode():
        n = k5.flash_attention.launches
        lg, caches, length = steps.make_prefill_step(cfg, size)(model, batch)
        assert k5.flash_attention.launches - n == cfg.num_layers
        want, wc, wl = steps.make_prefill_step(cfg, size)(cpu, batch)
        _close(lg.cpu(), want, tol)
        assert int(length) == int(wl) == size - 3
        decode = steps.make_decode_step(cfg)
        tok = want[:, -1].argmax(-1, keepdim=True)
        for _ in range(3):
            n = k5.flash_attention.launches
            lg, caches, length = decode(model, {
                "token": tok, "caches": caches, "length": length})
            assert k5.flash_attention.launches == n
            want, wc, wl = decode(cpu, {"token": tok, "caches": wc,
                                        "length": wl})
            _close(lg.cpu(), want, tol)
            tok = want[:, -1].argmax(-1, keepdim=True)


def _compiled_case(card, name, fused, seed=0):
    spec, g, x = card
    m = make_paper_model(name, spec, device="cuda", fused=fused,
                         generator=torch.Generator().manual_seed(seed))
    return m, m.plan_for(g), g, x


@pytest.mark.parametrize("name", ["gcn", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_captured_plan_bitwise_equal_eager(card, name, fused):
    """plan.compile() on the cuda tier: one CUDA graph, every replay equal
    to the eager forward bit for bit (K1 and K2 have no atomics); the
    capture records the eager forward's launches, a replay moves no
    counter."""
    m, plan, g, x = _compiled_case(card, name, fused)
    before = ops.launch_counts()
    with torch.no_grad():
        eager = plan.run_model(m.tree(), x)
    launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
    assert launched["fused_agg_combine" if fused else "seg_agg"] == 2
    fn = tplan.CompiledPlan(plan)
    with torch.no_grad():
        outs = [fn(m.tree(), x) for _ in range(5)]
        counts = ops.launch_counts()
        outs += [fn(m.tree(), x) for _ in range(3)]
    assert ops.launch_counts() == counts
    assert all(torch.equal(o, eager) for o in outs)
    assert (fn.num_traces, fn.num_replays) == (1, 7)
    assert fn.capture_launches == launched
    for i in range(plan.num_layers):       # each layer on its own
        sub = m.tree()[f"conv{i}"]
        h = x if i == 0 else torch.relu(want)
        with torch.no_grad():
            want = plan.run_layer(sub, h, layer=i)
        fl = tplan.CompiledPlan(plan, layer=i)
        with torch.no_grad():
            assert all(torch.equal(fl(sub, h), want) for _ in range(3))


@torch.no_grad()
def test_captured_plan_sees_new_parameters_and_donates(card):
    m, plan, g, x = _compiled_case(card, "sage", False, seed=4)
    fn = tplan.CompiledPlan(plan)
    fn(m.tree(), x)
    first = fn(m.tree(), x)
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(-0.5).add_(0.01)
        want = plan.run_model(m.tree(), x)
    got = fn(m.tree(), x)
    assert torch.equal(got, want) and not torch.equal(got, first)
    assert fn.num_traces == 1
    # donate=True hands out the graph's own output buffer: the next replay
    # overwrites it; without donation every call returns a fresh copy
    fd = tplan.CompiledPlan(plan, donate=True)
    fd(m.tree(), x)
    a = fd(m.tree(), x)
    assert torch.equal(a, want)
    assert fd(m.tree(), x).data_ptr() == a.data_ptr()
    assert fn(m.tree(), x).data_ptr() != got.data_ptr()


def test_dynamic_torch_tier_on_card(card):
    """compile(dynamic=True) on the card's torch tier: a second graph of
    the same V and E with no recapture, within the f32 band of eager (the
    torch tier adds with index_add_'s float atomics)."""
    spec, g, x = card
    m = make_paper_model("gcn", spec, backend="torch", device="cuda")
    plan = m.plan_for(g, fused=False)
    g2 = make_synthetic_graph(spec, seed=9, device="cuda")
    fn = tplan.CompiledPlan(plan, dynamic=True)
    with torch.no_grad():
        want = plan.run_model(m.tree(), x, graph=g2)
        for graph in (g, g2, g2):
            got = fn(m.tree(), x, graph)
    _close(got, want)
    assert (fn.num_traces, fn.num_replays) == (1, 2)


def test_serve_engine_captured_decode_matches_eager(gpu):
    """ServeEngine on a card captures its decode step once and gives the
    eager decode's greedy tokens for every request."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = gemma2_9b.reduced()
    model = ttr.TransformerLM(cfg, device=gpu)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 17, 9, 30)]

    def serve(decode_graph):
        eng = ServeEngine(cfg, model, max_batch=2, cache_size=64,
                          decode_graph=decode_graph)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=6))
        return eng, {r.rid: r.output for r in eng.run()}

    eng, got = serve(True)
    ref, want = serve(False)
    assert got == want and all(len(o) == 6 for o in got.values())
    assert (eng.decode_captures, eng.decode_replays) == \
        (1, eng.stats()["decode_steps"] - 1)
    assert (ref.decode_captures, ref.decode_replays) == (0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_ffn_on_the_card_matches_cpu(gpu, dtype, dropless):
    """``moe_ffn`` at a reduced size (16 experts, top-2, a dense residual,
    a router skewed so that expert 0 overflows and drops) on the card
    against the same layer on the CPU: the same routes and drops, the
    output in the dtype's band, aux within 1e-6; a repeat on the card bit
    for bit (the gather dispatch and the ordered combine use no atomics),
    and the dropless layer captured as a CUDA graph (no host sync) bit for
    bit its eager call."""
    cfg = MoEConfig(num_experts=16, top_k=2, expert_d_ff=96,
                    dense_residual=True, dense_residual_d_ff=64)
    cpu = moe.MoE(64, cfg, "swiglu", dtype=dtype, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.router[:, 0] += 0.05
    on_card = moe.MoE(64, cfg, "swiglu", dtype=dtype, device=gpu,
                   generator=torch.Generator(device=gpu).manual_seed(0))
    on_card.load_state_dict(cpu.state_dict())
    gen = np.random.default_rng(0)
    x = torch.as_tensor(gen.standard_normal((4, 40, 64)) + 0.5,
                        dtype=torch.float32).to(dtype)
    xg = x.to(gpu)
    with torch.no_grad():
        want, want_aux = cpu(x, dropless=dropless)
        got, aux = on_card(xg, dropless=dropless)
        again, _ = on_card(xg, dropless=dropless)
        ids = moe.route(cpu.router, x.reshape(-1, 64), 2)[2]
        ids_g = moe.route(on_card.router, xg.reshape(-1, 64), 2)[2]
    assert torch.equal(ids_g.cpu(), ids)
    keep = moe.dispatch(ids, 16, moe.slots(cfg, 160, dropless))[3]
    assert bool(keep.all()) == dropless
    assert torch.equal(got, again)
    _close(got.cpu(), want, TOL if dtype == torch.float32 else BF16_TOL)
    assert abs(aux.item() - want_aux.item()) <= 1e-6
    if dropless:
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad():
            on_card(xg, dropless=True)       # warm-up
            with tplan.capture_graph(graph):
                captured, _ = on_card(xg, dropless=True)
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, got)


def test_moe_serve_engine_captured_decode_matches_eager(gpu):
    """Reduced arctic-480b (bf16, MoE with a dense residual) through the
    ServeEngine on the card: K5 once per layer a prefill, none in decode;
    the decode step captured once, its greedy tokens the eager decode's."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = arctic_480b.reduced()
    model = ttr.TransformerLM(cfg, device=gpu)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 17, 9, 30)]

    def serve(decode_graph):
        eng = ServeEngine(cfg, model, max_batch=2, cache_size=64,
                          decode_graph=decode_graph)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=6))
        n = k5.flash_attention.launches
        out = {r.rid: r.output for r in eng.run()}
        return eng, out, k5.flash_attention.launches - n

    eng, got, launches = serve(True)
    ref, want, _ = serve(False)
    assert launches == cfg.num_layers * len(prompts)
    assert got == want and all(len(o) == 6 for o in got.values())
    assert (eng.decode_captures, eng.decode_replays) == \
        (1, eng.stats()["decode_steps"] - 1)


def test_ssd_chunked_on_the_card_matches_the_oracle(gpu):
    """mamba2-2.7b's head shape (B 1, S 1024, H 80, P 64, G 1, N 128, chunk
    256): the chunked scan against the sequential oracle on the card in f32
    at the reference's limits (rtol 1e-4, atol 1e-5), y and the final
    state; with a bf16 compute_dtype in the bf16 band of that f32 run."""
    gen = torch.Generator(device=gpu).manual_seed(0)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=gpu) * scale
    b, s, h, p, g, n = 1, 1024, 80, 64, 1, 128
    x, bm, cm = draw(b, s, h, p), draw(b, s, g, n, scale=0.3), \
        draw(b, s, g, n, scale=0.3)
    dt = torch.rand((b, s, h), generator=gen, device=gpu) * 0.5 + 0.01
    a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device=gpu)))
    cfg = mamba2_2_7b.config().ssm
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        y, st = mamba2.ssd_chunked(x, bm, cm, dt, a, cfg32)
        oy, ost = mamba2.ssd_reference(x, bm, cm, dt, a)
        y16, st16 = mamba2.ssd_chunked(x.bfloat16(), bm.bfloat16(),
                                       cm.bfloat16(), dt, a, cfg)
    torch.cuda.synchronize()
    for got, want in ((y, oy), (st, ost)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert y16.dtype == st16.dtype == torch.float32
    for got, want in ((y16, y), (st16, st)):
        torch.testing.assert_close(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def _decode_replay_bitwise_eager(model, token, caches, length):
    """One decode step captured as a CUDA graph and replayed, against the
    eager step from the same caches: logits and every cache tensor bit for
    bit."""
    with torch.inference_mode():
        saved = [tuple(t.clone() for t in c) for c in caches]

        def restore():
            for c, c0 in zip(caches, saved):
                for t, t0 in zip(c, c0):
                    t.copy_(t0)
        ttr.lm_decode_step(model, token, caches, length)      # warm-up
        restore()
        eager = ttr.lm_decode_step(model, token, caches, length)[0].clone()
        after = [tuple(t.clone() for t in c) for c in caches]
        restore()
        graph = torch.cuda.CUDAGraph()
        with tplan.capture_graph(graph):
            logits = ttr.lm_decode_step(model, token, caches, length)[0]
        restore()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(logits, eager)
    assert all(torch.equal(t, t0) for c, c0 in zip(caches, after)
               for t, t0 in zip(c, c0))


def test_ssm_serve_engine_captured_decode_matches_eager(gpu):
    """Reduced mamba2-2.7b (bf16, every layer a Mamba-2 block) through the
    ServeEngine on the card: no K5 launch, the decode step captured once
    over the SSM caches, its greedy tokens the eager decode's, 1- and
    2-token prompts among them; a replay bit for bit the eager step."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = mamba2_2_7b.reduced()
    model = ttr.TransformerLM(cfg, device=gpu)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (1, 17, 2, 40)]

    def serve(decode_graph):
        eng = ServeEngine(cfg, model, max_batch=2, cache_size=64,
                          decode_graph=decode_graph)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_tokens=6))
        n = k5.flash_attention.launches
        out = {r.rid: r.output for r in eng.run()}
        return eng, out, k5.flash_attention.launches - n

    eng, got, launches = serve(True)
    ref, want, _ = serve(False)
    assert launches == 0
    assert got == want and all(len(o) == 6 for o in got.values())
    assert (eng.decode_captures, eng.decode_replays) == \
        (1, eng.stats()["decode_steps"] - 1)
    token = torch.as_tensor(eng._last_tokens, device=gpu)
    _decode_replay_bitwise_eager(model, token, eng._caches, eng._length)


def test_hybrid_captured_decode_step_bitwise_eager(gpu):
    """Reduced jamba-1.5-large (attention at layer 4, MoE at odd layers,
    SSM elsewhere) on the card: a decode step over zeroed caches of both
    kinds (no prefill, so no K5 launch at the reduced head_dim 16),
    captured and replayed bit for bit its eager step, the K/V rows, states
    and conv tails included."""
    cfg = jamba_1_5_large.reduced()
    model = ttr.TransformerLM(cfg, device=gpu)
    caches = ttr.init_caches(cfg, 2, 32, device=gpu)
    assert caches[4][0].dtype == torch.bfloat16
    assert caches[0][0].dtype == torch.float32
    token = torch.as_tensor([[3], [7]], device=gpu)
    length = torch.zeros((2,), dtype=torch.int32, device=gpu)
    n = k5.flash_attention.launches
    _decode_replay_bitwise_eager(model, token, caches, length)
    assert k5.flash_attention.launches == n
    assert any(c[1].any() for c in caches[:4])     # the steps moved them


def test_mamba2_at_full_width_on_the_card(gpu):
    """The published mamba2-2.7b (64 layers, d_model 2560) builds on the
    card: every parameter there, the projections in bf16, A_log and the
    other f32 leaves in f32, the analytic count plus the padded vocabulary
    rows, the norm scales, conv_b and dt_bias."""
    from repro_torch.config import get_config
    cfg = get_config("mamba2-2.7b")
    model = ttr.TransformerLM(cfg)
    params = list(model.parameters())
    assert all(p.device == gpu for p in params)
    s = cfg.ssm
    extra = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model \
        + (cfg.num_layers + 1) * cfg.d_model + cfg.num_layers * (
            mamba2.conv_dim(cfg.d_model, s) + s.n_heads(cfg.d_model))
    assert sum(p.numel() for p in params) == cfg.param_count() + extra
    blk = model.layers[0].ssm
    assert blk.z_proj.dtype == torch.bfloat16
    assert blk.A_log.dtype == blk.dt_bias.dtype == torch.float32
    del model, params, blk
    torch.cuda.empty_cache()


def test_capture_failure_raises(card, monkeypatch):
    """A forward that syncs with the host cannot be captured: the capture
    raises, nothing is cached, and no eager result stands in for it."""
    from repro_torch.core import phases
    m, plan, g, x = _compiled_case(card, "gcn", False)
    mm = phases._mm
    monkeypatch.setattr(phases, "_mm",
                        lambda a, b: mm(a, b) * (a.abs().sum().item() >= 0))
    fn = tplan.CompiledPlan(plan)
    with pytest.raises(RuntimeError):
        fn(m.tree(), x)
    assert fn.num_traces == 1 and not fn._traces


# ---------------------------------------------------------------------------
# bf16 instances of K1 and K2, and the planner's other decisions on the card
# ---------------------------------------------------------------------------


def _offset(x, k):
    """A contiguous copy of ``x`` starting ``k`` elements into a buffer, so
    that its address is only ``k * element_size`` aligned (for k = 1, 2:
    2- or 4-byte aligned bf16)."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = buf[k:k + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("f", [1, 7, 41, 128, 602])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_agg_bf16_matches_plain(card, f, offset, weighted):
    """K1 in bf16 over a ragged layout (an empty block, rows without
    edges), x offset so rows are only 2- or 4-byte aligned: bf16 out,
    within the bf16 band and one bf16 ulp a row, two launches bitwise
    equal, the empty block exactly 0, launches counted under bf16."""
    bg = _ragged_layout()
    gen = torch.Generator(device="cuda").manual_seed(f + offset)
    x = _offset(torch.randn((bg.num_vertices, f), generator=gen,
                            device="cuda").to(torch.bfloat16), offset)
    w = torch.rand(bg.src.shape, generator=gen, device="cuda") \
        if weighted else None
    args = (x, bg.src, bg.dstl, bg.mask, w)
    n, nb = k1.seg_agg.launches, k1.seg_agg.launches_bf16
    got = k1.seg_agg(*args, tile_m=bg.tile_m)
    again = k1.seg_agg(*args, tile_m=bg.tile_m)
    assert (k1.seg_agg.launches, k1.seg_agg.launches_bf16) == (n + 2, nb + 2)
    want = k1.seg_agg_plain(*args, tile_m=bg.tile_m)
    assert got.dtype == want.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
    _rows_close(got, want, AGG_BF16_ROW_LIMIT)
    assert torch.equal(got, again)
    assert not got[bg.tile_m:2 * bg.tile_m].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_agg_over_dedup_rows(card, dtype):
    """A dedup plan's level-2 layout gathers from the V + P rows of
    [x ; partials]; K1 in both dtypes against its plain version."""
    from repro_torch.graph.dedup import attach_blocked, dedup_layout_for_graph
    spec, g, x = card
    lay = attach_blocked(dedup_layout_for_graph(g), 128)
    assert lay.num_pairs > 0
    xp = torch.cat([x, x[lay.pair_left.long()] + x[lay.pair_right.long()]])
    xp = xp.to(dtype)
    got = ops.seg_agg_planned(lay.blocked, xp, backend="cuda")
    want = ops.seg_agg_planned(lay.blocked, xp, backend="torch")
    assert got.shape == (g.num_vertices, x.shape[1]) and got.dtype == dtype
    tol, row = (TOL, 3e-5) if dtype == torch.float32 else \
        (BF16_TOL, AGG_BF16_ROW_LIMIT)
    _close(got, want, tol)
    _rows_close(got, want, row)


@pytest.mark.parametrize("pair", ["bf16", "mixed"])
@pytest.mark.parametrize("tile_m,nblocks,fi,fo", [
    (32, 7, 602, 128), (32, 7, 128, 41), (32, 9, 128, 128), (64, 5, 41, 7),
    (128, 3, 1433, 128), (256, 3, 602, 41), (48, 5, 7, 300),
    (16, 13, 128, 256)])
def test_fused_bf16_matches_plain(card, pair, tile_m, nblocks, fi, fo):
    """K2 with a bf16 W: (bf16 x, bf16 W) and (f32 x, bf16 W), the output
    bf16; its edges as for f32 (blocks a CTA, padded rows, K tails, N
    padding, F_out past 128); within the bf16 band and one bf16 ulp a row,
    two launches bitwise equal, an empty block 0, the indices read from L2
    giving the same sums."""
    bg, (x, src, dstl, mask, w) = _fused_case(tile_m, nblocks, fi, fo,
                                              fi + fo + tile_m)
    w = w.to(torch.bfloat16)
    if pair == "bf16":
        x = x.to(torch.bfloat16)
    args = (x, src, dstl, mask, w)
    n, nb = k2.fused_agg_combine.launches, k2.fused_agg_combine.launches_bf16
    got = k2.fused_agg_combine(*args, tile_m=bg.tile_m)
    again = k2.fused_agg_combine(*args, tile_m=bg.tile_m)
    assert (k2.fused_agg_combine.launches,
            k2.fused_agg_combine.launches_bf16) == (n + 2, nb + 2)
    want = k2.fused_agg_combine_plain(*args, tile_m=bg.tile_m)
    assert got.dtype == want.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
    _rows_close(got, want, AGG_BF16_ROW_LIMIT)
    assert torch.equal(got, again)
    assert not got[tile_m:2 * tile_m].any()
    assert torch.equal(got, k2._launch(*args, bg.tile_m, cap=0))


@pytest.mark.parametrize("offset", [1, 2])
def test_fused_bf16_unaligned_x(card, offset):
    """bf16 x whose rows are 2- or 4-byte aligned: narrower loads, the
    same sums as an aligned copy, bit for bit."""
    bg, (x, src, dstl, mask, w) = _fused_case(32, 7, 41, 41, 13)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    want = k2.fused_agg_combine(x, src, dstl, mask, w, tile_m=32)
    got = k2.fused_agg_combine(_offset(x, offset), src, dstl, mask, w,
                               tile_m=32)
    assert torch.equal(got, want)


def test_fused_refuses_other_pairs(card):
    bg, (x, src, dstl, mask, w) = _fused_case(32, 3, 64, 8, 2)
    with pytest.raises(TypeError, match="W torch.float32"):
        k2.fused_agg_combine(x.to(torch.bfloat16), src, dstl, mask, w,
                             tile_m=32)
    with pytest.raises(TypeError):
        k1.seg_agg(x.half(), src, dstl, mask, tile_m=32)


DECISIONS = {"bf16": {"dtype": "bf16"}, "int8": {"dtype": "int8-agg"},
             "degree": {"reorder": "degree"}, "pairs": {"dedup": "pairs"},
             "all": {"dtype": "bf16", "reorder": "degree", "dedup": "pairs"}}


@pytest.mark.parametrize("case", list(DECISIONS))
@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_decision_plans_cuda_tier_match_torch_tier(card, case, name, fused):
    """Each decision's cuda plan against the same plan on the torch tier
    on the card, in its dtype's band; the bf16 plans launch the bf16
    instances (the fused dedup layer the mixed pair), the others f32."""
    spec, g, x = card
    kw = DECISIONS[case]
    m = make_paper_model(name, spec, device="cuda", fused=fused,
                         generator=torch.Generator().manual_seed(0))
    plan = m.plan_for(g, **kw)
    before = ops.launch_counts()
    with torch.no_grad():
        got = m(g, x, plan=plan)
        launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
        want = m(g, x, plan=m.plan_for(g, backend="torch", **kw))
    kern = "fused_agg_combine" if fused else "seg_agg"
    bf16 = kw.get("dtype") == "bf16"
    assert launched[kern] == 2
    # the unfused dedup bf16 layer aggregates [x ; partials] in f32
    assert launched[kern + "_bf16"] == (
        2 if bf16 and (fused or "dedup" not in kw) else 0)
    _close(got, want, {"bf16": BF16_TOL, "int8-agg": INT8_TOL}.get(
        kw.get("dtype"), TOL))


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_dedup_f32_plan_bitwise_naive_on_cuda(card, name, fused):
    """The cuda tier folds each row in slot order from its first slot and
    a level-1 partial is one IEEE add: a dedup f32 plan equals the naive
    plan bit for bit."""
    spec, g, x = card
    m = make_paper_model(name, spec, device="cuda", fused=fused,
                         generator=torch.Generator().manual_seed(1))
    plan = m.plan_for(g, dedup="pairs")
    assert plan.dedup == "pairs" and plan.dedup_layout.num_pairs > 0
    with torch.no_grad():
        assert torch.equal(m(g, x, plan=plan), m(g, x))


def test_unplanned_cuda_aggregation(card):
    """The cuda tier without a plan's layout regroups on the host per call
    (ops.seg_agg) and gives the torch tier's sums; seg_agg_pregrouped
    sorts any slot order into the kernel's."""
    from repro_torch.core import phases
    spec, g, x = card
    for dtype in (torch.float32, torch.bfloat16):
        xx = x.to(dtype)
        got = phases.aggregate(g, xx, op="mean", backend="cuda")
        want = phases.aggregate(g, xx, op="mean", backend="torch")
        _close(got, want, TOL if dtype == torch.float32 else BF16_TOL)
    bg = _ragged_layout(v=300, tile_m=32)
    gen = torch.Generator(device="cuda").manual_seed(5)
    perm = torch.argsort(torch.rand(bg.src.shape, generator=gen,
                                    device="cuda"), dim=1)
    rows = torch.randn((*bg.src.shape, 24), generator=gen, device="cuda")
    seg = torch.gather(bg.dstl, 1, perm)
    mask = torch.gather(bg.mask, 1, perm)
    _close(ops.seg_agg_pregrouped(rows, seg, mask, 32, backend="cuda"),
           ops.seg_agg_pregrouped(rows, seg, mask, 32, backend="torch"))


def test_unblocked_dedup_layout_launches_k1(card):
    """A dedup layout no plan blocked, passed to ``phases.aggregate`` or
    to ``run_layer`` on a cuda plan, still runs its level-2 sum through
    K1 (regrouped on the host per call), and in f32 equals the naive fold
    bit for bit."""
    from repro_torch.core import phases
    from repro_torch.graph.dedup import dedup_layout_for_graph
    spec, g, x = card
    lay = dedup_layout_for_graph(g)
    assert lay.blocked is None and lay.num_pairs > 0
    before = ops.launch_counts()["seg_agg"]
    got = phases.aggregate(g, x, op="sum", backend="cuda", dedup=lay)
    assert ops.launch_counts()["seg_agg"] == before + 1
    assert torch.equal(got, phases.aggregate(g, x, op="sum", backend="cuda"))
    m = make_paper_model("gcn", spec, device="cuda",
                         generator=torch.Generator().manual_seed(1))
    plan = m.plan_for(g)
    assert plan.layers[0].backend == "cuda" and not plan.layers[0].fused
    with torch.no_grad():
        before = ops.launch_counts()["seg_agg"]
        h = plan.run_layer(m.tree()["conv0"], x, layer=0, dedup_layout=lay)
        assert ops.launch_counts()["seg_agg"] == before + 1
        assert torch.equal(h, plan.run_layer(m.tree()["conv0"], x, layer=0))


@pytest.mark.parametrize("case", list(DECISIONS))
@pytest.mark.parametrize("fused", [False, True])
def test_captured_decision_plans_bitwise_equal_eager(card, case, fused):
    """plan.compile() of reorder, bf16, int8-agg and dedup plans: the
    permutation gathers, casts and pair partials are captured, and every
    replay equals the eager forward bit for bit."""
    spec, g, x = card
    m = make_paper_model("gin" if fused else "gcn", spec, device="cuda",
                         fused=fused,
                         generator=torch.Generator().manual_seed(2))
    plan = m.plan_for(g, **DECISIONS[case])
    with torch.no_grad():
        eager = plan.run_model(m.tree(), x)
    fn = tplan.CompiledPlan(plan)
    with torch.no_grad():
        outs = [fn(m.tree(), x) for _ in range(4)]
    assert all(torch.equal(o, eager) for o in outs)
    assert (fn.num_traces, fn.num_replays) == (1, 3)


# ---------------------------------------------------------------------------
# minibatch training: K1's backward and the trainer on the card
#: K1's long-row layouts, name -> (emax, rows of each block as {row:
#: slots}); T = split_threshold(emax) is 256 at 7,120 slots (phase 11's
#: transposed block 0) and 1,024 at 65,536.  Rows of T, T + 1, T k and
#: T k + 1 slots, a 7,000-slot hub, a 50,000-slot row, an empty block and
#: a block of short rows
_C7, _C64 = 256, 1024
LONG_ROWS = {
    "e7120": (7120, [{0: _C7, 1: _C7 + 1, 2: 2 * _C7, 3: 2 * _C7 + 1,
                      4: 5, 9: 1, 31: 40},
                     {3: 7000, 4: 50, 30: 7},
                     {},
                     {r: 3 for r in range(32)}]),
    "e65536": (65536, [{0: _C64, 1: _C64 + 1, 2: 3 * _C64,
                        3: 3 * _C64 + 1, 4: 7000, 5: 2},
                       {7: 50000, 8: 20},
                       {r: r for r in range(32)}]),
}


def _long_row_layout(name, v=3000, tile_m=32, seed=0):
    """``LONG_ROWS[name]`` as a blocked layout on the card (sources drawn
    at random from ``v`` rows), its rows' lengths, and its T."""
    emax, blocks = LONG_ROWS[name]
    rng = np.random.default_rng(seed)
    lengths = np.zeros(len(blocks) * tile_m, np.int64)
    for b, rows in enumerate(blocks):
        for r, n in rows.items():
            lengths[b * tile_m + r] = n
    dst = np.repeat(np.arange(len(lengths)), lengths)
    src = rng.integers(0, v, len(dst))
    bg = block_graph_arrays(src, dst, len(lengths), tile_m, device="cuda",
                            emax=emax)
    assert k1.split_threshold(emax) == (_C7 if emax == 7120 else _C64)
    return bg, lengths, k1.split_threshold(emax)


def _in_order(x, bg, w):
    """Each row as one fold in slot order from 0, f32 (numpy, on the
    host): the sum the kernel must give a row of at most T slots, bit for
    bit."""
    xs = x.float().cpu().numpy()
    src, dstl = bg.src.cpu().numpy(), bg.dstl.cpu().numpy()
    mask = bg.mask.cpu().numpy()
    coef = mask if w is None else mask * w.cpu().numpy()
    out = np.zeros((bg.nblocks * bg.tile_m, xs.shape[1]), np.float32)
    for b, e in zip(*np.nonzero(mask)):
        r = b * bg.tile_m + dstl[b, e]
        out[r] = out[r] + coef[b, e] * xs[src[b, e]]
    return torch.from_numpy(out)


@pytest.mark.parametrize("name", ["e7120", "e65536"])
@pytest.mark.parametrize("f", [41, 128])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)])
def test_seg_agg_row_map_matches_plain(card, name, f, dtypes):
    """K1's entries (f32, bf16, bf16 -> f32) with a row map over
    ``LONG_ROWS``: block rows stored to shuffled rows of a sentinel-filled
    output, every fourth block row to none (-1); rows over T stored below
    ``split_from`` folded whole, those at or after it split.  Each stored
    row within K1's per-row limit of the plain version; each row stored
    below ``split_from`` bit for bit one in-order fold, whatever its
    length; the rows no block row names keep the sentinel; two launches
    bit for bit."""
    x_dtype, out_dtype = dtypes
    bg, lengths, t = _long_row_layout(name)
    rows = bg.nblocks * bg.tile_m
    rng = np.random.default_rng(f)
    dest = rng.permutation(rows + 40)[:rows]
    long = np.flatnonzero(lengths > t)
    dest[np.setdiff1d(np.arange(0, rows, 4), long)] = -1
    # half the rows over T stored below split_from, half at or after it
    split_from = int(np.sort(dest[long])[len(long) // 2])
    out_rows = torch.from_numpy(dest.astype(np.int32)).view(
        bg.nblocks, bg.tile_m).cuda()
    gen = torch.Generator(device="cuda").manual_seed(f)
    x = torch.randn((3000, f), generator=gen, device="cuda").to(x_dtype)
    args = (x, bg.src, bg.dstl, bg.mask, None, bg.tile_m, k1.slice_cols(f))

    def launch():
        out = torch.full((rows + 40, f), 7.0, dtype=out_dtype,
                         device="cuda")
        return k1._launch(*args, out_dtype=out_dtype, out=out,
                          out_rows=out_rows, split_from=split_from)
    got = launch()
    assert torch.equal(got, launch())
    want = k1.seg_agg_plain(x, bg.src, bg.dstl, bg.mask, tile_m=bg.tile_m,
                            out_dtype=out_dtype)
    named = torch.from_numpy(dest >= 0)
    to = torch.from_numpy(dest[dest >= 0]).long()
    _rows_close(got.cpu()[to], want.cpu()[named],
                3e-5 if out_dtype == torch.float32 else AGG_BF16_ROW_LIMIT)
    whole = torch.from_numpy((dest >= 0) & (dest < split_from))
    assert bool((torch.from_numpy(lengths) > t)[whole].any())
    ref = _in_order(x, bg, None).to(out_dtype)
    assert torch.equal(got.cpu()[torch.from_numpy(dest[whole.numpy()])
                                 .long()], ref[whole])
    free = torch.ones(rows + 40, dtype=torch.bool)
    free[to] = False
    assert bool((got.cpu()[free] == 7.0).all())


@pytest.mark.parametrize("name", list(LONG_ROWS))
@pytest.mark.parametrize("f", [41, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_agg_long_rows_match_plain(card, name, f, dtype, weighted):
    """K1 over rows of T, T + 1, T k, T k + 1, 7,000 and 50,000 slots:
    each row within K1's per-row limit of the plain version (f32 3e-5,
    bf16 one bf16 ulp); two launches, and one with the backward's CTA
    order, bit for bit; every row of at most T
    slots bit for bit one in-order fold (the dedup contract's rows); the
    empty block exactly 0."""
    bg, lengths, t = _long_row_layout(name)
    gen = torch.Generator(device="cuda").manual_seed(f)
    x = torch.randn((3000, f), generator=gen, device="cuda").to(dtype)
    w = torch.rand(bg.src.shape, generator=gen, device="cuda") \
        if weighted else None
    args = (x, bg.src, bg.dstl, bg.mask, w)
    got = k1.seg_agg(*args, tile_m=bg.tile_m)
    again = k1.seg_agg(*args, tile_m=bg.tile_m)
    want = k1.seg_agg_plain(*args, tile_m=bg.tile_m)
    assert torch.equal(got, again)
    # the backward's CTA order (block by block) gives the same sums
    assert torch.equal(got, k1._launch(*args, bg.tile_m, k1.slice_cols(f),
                                       blocks_first=True))
    _rows_close(got, want, 3e-5 if dtype == torch.float32
                else AGG_BF16_ROW_LIMIT)
    short = torch.from_numpy(lengths <= t)
    ref = _in_order(x, bg, w).to(dtype)
    assert torch.equal(got.cpu()[short], ref[short])
    assert (lengths > t).sum() >= 4
    if name == "e7120":
        assert not got[2 * bg.tile_m:3 * bg.tile_m].any()


def test_seg_agg_capture_over_hub_rows_replays_eager(card):
    """A CUDA graph captured over one long-row layout replays bit for bit
    the eager launch over it, and over another layout of the same shape
    copied into its inputs (the chunk table is read from the layout in
    every launch; the scratch depends on the shapes alone)."""
    bg, _, _ = _long_row_layout("e7120")
    alt = block_graph_arrays(  # the hub moved to another row and block
        *[a.cpu().numpy() for a in _hub_elsewhere(bg)], bg.num_vertices,
        bg.tile_m, device="cuda", emax=bg.emax)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((3000, 64), generator=gen, device="cuda")
    static = [t.clone() for t in (bg.src, bg.dstl, bg.mask)]
    n = k1.seg_agg.launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k1.seg_agg(x, *static, tile_m=bg.tile_m)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k1.seg_agg(x, *static, tile_m=bg.tile_m)
    for lay in (bg, alt, bg):
        for s, t in zip(static, (lay.src, lay.dstl, lay.mask)):
            s.copy_(t)
        graph.replay()
        want = k1.seg_agg(x, lay.src, lay.dstl, lay.mask, tile_m=lay.tile_m)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert k1.seg_agg.launches == n + 5      # warm-up, capture, 3 eager


def _hub_elsewhere(bg):
    """(src, dst) of ``bg``'s edges with each block's rows reversed, so its
    hub and its split rows sit at other rows and slots."""
    m = bg.mask.cpu().numpy() != 0
    b, j = np.nonzero(m)
    dst = b * bg.tile_m + (bg.tile_m - 1 - bg.dstl.cpu().numpy()[b, j])
    src = bg.src.cpu().numpy()[b, j]
    order = np.argsort(dst, kind="stable")
    return torch.from_numpy(src[order]), torch.from_numpy(dst[order])


# ---------------------------------------------------------------------------


def test_k1_backward_matches_plain(card):
    """K1's autograd Function: the x gradient -- K1 over the transposed
    layout, given with the forward one or built on first need -- against
    the plain version's autograd per row (K1's f32 limit), with edge
    weights; launches bit for bit equal; one backward launch a gradient."""
    spec, g, _ = card
    bg = block_graph_arrays(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                            g.num_vertices, 128, device="cuda",
                            transpose_rows=g.num_vertices)
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = torch.rand(g.num_edges, generator=gen,
                   device="cuda")[bg.eidx.long()].contiguous()
    x = torch.randn((g.num_vertices, 40), generator=gen, device="cuda")
    gout = torch.randn((bg.nblocks * bg.tile_m, 40), generator=gen,
                       device="cuda")

    def grad(fn, **kw):
        xr = x.clone().requires_grad_()
        out = fn(xr, bg.src, bg.dstl, bg.mask, w, tile_m=bg.tile_m, **kw)
        assert out.grad_fn is not None
        return torch.autograd.grad(out, [xr], gout)[0]

    before = ops.launch_counts()
    got = [grad(k1.seg_agg, transposed=bg.transposed), grad(k1.seg_agg),
           grad(k1.seg_agg)]
    launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
    assert (launched["seg_agg"], launched["seg_agg_bwd"]) == (6, 3)
    assert all(torch.equal(got[0], o) for o in got[1:])
    _rows_close(got[0], grad(k1.seg_agg_plain), ROW_LIMIT[torch.float32])


def _train_case(card):
    from repro_torch.config import REDDIT
    spec = reduced_graph(REDDIT, 2000, 64)
    g = make_synthetic_graph(spec, device="cuda")
    return spec, g, make_features(spec, device="cuda"), \
        torch.from_numpy(np.random.default_rng(0).integers(
            0, spec.num_classes, spec.num_vertices))


TRAIN_KW = dict(hidden=32, batch_size=16, fanouts=(5, 3), lr=0.1, seed=0)


@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_trainer_first_step_cuda_vs_torch(card, dedup):
    """The trainer's first step on the cuda tier against the torch tier on
    the same card and block (loss and gradients, unit f32 band times 10);
    K1 launches forward and backward as the ordering implies (backward:
    the capacity layout's pieces and its fold-back a layer); predict
    captures once and replays the eager forward's bits."""
    from repro_torch.models.sage_minibatch import PlannedSageTrainer
    spec, g, x, y = _train_case(card)
    tc = PlannedSageTrainer(g, spec, x, y, dedup=dedup, **TRAIN_KW)
    tt = PlannedSageTrainer(g, spec, x, y, dedup=dedup, backend="torch",
                            **TRAIN_KW)
    assert tc.plan.agg_tile > 0 and tt.plan.agg_tile == 0
    prep = tc._prepare(tc.pipeline.batch_at(0))
    before = ops.launch_counts()
    lc, gc = tc.loss_and_grads(prep)
    launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
    lt, gt = tt.loss_and_grads(prep)
    _close(lc, lt)
    for a, b in zip(gc, gt):
        _close(a, b)
    n_bwd = sum(i > 0 or lp.order == "combine_first"
                for i, lp in enumerate(tc.plan.layers))
    assert (launched["seg_agg"], launched["seg_agg_bwd"]) == (
        2 + 2 * n_bwd, 2 * n_bwd)
    first = tc.predict(step=1)
    xx, gg, glay, ded = tc._inputs(
        tc._prepare(tc.pipeline.batch_at(2)), backward=False)
    with torch.no_grad():
        eager = tc.plan.run_model(tc.params, xx, graph=gg,
                                  graph_layout=glay, dedup_layout=ded)
        assert torch.equal(tc.fwd(tc.params, xx, gg, dedup=ded,
                                  layout=glay), eager)
    assert np.isfinite(first).all()
    assert (tc.fwd.num_traces, tc.fwd.num_replays) == (1, 1)


@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_trainer_captured_step_bitwise_eager(card, dedup):
    """The trainer's steps through its one captured step against the eager
    step (``loss_and_grads``, ``_sgd``) of a second trainer from the same
    state on the same blocks: each loss and every parameter bit for bit;
    one capture, no retrace; a replay moves no launch counter, and the
    capture recorded K1's forward and backward (pieces and fold-back)
    launches."""
    from repro_torch.models.sage_minibatch import PlannedSageTrainer, _sgd
    spec, g, x, y = _train_case(card)
    tr = PlannedSageTrainer(g, spec, x, y, dedup=dedup, **TRAIN_KW)
    ref = PlannedSageTrainer(g, spec, x, y, dedup=dedup, **TRAIN_KW)
    n_bwd = sum(i > 0 or lp.order == "combine_first"
                for i, lp in enumerate(tr.plan.layers))
    for step in range(5):
        before = ops.launch_counts()
        got = tr.step()
        moved = {k: n - before[k] for k, n in ops.launch_counts().items()}
        loss, grads = ref.loss_and_grads(
            ref._prepare(ref.pipeline.batch_at(step)))
        _sgd(list(ref.model.parameters()), grads, ref.lr)
        assert got == loss.item()
        for p, q in zip(tr.model.parameters(), ref.model.parameters()):
            assert torch.equal(p, q)
        if step:
            assert moved["seg_agg"] == 0
    (cap,) = tr._steps.values()
    assert (cap.launches["seg_agg"], cap.launches["seg_agg_bwd"]) == (
        2 + 2 * n_bwd, 2 * n_bwd)
    assert tr._step_traces == 1 and tr.retraces == 0


def test_k1_backward_at_capacity_matches_plain(card):
    """K1's backward over a trainer block's capped transposed layout at
    the bucket's capacity (pieces, then the fold-back, empty or not)
    against the plain version's fold per row; two launches a fold, the
    same whichever block; repeat launches bit for bit."""
    from repro_torch.models.sage_minibatch import PlannedSageTrainer
    spec, g, x, y = _train_case(card)
    tr = PlannedSageTrainer(g, spec, x, y, dedup="none", **TRAIN_KW)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for step in range(3):
        _, _, lay, _ = tr._inputs(tr._prepare(tr.pipeline.batch_at(step)))
        t = lay.transposed
        assert t.fold is not None and t.emax == dataflow.TRANSPOSE_CAP
        gout = torch.randn((lay.nblocks * lay.tile_m, 41), generator=gen,
                           device="cuda")
        n = k1.seg_agg.launches_bwd
        got = k1.fold_transposed(gout, t)
        again = k1.fold_transposed(gout, t)
        assert k1.seg_agg.launches_bwd - n == 4
        want = k1.fold_transposed(gout, t, plain=True)
        rows = t.num_vertices
        assert torch.equal(got[:rows], again[:rows])
        _rows_close(got[:rows], want[:rows], ROW_LIMIT[torch.float32])


def test_trainer_resume_bitwise_on_card(card, tmp_path):
    """K1 folds without atomics: a run resumed from a checkpoint equals
    the uninterrupted one bit for bit on the card."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.models.sage_minibatch import PlannedSageTrainer
    spec, g, x, y = _train_case(card)
    straight = PlannedSageTrainer(g, spec, x, y, dedup="none", **TRAIN_KW)
    straight.train(6)
    ck = Checkpointer(str(tmp_path / "ck"))
    a = PlannedSageTrainer(g, spec, x, y, dedup="none", **TRAIN_KW)
    a.train(3)
    a.save(ck)
    b = PlannedSageTrainer(g, spec, x, y, dedup="none", **TRAIN_KW)
    assert b.restore(ck) == 3
    b.train(3)
    assert b.losses == straight.losses
    for (_, p), (_, q) in zip(tplan._leaves(b.params),
                              tplan._leaves(straight.params)):
        assert torch.equal(p, q) and p.device.type == "cuda"


def _serve_engine(card, name="gcn"):
    """A GraphServeEngine on the card with one small bucket (4 seeds,
    fanouts 3/3: 65 rows, 60 edges)."""
    from repro_torch.models.gcn import PAPER_MODELS
    from repro_torch.serve import GraphServeEngine, default_buckets
    spec, g, x = card
    eng = GraphServeEngine(
        g, PAPER_MODELS[name], None, x, spec.num_classes, fanouts=(3, 3),
        buckets=default_buckets((3, 3), seed_levels=(4,),
                                max_inputs=spec.num_vertices))
    eng.params = eng.init_params(torch.Generator().manual_seed(0))
    return eng


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
def test_graph_serving_replay_matches_eager(card, name):
    """The bucket's CUDA graph replays the bucket plan's eager forward
    over the same padded block bit for bit, and is within the f32 band of
    the eager forward over the unpadded block (the combination's matmuls
    run over other row counts there); the capture records K1 once a
    layer, as the eager forward launches it, and serving makes no launch
    outside the graph."""
    eng = _serve_engine(card, name)
    eng.warmup()
    b = eng.buckets[0]
    plan, fn = eng._bucket_plan(b)
    assert fn.num_traces == 1 and plan.agg_tile > 0
    cap = fn.capture_launches
    rng = np.random.default_rng(0)
    for s in (1, 3, 4):
        prep = eng.prepare(rng.choice(card[0].num_vertices, size=s,
                                      replace=False))
        assert prep.bucket == b
        before = ops.launch_counts()
        served = eng.run_prepared(prep)
        assert ops.launch_counts() == before      # a replay, nothing else
        padded = eng.run_eager(prep, padded=True)
        eager = {k: n - before[k] for k, n in ops.launch_counts().items()}
        assert np.array_equal(served, padded)
        assert cap["seg_agg"] == eager["seg_agg"] == plan.num_layers
        assert cap["fused_agg_combine"] == eager["fused_agg_combine"] == 0
        _close(torch.from_numpy(served), torch.from_numpy(
            eng.run_eager(prep)))
    # warmup() replays once, for its template request through the bucket
    assert eng.retraces() == 0 and fn.num_replays == 1 + 3


def test_graph_serving_device_gather(card):
    """The padded x gathered on the card equals the host's gather (zero
    pad rows); the runtime layout has the bucket's fixed capacity and only
    the real edges."""
    spec, _, x = card
    eng = _serve_engine(card)
    prep = eng.prepare(np.array([5, 17, 301], np.int32))
    b = prep.bucket
    xx, gg, lay = eng._pad_into(prep, b)
    want = np.zeros((b.num_inputs, spec.feature_len), np.float32)
    want[: len(prep.frontier)] = x.cpu().numpy()[prep.frontier]
    assert xx.device.type == "cuda" and np.array_equal(xx.cpu().numpy(), want)
    tile = eng._bucket_plan(b)[0].agg_tile
    assert lay.emax == -(-tile * 6 // 8) * 8
    assert int(lay.mask.sum().item()) == prep.graph.num_edges
    assert gg.num_edges == b.num_edges and gg.num_vertices == b.num_inputs


# ---------------------------------------------------------------------------
# distributed inference: K1's bf16-in/f32-out entry, the shard layouts and
# a LocalMesh on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f", [1, 7, 41, 128, 602])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_agg_bf16_f32_matches_plain(card, f, offset, weighted):
    """K1 over bf16 x with an f32 output (the halo partials over a bf16
    wire slab): per row within the f32 limit of ``fold_blocks_plain`` (the
    f32 fold of the same bf16 rows), two launches bitwise equal, the empty
    block exactly 0, launches counted under ``seg_agg_bf16_f32`` and not
    under ``seg_agg_bf16``."""
    bg = _ragged_layout()
    gen = torch.Generator(device="cuda").manual_seed(100 + f + offset)
    x = _offset(torch.randn((bg.num_vertices, f), generator=gen,
                            device="cuda").to(torch.bfloat16), offset)
    w = torch.rand(bg.src.shape, generator=gen, device="cuda") \
        if weighted else None
    args = (x, bg.src, bg.dstl, bg.mask, w)
    before = ops.launch_counts()
    got = k1.seg_agg(*args, tile_m=bg.tile_m, out_dtype=torch.float32)
    again = k1.seg_agg(*args, tile_m=bg.tile_m, out_dtype=torch.float32)
    launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
    assert (launched["seg_agg"], launched["seg_agg_bf16_f32"],
            launched["seg_agg_bf16"]) == (2, 2, 0)
    want = k1.fold_blocks_plain(*args, bg.tile_m)
    assert got.dtype == want.dtype == torch.float32
    _close(got, want)
    _rows_close(got, want, ROW_LIMIT[torch.float32])
    assert torch.equal(got, again)
    assert not got[bg.tile_m:2 * bg.tile_m].any()
    # rounded once, it is the bf16 entry's output bit for bit
    assert torch.equal(got.to(torch.bfloat16),
                       k1.seg_agg(*args, tile_m=bg.tile_m))


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shard_layouts_launch_against_plain(card, strategy, dtype):
    """K1 over each shard layout of a 4-way partition -- the ring's (shard,
    owner) sub-layouts over an owner's slab, the all-gather's over the
    gathered rows -- against the plain version, f32 out; repeat launches
    bitwise."""
    from repro_torch.core import distributed as tdist
    from repro_torch.graph.partition import partition_1d
    spec, g, x = card
    pg = partition_1d(g, 4, edge_balanced=False)
    lays = tdist.shard_layouts(pg, strategy)
    xp = tdist.pad_features(x[:, :128], pg.block_size, 4).to(dtype)
    n = k1.seg_agg.launches
    for p in range(4):
        for o, lay in enumerate(lays[p] if strategy == "ring"
                                else [lays[p]]):
            slab = xp[o * pg.block_size:(o + 1) * pg.block_size] \
                if strategy == "ring" else xp
            got = tdist._local_agg(slab, lay, backend="cuda")
            again = tdist._local_agg(slab, lay, backend="cuda")
            want = k1.fold_blocks_plain(slab, lay.src, lay.dstl, lay.mask,
                                        None, lay.tile_m)[:pg.block_size]
            assert got.dtype == torch.float32
            _rows_close(got, want, ROW_LIMIT[torch.float32])
            assert torch.equal(got, again)
    assert k1.seg_agg.launches - n == (32 if strategy == "ring" else 8)


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_local_mesh_pipelined_bitwise_none_on_card(card, shape, dtype):
    """The pipelined ring copies each hop's slab on the mesh's own stream
    while K1 folds the resident one (events order them, the sent slabs are
    held until the compute stream waits): its logits equal the
    single-buffered ring's bit for bit, and two calls agree; K1 runs P
    hops a held shard a layer; within the band of the torch tier on the
    card."""
    from repro_torch.core.distributed import LocalMesh
    spec, g, x = card
    names = ("data",) if len(shape) == 1 else ("node", "feat")
    mesh = LocalMesh(shape, names)
    m = make_paper_model("gcn", spec, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    outs = []
    with torch.no_grad():
        for ov in ("none", "pipelined", "pipelined"):
            plan = m.plan_for(g, mesh=mesh, overlap=ov, dtype=dtype)
            n = k1.seg_agg.launches
            outs.append(m(g, x, plan=plan))
            assert k1.seg_agg.launches - n == \
                2 * mesh.size * shape[0]   # 2 layers x shards x hops
        want = m(g, x, plan=m.plan_for(g, mesh=LocalMesh(
            shape, names, device="cuda"), overlap="none", dtype=dtype,
            backend="torch"))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    _close(outs[0], want, BF16_TOL if dtype == "bf16" else TOL)


# ---------------------------------------------------------------------------
# distributed training: K1's backward over capped transposed layouts (the
# pieces, then the fold-back) and gradients through a LocalMesh on the card
# ---------------------------------------------------------------------------


def _hub_transposed(cap, v=70000, fanout=60000, other=40000, seed=5):
    """A graph whose source 0 feeds ``fanout`` destinations, with its
    forward layout and the capped transposed one on the card."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(fanout, np.int64),
                          rng.integers(1, v, other)])
    dst = np.concatenate([np.arange(1, fanout + 1),
                          rng.integers(0, v, other)])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    dev = torch.device("cuda")
    bg, slot = dataflow._block_layout(src, dst, v, 128, dev)
    return bg._replace(transposed=dataflow._transposed(
        src, dst, slot, v, 128, dev, cap))


@pytest.mark.parametrize("cap,fanout", [(256, 60000), (1024, 60000),
                                        (2048, 60000), (1024, 0)])
@pytest.mark.parametrize("f", [41, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capped_transposed_fold_matches_plain(card, cap, fanout, f, dtype):
    """K1's backward over a capped transposed layout with a hub row of
    60,000 slots (or none: no row cut, no fold-back) -- the pieces'
    launch storing each uncut row in place and each cut row's pieces to
    scratch rows (f32; the bf16-in/f32-out entry for bf16), then, when a
    row was cut, the fold-back -- per row within the f32 limit of the
    plain version's folds and of the uncapped plain fold; every uncut row
    bit for bit the in-order f32 fold of its slots, every cut row the
    left fold of its scratch rows in piece order; two calls bitwise; one
    launch a call, or two with a cut row, each counted as a backward
    launch."""
    bg = _hub_transposed(cap, fanout=fanout)
    t = bg.transposed
    assert t.emax <= cap and (t.fold is not None) == (fanout > 0)
    gen = torch.Generator(device="cuda").manual_seed(cap + f)
    g = torch.randn((bg.nblocks * bg.tile_m, f), generator=gen,
                    device="cuda").to(dtype)
    before = ops.launch_counts()
    got = k1.fold_transposed(g, t)
    again = k1.fold_transposed(g, t)
    launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
    per_call = 1 + (t.fold is not None)
    assert launched["seg_agg_bwd"] == launched["seg_agg"] == 2 * per_call
    assert launched["seg_agg_bf16_f32"] == (2 if dtype == torch.bfloat16
                                            else 0)
    assert torch.equal(got, again)
    n = t.num_vertices
    want = ops.seg_agg_transposed(t, g, backend="torch")
    rows = got[:n]
    assert rows.dtype == want.dtype == torch.float32
    _rows_close(rows, want, ROW_LIMIT[torch.float32])
    plain = dataflow_plain_transposed(bg, g)
    _rows_close(rows, plain, ROW_LIMIT[torch.float32])
    # uncut rows: the in-order fold of their slots, stored in place
    tmap = t.out_rows.cpu().numpy().ravel()
    whole = (tmap >= 0) & (tmap < n)
    ref = _in_order(g, t, None)
    assert torch.equal(rows.cpu()[torch.from_numpy(tmap[whole]).long()],
                       ref[torch.from_numpy(whole)])
    if t.fold is None:
        return
    # cut rows: their scratch rows added left to right in piece order
    scratch, fold = got[n:].cpu().numpy(), t.fold
    fmask = fold.mask.cpu().numpy() != 0
    fsrc, fdst = fold.src.cpu().numpy(), fold.dstl.cpu().numpy()
    fmap = fold.out_rows.cpu().numpy().reshape(fold.nblocks, -1)
    for b, m in zip(*np.nonzero(fmap >= 0)):
        acc = np.zeros(f, np.float32)
        for p in fsrc[b][fmask[b] & (fdst[b] == m)]:
            acc = acc + scratch[p]
        assert np.array_equal(rows[fmap[b, m]].cpu().numpy(), acc)


def dataflow_plain_transposed(bg, g):
    """The uncapped transposed layout's plain fold of ``g``, f32."""
    t = dataflow.transposed_layout(bg, bg.num_vertices)
    return k1.seg_agg_plain(g, t.src, t.dstl, t.mask, tile_m=t.tile_m,
                            out_dtype=torch.float32)[:bg.num_vertices]


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_bf16_entries_backward_over_capped_layout(card, out_dtype):
    """The x gradient of K1 over bf16 x (bf16 output, or f32 through the
    bf16-in/f32-out entry) with the capped transposed layout: the f32
    gradient folded by K1 and rounded once to bf16, per row within one
    bf16 ulp of the plain version's autograd over the same x upcast (the
    plain version's own autograd over bf16 x adds each row's terms in
    bf16: 60,000 of them at the hub)."""
    bg = _hub_transposed(1024)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((bg.num_vertices, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    cot = torch.randn((bg.nblocks * bg.tile_m, 128), generator=gen,
                      device="cuda")
    xk = x.clone().requires_grad_()
    out = k1.seg_agg(xk, bg.src, bg.dstl, bg.mask, tile_m=bg.tile_m,
                     transposed=bg.transposed, out_dtype=out_dtype)
    n = k1.seg_agg.launches_bwd
    (gk,) = torch.autograd.grad((out.float() * cot).sum(), [xk])
    assert bg.transposed.fold is not None
    assert k1.seg_agg.launches_bwd - n == 2 and gk.dtype == torch.bfloat16
    xp = x.float().requires_grad_()
    ref = k1.seg_agg_plain(xp, bg.src, bg.dstl, bg.mask, tile_m=bg.tile_m)
    cot_b = cot if out_dtype is not None else cot.to(torch.bfloat16).float()
    (gp,) = torch.autograd.grad((ref * cot_b).sum(), [xp])
    _rows_close(gk, gp.to(torch.bfloat16), AGG_BF16_ROW_LIMIT)


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
@pytest.mark.parametrize("strategy", ["ring", "allgather"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_local_mesh_gradients_on_card(card, shape, strategy, dtype):
    """Gradients of a mesh plan on the card: K1 forward and backward at
    the counts the partition implies (a layer: held shards x hops
    forward; backward, for each held shard's P transposed sub-layouts,
    the pieces and, where a row was cut, the fold-back), ring none bit
    for bit pipelined, each leaf within the
    band of the torch tier's autograd of the same mesh plan on the card
    (the plain versions), relative to the leaf's largest magnitude; in
    f32 1-D also of the local plan's.  (A gradient sums terms that
    cancel: where a bf16 forward rounds, or the order of a 2-D plan's Q
    partial products, moves it by far more than a kernel's ulps.)"""
    from repro_torch.core.distributed import LocalMesh
    spec, g, x = card
    y = torch.from_numpy(np.random.default_rng(0).integers(
        0, spec.num_classes, spec.num_vertices)).cuda()
    names = ("data",) if len(shape) == 1 else ("node", "feat")
    m = make_paper_model("gcn", spec, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    params = list(m.parameters())
    local = torch.autograd.grad(m.loss_fn(g, x, y, plan=m.plan_for(
        g, backend="torch")), params)
    ref = torch.autograd.grad(m.loss_fn(g, x, y, plan=m.plan_for(
        g, mesh=LocalMesh(shape, names), strategy=strategy, dtype=dtype,
        backend="torch")), params)
    overlaps = ("none", "pipelined") if strategy == "ring" else ("none",)
    grads = []
    for ov in overlaps:
        mesh = LocalMesh(shape, names)
        plan = m.plan_for(g, mesh=mesh, strategy=strategy, overlap=ov,
                          dtype=dtype)
        loss = m.loss_fn(g, x, y, plan=plan)
        ops.reset_launch_counts()
        grads.append(torch.autograd.grad(loss, params))
        c = ops.launch_counts()
        tl = plan.shard_transposed()
        node_ax = plan.axes[0] if len(shape) == 2 else plan.axis
        per_layer = sum(1 + (lay.fold is not None) for crd in mesh.coords
                        for lay in tl[mesh.index(crd, node_ax)])
        assert c["seg_agg_bwd"] == c["seg_agg"] == 2 * per_layer
    for a, b in zip(grads[0], grads[-1]):
        assert torch.equal(a, b)
    tol = BF16_TOL if dtype == "bf16" else TOL
    for a, b in zip(grads[0], ref):
        assert (a - b).abs().max().item() <= tol * b.abs().max().item()
    if dtype == "f32" and len(shape) == 1:
        for a, b in zip(grads[0], local):
            assert (a - b).abs().max().item() <= tol * b.abs().max().item()


# ---------------------------------------------------------------------------
# compiled execution under autograd, and compiled mesh plans
# ---------------------------------------------------------------------------


def _nll(logits, y):
    return -torch.log_softmax(logits, dim=-1).gather(
        -1, y.long()[:, None])[:, 0].mean()


def _labels(spec):
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, spec.num_classes, spec.num_vertices)).cuda()


@pytest.mark.parametrize("name", ["gcn", "sage"])
def test_captured_plan_gradients_bitwise_eager(card, name):
    """plan.compile() under autograd on the card: a forward and a backward
    CUDA graph, the loss and every gradient equal to eager autograd's bit
    for bit on every call, the capture records the eager forward's and
    backward's launches (K1's backward over the plan's capped transposed
    layout), a replay moves no counter; the backward of an older call and
    a second backward of one call raise."""
    spec, g, x = card
    y = _labels(spec)
    m, plan, _, _ = _compiled_case(card, name, False, seed=1)
    params = list(m.parameters())
    before = ops.launch_counts()
    loss = _nll(plan.run_model(m.tree(), x), y)
    want = torch.autograd.grad(loss, params)
    eager = {k: n - before[k] for k, n in ops.launch_counts().items()}
    assert eager["seg_agg_bwd"] >= 1
    fn = tplan.CompiledPlan(plan)
    for i in range(4):
        if i == 1:
            counts = ops.launch_counts()
        got_loss = _nll(fn(m.tree(), x), y)
        got = torch.autograd.grad(got_loss, params)
        assert torch.equal(got_loss, loss)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == counts
    assert (fn.num_traces, fn.num_replays) == (1, 3)
    assert fn.capture_launches == eager
    older, newer = _nll(fn(m.tree(), x), y), _nll(fn(m.tree(), x), y)
    with pytest.raises(RuntimeError, match="newer call"):
        torch.autograd.grad(older, params)
    torch.autograd.grad(newer, params, retain_graph=True)
    with pytest.raises(RuntimeError, match="second backward"):
        torch.autograd.grad(newer, params)


def test_fused_capture_under_grad_raises(card):
    """A fused plan under autograd raises on the card as its eager forward
    does (K2 has no backward), and nothing is cached."""
    m, plan, g, x = _compiled_case(card, "gcn", True)
    fn = tplan.CompiledPlan(plan)
    with pytest.raises(NotImplementedError, match="no backward"):
        fn(m.tree(), x)
    assert not fn._traces


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
@pytest.mark.parametrize("strategy,overlap", [("ring", "none"),
                                              ("ring", "pipelined"),
                                              ("allgather", "none")])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_captured_mesh_plan_bitwise_eager(card, shape, strategy, overlap,
                                          dtype):
    """compile() of a LocalMesh plan on the card: the halos' copies on the
    mesh's stream and K1 a shard are captured; every replay equals the
    eager forward bit for bit, the capture counts K1's launches as the
    partition implies and the mesh's bytes as scheduled while a replay
    moves no counter; under autograd the loss and gradients equal eager's
    bit for bit and the backward graph records K1's backward launches."""
    from repro_torch.core.distributed import LocalMesh, schedule_wire_bytes
    spec, g, x = card
    y = _labels(spec)
    names = ("data",) if len(shape) == 1 else ("node", "feat")
    mesh = LocalMesh(shape, names)
    m = make_paper_model("gcn", spec, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    plan = m.plan_for(g, mesh=mesh, strategy=strategy, overlap=overlap,
                      dtype=dtype)
    two_d = len(shape) == 2
    wire = sum(schedule_wire_bytes(
        plan.partition, lp.din if lp.order == "aggregate_first" else lp.dout,
        strategy=strategy, overlap=plan.overlap, dtype=dtype,
        combine_out_len=lp.dout if two_d else None)["total_bytes"]
        for lp in plan.layers)
    hops = shape[0] if strategy == "ring" else 1
    fn = tplan.CompiledPlan(plan)
    with torch.no_grad():
        eager = plan.run_model(m.tree(), x)
        first = fn(m.tree(), x)
        counts, sent = ops.launch_counts(), mesh.collective_bytes()["total"]
        outs = [first] + [fn(m.tree(), x) for _ in range(3)]
    assert all(torch.equal(o, eager) for o in outs)
    assert ops.launch_counts() == counts
    assert mesh.collective_bytes()["total"] == sent
    assert fn.capture_launches["seg_agg"] == 2 * mesh.size * hops
    assert fn.capture_collectives["total"] == wire
    params = list(m.parameters())
    loss = _nll(plan.run_model(m.tree(), x), y)
    want = torch.autograd.grad(loss, params)
    for _ in range(3):
        got_loss = _nll(fn(m.tree(), x), y)
        got = torch.autograd.grad(got_loss, params)
        assert torch.equal(got_loss, loss)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    tl = plan.shard_transposed()
    node_ax = plan.axes[0] if two_d else plan.axis
    per_layer = sum(1 + (lay.fold is not None) for crd in mesh.coords
                    for lay in tl[mesh.index(crd, node_ax)])
    assert fn.capture_launches["seg_agg_bwd"] == 2 * per_layer
    assert fn.num_traces == 2


# ---------------------------------------------------------------------------
# K1 and K2 as opaque torch ops; repro_torch.analysis on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("backward", [False, True])
def test_seg_agg_op_real_body_matches_plain(card, dtype, out_dtype,
                                            backward):
    """K1's op launches the kernel once (a backward one counted as such)
    and agrees with the plain version; its fake gives the same shape and
    dtype and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    spec, g, x = card
    bg = block_graph_arrays(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                            spec.num_vertices, 128, device="cuda")
    xd = x.to(dtype)
    args = (xd, bg.src, bg.dstl, bg.mask, None, 128, backward, out_dtype)
    before = ops.launch_counts()
    got = torch.ops.repro_torch.seg_agg(*args)
    moved = {k: n - before[k] for k, n in ops.launch_counts().items()}
    assert moved["seg_agg"] == 1 and moved["seg_agg_bwd"] == int(backward)
    want = k1.seg_agg_plain(xd, bg.src, bg.dstl, bg.mask, tile_m=128,
                            out_dtype=out_dtype)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    _close(got, want, BF16_TOL if got.dtype == torch.bfloat16 else TOL)
    before = ops.launch_counts()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = torch.ops.repro_torch.seg_agg(*args)
    assert (fake.shape, fake.dtype) == (want.shape, want.dtype)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("xd,wd", [(torch.float32, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.bfloat16)])
def test_fused_agg_combine_op_real_body_matches_plain(card, xd, wd):
    spec, g, x = card
    bg = block_graph_arrays(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                            spec.num_vertices, 64, device="cuda")
    w = (torch.randn((spec.feature_len, 48), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
         / spec.feature_len ** 0.5).to(wd)
    before = ops.launch_counts()
    got = torch.ops.repro_torch.fused_agg_combine(x.to(xd), bg.src, bg.dstl,
                                                  bg.mask, w, 64)
    moved = {k: n - before[k] for k, n in ops.launch_counts().items()}
    assert moved["fused_agg_combine"] == 1
    assert moved["fused_agg_combine_mixed"] == int(xd != wd)
    want = k2.fused_agg_combine_plain(x.to(xd), bg.src, bg.dstl, bg.mask, w,
                                      tile_m=64)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    _close(got, want, BF16_TOL if wd == torch.bfloat16 else TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_analysis_traces_card_plans_without_launching(card, fused):
    """A fake-tensor trace of a cuda-tier plan on the card: K1 (K2 when
    fused) one opaque node a layer, no launch, no finding; the donation
    rule on its captured compile(donate=True) and compile() holds, and a
    donate=True claim over compile()'s fresh replays fires."""
    from repro_torch.analysis import trace_lint as tl
    spec, g, x = card
    m = make_paper_model("gcn", spec, device="cuda", fused=fused,
                         generator=torch.Generator().manual_seed(0))
    plan = m.plan_for(g)
    before = ops.launch_counts()
    tr = tl.trace(lambda p, xx: plan.run_model(p, xx), m.tree(), x)
    assert ops.launch_counts() == before
    kern = "repro_torch.fused_agg_combine" if fused else \
        "repro_torch.seg_agg"
    assert [op.packet for op in tr.ops].count(kern) == plan.num_layers
    assert tl.lint_plan(plan, params=m.tree(), x=x).ok(strict=False)
    rep = tl.lint_plan(plan, params=m.tree(), x=x, donate=True)
    assert not rep.findings, rep.render()
    first, second, captured = tl.donation_replays(plan, m.tree(), x, False)
    assert captured
    from repro_torch.analysis.report import AnalysisReport
    bad = AnalysisReport()
    tl.check_donation(first, second, True, "claimed", bad)
    assert [f.rule for f in bad.findings] == ["donation"]


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_analysis_mesh_capture_collectives(card, shape):
    """A mesh plan's bytes across a fake trace and in its capture equal
    schedule_wire_bytes (lint_plan holds both), with no launch in the
    trace."""
    from repro_torch.analysis import trace_lint as tl
    from repro_torch.core.distributed import LocalMesh
    spec, g, x = card
    axes = ("data",) if len(shape) == 1 else ("node", "feat")
    mesh = LocalMesh(shape, axes)
    m = make_paper_model("gcn", spec, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    plan = m.plan_for(g, mesh=mesh, overlap="pipelined")
    before = ops.launch_counts()
    tr = tl.trace(lambda p, xx: plan.run_model(p, xx), m.tree(), x,
                  mesh=mesh)
    assert ops.launch_counts() == before
    assert tr.collectives == tl.plan_expected_collectives(plan)
    rep = tl.lint_plan(plan, params=m.tree(), x=x, donate=True)
    assert not rep.findings, rep.render()
    got = plan.compile(donate=True).capture_collectives
    want = tl.plan_expected_collectives(plan)
    assert {p: got[tl.MESH_NAMES[p]] for p in tl.COLLECTIVE_PRIMS} == want


def test_seg_agg_raises_under_capture(card):
    """The slow host path refuses a CUDA-graph capture before its host
    copy, with the remediation text."""
    spec, g, x = card
    rows = x[g.src.long()]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with pytest.raises(ValueError) as ei:
            with torch.cuda.graph(graph):
                ops.seg_agg(rows, g.dst, spec.num_vertices, backend="cuda")
    torch.cuda.current_stream().wait_stream(side)
    assert str(ei.value) == ops.SEG_AGG_REMEDIATION


def test_capture_survives_a_dead_graph_in_a_cycle(card):
    """A reference cycle that holds a captured graph, dropped before a
    capture: with the collector set to run at every allocation the
    capture still succeeds (``capture_graph`` pauses the collector; a
    graph destroyed mid-capture invalidates the capture) and replays."""
    import gc
    spec, g, x = card

    class Holder:
        pass

    h = Holder()
    h.me = h
    h.graph = torch.cuda.CUDAGraph()
    with tplan.capture_graph(h.graph):
        h.out = x * 2.0
    del h
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        graph = torch.cuda.CUDAGraph()
        with tplan.capture_graph(graph):
            out = x + 1.0
            junk = [[i] for i in range(1000)]
        assert gc.isenabled() and junk
    finally:
        gc.set_threshold(*old)
    graph.replay()
    _close(out, x + 1.0, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,window,cap", [
    (2, 4, 2, 128, 64, 0, 0.0), (1, 8, 1, 96, 128, 32, 50.0),
    (2, 14, 2, 200, 64, 0, 0.0)])
def test_k5_op_bit_for_bit_the_direct_launch(gpu, dtype, b, hq, hkv, s, d,
                                             window, cap):
    """K5's opaque ops (``repro_torch::flash_attention`` and ``_bwd``)
    against ``_launch`` and ``_launch_bwd``: out, lse, dq,
    dk and dv bit for bit; the op counts one forward launch, the backward
    op two."""
    gen = torch.Generator(device=gpu).manual_seed(3)
    q, k, v, dout = (torch.randn(shp, generator=gen, device=gpu, dtype=dtype)
                     for shp in ((b, hq, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d), (b, hq, s, d)))
    n = (k5.flash_attention.launches, k5.flash_attention_bwd.launches)
    out, lse = torch.ops.repro_torch.flash_attention(q, k, v, None, True,
                                                     window, cap, True)
    grads = torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, lse, dout, None, True, window, cap)
    assert (k5.flash_attention.launches - n[0],
            k5.flash_attention_bwd.launches - n[1]) == (1, 2)
    kw = dict(causal=True, window=window, softcap=cap)
    want, wlse = k5._launch(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, want) and torch.equal(lse, wlse)
    for got, ref in zip(grads, k5._launch_bwd(q, k, v, out, lse, dout,
                                              **kw)):
        assert torch.equal(got, ref)
    qr = q.clone().requires_grad_()
    o = k5.flash_attention(qr, k, v, **kw)
    (dq,) = torch.autograd.grad(o, qr, dout)
    assert torch.equal(o, want) and torch.equal(dq, grads[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_rank_mesh_step_bit_for_bit_the_plain_step(gpu, tmp_path, dtype):
    """Reduced granite-3-8b through ``launch/train.py::build_trainer`` on a
    (1, 1) mesh over a world-size-1 NCCL group: step 0's loss and every
    gradient (remat "selective" and "none") bit for bit the plain step
    on the card."""
    import torch.distributed as dist

    from repro_torch.config import ShapeSpec
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch.sharding import sharding_rules
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import build_trainer
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        cfg = dataclasses.replace(granite_3_8b.reduced(), dtype=dtype)
        tr, mesh, rules = build_trainer(cfg, steps=1, batch=4, seq=64,
                                        ckpt_dir=str(tmp_path),
                                        checkpoint_every=0)
        batch = TokenPipeline(cfg, ShapeSpec("t", 64, 4, "train"),
                              seed=0).batch_at(0)
        m = ttr.init_lm(cfg, generator=torch.Generator(
            device=gpu).manual_seed(0), device=gpu)
        want, wm = make_loss_and_grads(cfg, "selective")(
            {k: p.detach() for k, p in m.named_parameters()},
            {k: torch.as_tensor(v).to(gpu) for k, v in batch.items()})
        with sharding_rules(mesh, rules):
            state = tr.make_state()
            placed = shard_batch(batch, tr.batch_shardings)
            for remat in ("selective", "none"):
                got, gm = make_loss_and_grads(cfg, remat)(state.params,
                                                          placed)
                assert torch.equal(gm["loss"].full_tensor(), wm["loss"])
                for key in want:
                    assert torch.equal(got[key].to_local(), want[key]), key
    finally:
        dist.destroy_process_group()
