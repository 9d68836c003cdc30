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
from repro_torch.configs import gemma2_9b
from repro_torch.core.dataflow import block_graph_arrays
from repro_torch.graph.datasets import make_features, make_synthetic_graph
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import fused_agg_combine as k2
from repro_torch.kernels import ops
from repro_torch.kernels import seg_agg as k1
from repro_torch.models import transformer as ttr
from repro_torch.models.gcn import make_paper_model

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
    spec, g, x = card
    m = make_paper_model("gcn", spec, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        m(g, x)


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


def test_flash_kernel_refuses_gradients_and_bad_input(gpu):
    q = torch.randn((1, 2, 8, 64), device=gpu, requires_grad=True)
    k = torch.randn((1, 1, 8, 64), device=gpu)
    with pytest.raises(RuntimeError, match="no backward"):
        k5.flash_attention(q, k, k)
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
