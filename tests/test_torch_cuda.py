"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``: every test here needs a CUDA card and nvcc, and skips
without one.  Imports torch only (no JAX), so it runs on the machine with
the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same comparisons at the main path's full-size
shapes.
"""

import pytest
import torch

from repro_torch.config import CORA, reduced_graph
from repro_torch.graph.datasets import make_features, make_synthetic_graph
from repro_torch.kernels import fused_agg_combine as k2
from repro_torch.kernels import ops
from repro_torch.kernels import seg_agg as k1
from repro_torch.models.gcn import make_paper_model

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

#: unit f32 band times 10: kernel and plain version add in other orders
TOL = 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the cuda tier has no CPU mode)")
    spec = reduced_graph(CORA, 1000, 256)
    g = make_synthetic_graph(spec, device="cuda")
    return spec, g, make_features(spec, device="cuda")


def _close(a, b):
    torch.cuda.synchronize()
    scale = max(1.0, b.abs().max().item())
    assert (a - b).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("f", [1, 7, 41, 128, 300])
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
    _close(k2.fused_agg_combine(x, bg.src, bg.dstl, bg.mask, w,
                                tile_m=bg.tile_m),
           k2.fused_agg_combine_plain(x, bg.src, bg.dstl, bg.mask, w,
                                      tile_m=bg.tile_m))
    assert k2.fused_agg_combine.launches == n + 1


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
