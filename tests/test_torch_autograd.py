"""K1's autograd Function (``kernels.seg_agg.SegAgg``) against the JAX
package's autodiff, and the K2 guard.

The cuda tier's aggregation runs K1 in both directions: the forward over
the blocked layout, the backward for ``x`` over its transposed layout.
There is no card here, so these tests run the cuda tier's code path with
the tier's device check lifted (``cuda_tier_on_cpu``): every call then
reaches the ``seg_agg`` wrapper with CPU tensors, which take the kernel's
plain version inside the same Function, over the same layouts.  The
gradients are held against ``jax.grad`` of the reference's ``aggregate``
on the xla tier, f32 band (``tests/tolerance.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro import config as jconfig
from repro.core.phases import aggregate as jaggregate
from repro.graph import dedup as jdedup
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro_torch import config as tconfig
from repro_torch.core import dataflow
from repro_torch.core import distributed as tdist
from repro_torch.core import plan as tplan
from repro_torch.core.phases import aggregate
from repro_torch.graph import dedup as tdedup
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.kernels import fused_agg_combine as k2
from repro_torch.kernels import ops
from repro_torch.kernels import seg_agg as k1
from repro_torch.profile.machine import H100

torch.set_num_threads(2)

#: reduced Cora: V=512, E=1026, 23 leading pairs shared
JSPEC = jconfig.reduced_graph(jconfig.CORA, 512, 16)
TSPEC = tconfig.reduced_graph(tconfig.CORA, 512, 16)
JG, TG = jgraph(JSPEC), tgraph(TSPEC, device="cpu")
TILE = 32
F = 12


@pytest.fixture
def cuda_tier_on_cpu(monkeypatch):
    """The cuda tier with its device check lifted: K1's wrapper then gets
    CPU tensors and runs its plain version inside ``SegAgg``."""
    def check(backend, x):
        assert backend in ("torch", "cuda")
    monkeypatch.setattr(ops, "_check_tier", check)


@pytest.fixture
def folds(monkeypatch):
    """Counts K1's folds (forward and backward), on any device."""
    count = {"n": 0}
    fold = k1._fold

    def spy(*args, **kw):
        count["n"] += 1
        return fold(*args, **kw)
    monkeypatch.setattr(k1, "_fold", spy)
    return count


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((TSPEC.num_vertices, F)).astype(np.float32)
    cot = rng.standard_normal((TSPEC.num_vertices, F)).astype(np.float32)
    w = rng.random(TG.num_edges).astype(np.float32)
    return x, cot, w


def _layout(transposed: bool):
    return dataflow.block_graph_arrays(
        TG.src.numpy(), TG.dst.numpy(), TG.num_vertices, TILE,
        transpose_rows=TG.num_vertices if transposed else None)


def _jgrad(x, cot, op, w=None, dedup=None):
    def f(xx):
        out = jaggregate(JG, xx, op=op, backend="xla", dedup=dedup,
                         edge_weight=None if w is None else jnp.asarray(w))
        return jnp.sum(out * cot)
    return np.asarray(jax.grad(f)(jnp.asarray(x)))


def _tgrad(x, cot, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    out = aggregate(TG, xt, backend="cuda", **kw)
    (gx,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [xt])
    return gx.numpy()


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("transposed", [True, False])
def test_x_gradient_matches_reference(cuda_tier_on_cpu, folds, op,
                                      weighted, transposed):
    """The x gradient through K1's Function, over a transposed layout
    built with the forward one or on first need, equals jax.grad."""
    x, cot, w = _inputs()
    ew = torch.from_numpy(w) if weighted else None
    got = _tgrad(x, cot, op=op, layout=_layout(transposed), edge_weight=ew)
    want = _jgrad(x, cot, op, w if weighted else None)
    assert_allclose_dtype(got, want)
    assert folds["n"] == 2          # the forward and the backward


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("transposed", [True, False])
def test_x_gradient_through_dedup_sum(cuda_tier_on_cpu, folds, op,
                                      transposed):
    """Through the two-level sum: level 2 over ``[x ; partials]`` in K1's
    Function, the pair partials by plain indexing."""
    x, cot, _ = _inputs(1)
    lay = tdedup.dedup_layout_for_graph(TG)
    assert lay.num_pairs > 0
    lay = lay._replace(blocked=dataflow.block_graph_arrays(
        lay.src2.numpy(), lay.dst2.numpy(), TG.num_vertices, TILE,
        transpose_rows=TG.num_vertices + lay.num_pairs
        if transposed else None))
    got = _tgrad(x, cot, op=op, dedup=lay)
    want = _jgrad(x, cot, op, dedup=jdedup.dedup_layout_for_graph(JG))
    assert_allclose_dtype(got, want)
    assert folds["n"] == 2


def test_no_backward_fold_without_x_grad(cuda_tier_on_cpu, folds):
    """An aggregation of an x that needs no gradient folds once; the
    backward of what follows it launches nothing of K1."""
    x, cot, _ = _inputs()
    w = torch.ones(F, requires_grad=True)
    out = aggregate(TG, torch.from_numpy(x), backend="cuda",
                    layout=_layout(True))
    assert out.grad_fn is None
    (gw,) = torch.autograd.grad((out * w * torch.from_numpy(cot)).sum(), [w])
    assert folds["n"] == 1 and torch.isfinite(gw).all()
    # with x requiring a gradient, a gradient taken only for w still
    # never runs K1's backward
    xt = torch.from_numpy(x).requires_grad_()
    out = aggregate(TG, xt, backend="cuda", layout=_layout(True))
    assert out.grad_fn is not None
    torch.autograd.grad((out * w).sum(), [w])
    assert folds["n"] == 2


def test_weights_and_mask_get_no_gradient():
    x, _, w = _inputs()
    bg = _layout(True)
    weight = torch.from_numpy(w)[bg.eidx.long()].requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        k1.seg_agg(torch.from_numpy(x), bg.src, bg.dstl, bg.mask, weight,
                   tile_m=TILE)
    with torch.no_grad():
        k1.seg_agg(torch.from_numpy(x), bg.src, bg.dstl, bg.mask, weight,
                   tile_m=TILE)


def test_transposed_layouts_agree():
    """The transposed layout built from a layout on its device equals the
    one built with it from the host arrays; a plan builds the one of each
    layout it owns once and keeps it."""
    bg = _layout(True)
    lazy = dataflow.transposed_layout(bg, TG.num_vertices)
    for a, b in zip(lazy[:3] + (lazy.eidx,),
                    bg.transposed[:3] + (bg.transposed.eidx,)):
        assert torch.equal(a, b)
    plan = _cuda_plan()
    own = plan.layers[0].agg_layout
    kept = plan.with_transposed(own)
    assert kept.src is own.src
    assert plan.with_transposed(own).transposed is kept.transposed
    want = dataflow.transposed_layout(own, TG.num_vertices,
                                      tdist.TRANSPOSE_CAP)
    assert kept.transposed.out_rows is not None     # the capped form
    for a, b in zip(kept.transposed[:3] + (kept.transposed.out_rows,),
                    want[:3] + (want.out_rows,)):
        assert torch.equal(a, b)
    # each transposed slot mirrors a forward slot with the swapped edge
    t, m = bg.transposed, bg.transposed.mask != 0
    slot = t.eidx[m].long()
    fwd_src = bg.src.reshape(-1)[slot]
    fwd_dst = (slot // bg.emax) * TILE + bg.dstl.reshape(-1)[slot]
    rows = (torch.arange(t.nblocks)[:, None] * TILE + t.dstl)[m]
    assert torch.equal(fwd_src.long(), rows.long())
    assert torch.equal(fwd_dst.long(), t.src[m].long())


def _cuda_plan():
    """A one-layer cuda-tier plan over TG (planning launches nothing)."""
    lp = tplan._plan_layer(TG, 0, "gcn", (F, 5), agg_op="mean",
                           ordering="aggregate_first", backend="cuda",
                           fused=False)
    return tplan.GraphExecutionPlan(TG, [lp], machine=H100)


def test_plan_backward_over_its_kept_layout(cuda_tier_on_cpu, folds,
                                            monkeypatch):
    """A cuda-tier plan's forward under grad runs K1's backward over the
    plan's transposed layout, built on the first backward only and none
    without grad; the gradient equals the torch tier's in the f32 band."""
    built = []
    make = dataflow.transposed_layout
    monkeypatch.setattr(dataflow, "transposed_layout",
                        lambda *a: built.append(1) or make(*a))
    plan = _cuda_plan()
    twin = tplan.GraphExecutionPlan(
        TG, [tplan._plan_layer(TG, 0, "gcn", (F, 5), agg_op="mean",
                               ordering="aggregate_first", backend="torch",
                               fused=False)], machine=H100)
    x, cot, _ = _inputs(2)
    gen = torch.Generator().manual_seed(0)
    params = {"lin": {"w": torch.randn((F, 5), generator=gen),
                      "b": torch.zeros(5)}}
    cot = torch.from_numpy(cot[:, :5])

    def grad(p):
        xt = torch.from_numpy(x).requires_grad_()
        out = p.run_layer(params, xt)
        return torch.autograd.grad((out * cot).sum(), [xt])[0]

    with torch.no_grad():
        plan.run_layer(params, torch.from_numpy(x))
    assert built == [] and folds["n"] == 1
    got = [grad(plan), grad(plan)]
    assert built == [1] and folds["n"] == 5
    assert torch.equal(got[0], got[1])
    assert_allclose_dtype(got[0].numpy(), grad(twin).numpy())


def test_capacity_layout():
    """A fixed ``emax`` pads every block to it; a block over it raises."""
    bg = _layout(False)
    big = dataflow.block_graph_arrays(TG.src.numpy(), TG.dst.numpy(),
                                      TG.num_vertices, TILE,
                                      emax=bg.emax + 16)
    assert big.emax == bg.emax + 16
    x = torch.from_numpy(_inputs()[0])
    assert torch.equal(k1.seg_agg(x, big.src, big.dstl, big.mask,
                                  tile_m=TILE),
                       k1.seg_agg(x, bg.src, bg.dstl, bg.mask, tile_m=TILE))
    with pytest.raises(ValueError, match="capacity"):
        dataflow.block_graph_arrays(TG.src.numpy(), TG.dst.numpy(),
                                    TG.num_vertices, TILE, emax=bg.emax - 8)


def test_k2_raises_under_grad_on_card(monkeypatch):
    """K2 has no backward: given a tensor its device check takes for a
    card's, it raises under grad instead of cutting the gradient, and
    launches as before without grad."""
    monkeypatch.setattr(k2, "_is_cpu", lambda t: False)
    monkeypatch.setattr(k2.fused_agg_combine, "launches", 0)
    launched = []
    monkeypatch.setattr(k2, "_launch",
                        lambda *a, **kw: launched.append(1) or a[0].clone())
    bg = _layout(False)
    x = torch.zeros((TG.num_vertices, 8))
    w = torch.zeros((8, 4), requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k2.fused_agg_combine(x, bg.src, bg.dstl, bg.mask, w, tile_m=TILE)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k2.fused_agg_combine(x.requires_grad_(), bg.src, bg.dstl, bg.mask,
                             w.detach(), tile_m=TILE)
    assert not launched
    with torch.no_grad():
        k2.fused_agg_combine(x, bg.src, bg.dstl, bg.mask, w, tile_m=TILE)
    assert launched == [1]
