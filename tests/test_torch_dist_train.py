"""Distributed GCN training on a ``LocalMesh`` against the JAX package.

The port's gradient through a mesh plan is its own: each halo is one
``autograd.Function`` whose backward runs the same halo over the output
gradients, folding the capped transposed shard sub-layouts (K1 over row
pieces, then over the fold-back).  It is held here to the reference:

* the capped transposed builder (``core/dataflow.py``,
  ``_transposed(..., cap)``): every edge once, pieces in slot order and
  at most ``cap`` long, blocks of at most ``tile_m`` pieces and ``cap``
  slots, the fold-back's rows mapping each row's pieces back in order;
  a hub-row graph's gradient through ``SegAgg`` on the cuda tier's path
  (device check lifted, the kernel's plain version inside) against
  ``jax.grad`` of the reference's ``aggregate``, at several caps, in the
  f32 band;
* each layer's W and bias gradient of the mean NLL of a mesh plan
  (``LocalMesh`` (2,), (4,), (4, 2); all-gather, ring none and pipelined;
  f32, bf16, int8-agg) against ``jax.grad`` of the reference on the same
  params, in each dtype's band (``tests/tolerance.py``) relative to the
  leaf's largest magnitude (a gradient's entries are far below 1, where
  the bands' absolute term would hold anything).  f32 and int8-agg: the
  reference's EAGER SINGLE-DEVICE plan (its own sharded contracts fail on
  this tree).  On the 2-D mesh an int8-agg shard quantizes its F/Q
  columns of each row (the reference's ``_reduce_wire`` on a shard's
  slab), so there the reference's ``quantize_int8`` is applied per column
  block (monkeypatched in the reference's ``phases``) -- ``round`` has
  zero gradient in both frameworks, so the gradient goes through each
  block's scale.  bf16: a bf16 gradient sums terms that cancel, so where
  two bf16 forwards round differs moves it by about its own size (the
  reference's local bf16 plan is off its f32 one by 0.9-1.6x a leaf's
  largest magnitude on a reduced Reddit).  The distributed layer keeps
  f32 partials and rounds elsewhere than the local plan, so its yardstick
  is ``jax.grad`` of the reference's own ``distributed_gcn_layer`` with
  its halo summed on one device (the reference's per-shard
  ``_local_agg``, no ``shard_map``); the 2-D layer rounds at the same
  points (its Q partial products add in f32 before the wire's cast);
* ring none and pipelined gradients bit for bit; the backward's counted
  collective bytes equal the forward's (``schedule_wire_bytes``);
* ``compressed_psum_leaf`` / ``make_compressed_allreduce``: the
  reference's ``test_compressed_allreduce_matches_mean`` contract, and
  bit for bit the reference's own all-reduce on a one-device mesh;
* the example (``launch/distributed_gcn.py --train``): five steps against
  a loop of the reference's pieces -- ``jax.grad`` of its local plan, its
  ``_quantize``, SGD -- in the f32 band.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA, reduced_graph
from repro.core import phases as jphases
from repro.core.phases import aggregate as jaggregate
from repro.core.plan import build_plan as jbuild_plan
from repro.graph.datasets import make_features as jfeatures
from repro.graph.datasets import make_labels as jlabels
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.graph.structure import graph_from_coo as jgraph_from_coo
from repro.models.gcn import PAPER_MODELS as JMODELS
from repro.models.gcn import GCNModel as JGCNModel
from repro.optim import compression as jcomp
from repro_torch import config as tconfig
from repro_torch.core import dataflow
from repro_torch.core import distributed as tdist
from repro_torch.core.phases import aggregate
from repro_torch.graph import partition as tpart
from repro_torch.graph.datasets import make_features as tfeatures
from repro_torch.graph.datasets import make_labels as tlabels
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.graph.structure import graph_from_coo
from repro_torch.kernels import ops
from repro_torch.kernels import seg_agg as k1
from repro_torch.models.gcn import PAPER_MODELS, GCNModel
from repro_torch.optim import compression as tcomp

torch.set_num_threads(2)

JSPEC = reduced_graph(CORA, 300, 32)
TSPEC = tconfig.reduced_graph(tconfig.CORA, 300, 32)
JG, TG = jgraph(JSPEC), tgraph(TSPEC, device="cpu")
JX, TX = jfeatures(JSPEC), tfeatures(TSPEC, device="cpu")
JY, TY = jlabels(JSPEC), tlabels(TSPEC, device="cpu")
#: the reference's distributed tests' model: GCN 32 -> 16 -> 7
JCFG = dataclasses.replace(JMODELS["gcn"], hidden_dims=(16,))
TCFG = dataclasses.replace(PAPER_MODELS["gcn"], hidden_dims=(16,))
SHAPES = [(2,), (4,), (4, 2)]
STRATEGIES = [("allgather", "none"), ("ring", "none"), ("ring", "pipelined")]
DTYPES = ["f32", "bf16", "int8-agg"]
#: the hub-row graph: vertices, the hub's destinations, other edges
HUB_V, HUB_FANOUT, HUB_OTHER = 4000, 3000, 2000
TILE = 32


def _mesh(shape):
    names = ("data",) if len(shape) == 1 else ("node", "feat")
    return tdist.LocalMesh(shape, names, device="cpu")


_PARAMS = {}


def _model():
    """The reference's params (seed 0) and the port's model holding them."""
    if "p" not in _PARAMS:
        params = JGCNModel(JCFG, JSPEC.feature_len,
                           JSPEC.num_classes).init(jax.random.PRNGKey(0))
        tm = GCNModel(TCFG, TSPEC.feature_len, TSPEC.num_classes,
                      device="cpu")
        tm.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
        _PARAMS["p"] = (params, tm)
    return _PARAMS["p"]


def _nll(logits, y):
    ll = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(ll, y[:, None], axis=-1)[:, 0].mean()


def _blockwise_quantize(feat_shards, quantize):
    """The reference's ``quantize_int8`` over each of ``feat_shards``
    column blocks of ``feature_block(F)`` columns: what a 2-D shard's
    ``_reduce_wire`` quantizes."""
    def fn(x):
        fb = -(-x.shape[-1] // feat_shards)
        return jnp.concatenate([quantize(x[:, c:c + fb])
                                for c in range(0, x.shape[-1], fb)], axis=-1)
    return fn


_JGRADS = {}


def _reference_grads(dtype, feat_shards=1):
    """``jax.grad`` of the mean NLL through the reference's eager
    single-device plan (xla tier) -- with the int8-agg quantizer per
    column block of a 2-D shard when ``feat_shards`` > 1."""
    key = (dtype, feat_shards if dtype == "int8-agg" else 1)
    if key not in _JGRADS:
        params, _ = _model()
        plan = jbuild_plan(JG, JCFG, JSPEC.feature_len, JSPEC.num_classes,
                           backend="xla", machine="h100", dtype=dtype)
        orig = jphases.quantize_int8
        if key[1] > 1:
            jphases.quantize_int8 = _blockwise_quantize(key[1], orig)
        try:
            grads = jax.grad(lambda p: _nll(plan.run_model(p, JX), JY))(
                params)
        finally:
            jphases.quantize_int8 = orig
        _JGRADS[key] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), grads)
    return _JGRADS[key]


def _one_device_halo(pg, x, mesh=None, axis=None, **_):
    """The reference's halo summed on one device: each shard's
    ``_local_agg`` over the whole padded x (global sources), stacked."""
    from repro.core import distributed as jdist
    return jnp.concatenate([jdist._local_agg(x, pg.src[p], pg.dst_local[p],
                                             pg.mask[p], pg.block_size)
                            for p in range(pg.num_shards)])


def _reference_dist_grads(shards, dtype="bf16"):
    """``jax.grad`` of the mean NLL through two of the reference's
    ``distributed_gcn_layer`` (combine-first, ReLU between) over its
    uniform ``shards``-way partition, the halo summed on one device
    (``_one_device_halo``)."""
    from repro.core import distributed as jdist
    from repro.graph.partition import partition_1d
    key = ("dist", shards, dtype)
    if key not in _JGRADS:
        params, _ = _model()
        pg = partition_1d(JG, shards, edge_balanced=False)
        saved = jdist.aggregate_ring, jdist.aggregate_allgather
        jdist.aggregate_ring = jdist.aggregate_allgather = _one_device_halo

        def loss(p):
            h = jdist.pad_features(JX, pg.block_size, shards)
            for i in range(2):
                lin = p[f"conv{i}"]["lin"]
                h = jdist.distributed_gcn_layer(
                    pg, h, lin["w"], lin["b"], JG.in_deg, None,
                    order="combine_first", dtype=dtype)
                h = jax.nn.relu(h) if i == 0 else h
            return _nll(h[:JSPEC.num_vertices], JY)
        try:
            grads = jax.grad(loss)(params)
        finally:
            jdist.aggregate_ring, jdist.aggregate_allgather = saved
        _JGRADS[key] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), grads)
    return _JGRADS[key]


def _assert_leaf(got, want, dtype, name):
    """``got`` in the dtype's band of ``want``, both over ``want``'s
    largest magnitude (f32 at 10x its unit band: two layers of f32 sums
    added in other orders)."""
    top = float(np.abs(want).max())
    assert_allclose_dtype(got / top, want / top, dtype,
                          scale=10 if dtype == "f32" else 1, err_msg=name)


def _port_grads(plan):
    """Each parameter's gradient of the mean NLL through ``plan``."""
    _, tm = _model()
    tm.zero_grad()
    tm.loss_fn(TG, TX, TY, plan=plan).backward()
    return {n: p.grad.clone() for n, p in tm.named_parameters()}


# ---------------------------------------------------------------------------
# the capped transposed builder
# ---------------------------------------------------------------------------


def _hub_edges():
    """Source 0 feeds destinations 1..3000; 2,000 other edges join random
    pairs (no self loops), destination-sorted."""
    rng = np.random.default_rng(21)
    src = np.concatenate([np.zeros(HUB_FANOUT, np.int64),
                          rng.integers(1, HUB_V, HUB_OTHER)])
    dst = np.concatenate([np.arange(1, HUB_FANOUT + 1),
                          rng.integers(0, HUB_V, HUB_OTHER)])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def _capped_layout(src, dst, cap):
    """The forward layout of the dst-sorted hub edges with the capped
    transposed layout over their ``HUB_V`` sources, built as
    ``shard_transposed_layouts`` builds the halos' (``_transposed`` with
    a cap)."""
    dev = torch.device("cpu")
    bg, slot = dataflow._block_layout(src, dst, HUB_V, TILE, dev)
    return bg._replace(transposed=dataflow._transposed(
        np.asarray(src, np.int64), np.asarray(dst, np.int64), slot, HUB_V,
        TILE, dev, cap))


@pytest.mark.parametrize("cap", [8, 64, 1024])
def test_capped_layout_holds_every_edge_once_in_order(cap):
    """The capped transposed layout of the hub graph: each forward slot
    once; each piece at most ``cap`` slots and each block at most
    ``tile_m`` pieces; the fold-back row of source u gathers u's pieces
    in order, and the pieces, read in that order, hold u's edges in their
    forward order."""
    src, dst = _hub_edges()
    bg = _capped_layout(src, dst, cap)
    t, f = bg.transposed, bg.transposed.fold
    plain = dataflow.block_graph_arrays(src, dst, HUB_V, TILE,
                                        transpose_rows=HUB_V).transposed
    assert t.emax <= cap and f is not None and plain.fold is None
    m = t.mask.numpy() != 0
    eidx, gath = t.eidx.numpy()[m], t.src.numpy()[m]
    assert sorted(eidx.tolist()) == sorted(
        plain.eidx.numpy()[plain.mask.numpy() != 0].tolist())
    assert len(eidx) == len(src)
    # pieces: their output rows, and the rows' lengths a block
    b, j = np.nonzero(m)
    piece = b * TILE + t.dstl.numpy()[b, j]
    assert np.all(np.diff(piece) >= 0)
    assert np.bincount(piece).max() <= cap
    assert all(len(set(t.dstl.numpy()[k][m[k]])) <= TILE
               for k in range(t.nblocks))
    # the fold-back: each source's pieces, in increasing order
    fm = f.mask.numpy() != 0
    fb, fj = np.nonzero(fm)
    row = fb * TILE + f.dstl.numpy()[fb, fj]
    pieces_of = f.src.numpy()[fb, fj]
    assert f.num_vertices == HUB_V and sorted(pieces_of.tolist()) == \
        sorted(set(piece.tolist()))
    fwd_slot = dict(zip(zip(b, j), eidx))
    fwd = plain.eidx.numpy()[plain.mask.numpy() != 0]
    fwd_rows = np.repeat(np.arange(HUB_V), np.bincount(
        src, minlength=HUB_V))
    for u in (0, 1, int(src[-1])):
        ps = pieces_of[row == u]
        assert np.all(np.diff(ps) > 0)
        mine = [fwd_slot[(bb, jj)] for p in ps for bb, jj in zip(b, j)
                if bb * TILE + t.dstl.numpy()[bb, jj] == p]
        assert mine == fwd[fwd_rows == u].tolist()
    hub_pieces = -(-HUB_FANOUT // cap)
    assert int((row == 0).sum()) == hub_pieces


def test_pack_pieces_respects_both_limits():
    lengths = np.array([3, 8, 1, 1, 1, 1, 8, 2, 6, 8], np.int64)
    starts = dataflow.pack_pieces(lengths, 3, 8)
    assert starts.tolist() == [0, 1, 2, 5, 6, 7, 9]
    ends = list(starts[1:]) + [len(lengths)]
    for a, e in zip(starts, ends):
        assert e - a <= 3 and lengths[a:e].sum() <= 8


def test_capped_layout_of_no_edges_is_one_empty_block():
    t = dataflow._transposed(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             np.zeros(0, np.int64), 50, TILE, "cpu", 64)
    assert t.nblocks == 1 and not t.mask.any() and t.fold.num_vertices == 50
    out = ops.seg_agg_transposed(t, torch.ones(70, 3), backend="torch")
    assert out.shape == (50, 3) and not out.any()


@pytest.fixture
def cuda_tier_on_cpu(monkeypatch):
    """The cuda tier with its device check lifted: K1's wrapper then gets
    CPU tensors and runs its plain version inside ``SegAgg``."""
    def check(backend, x):
        assert backend in ("torch", "cuda")
    monkeypatch.setattr(ops, "_check_tier", check)


@pytest.mark.parametrize("cap", [8, 256, 1024, 4096])
@pytest.mark.parametrize("weighted", [False, True])
def test_hub_gradient_through_capped_layout_matches_reference(
        cuda_tier_on_cpu, monkeypatch, cap, weighted):
    """The x gradient of a sum aggregation over the hub graph through
    K1's Function with the capped transposed layout -- one backward fold
    over the pieces and one over the fold-back -- equals ``jax.grad`` of
    the reference's ``aggregate``, in the f32 band at every cap."""
    folds = {"fwd": 0, "bwd": 0}
    fold = k1._fold

    def spy(*args, backward=False, **kw):
        folds["bwd" if backward else "fwd"] += 1
        return fold(*args, backward=backward, **kw)
    monkeypatch.setattr(k1, "_fold", spy)
    src, dst = _hub_edges()
    jg = jgraph_from_coo(jnp.asarray(src, jnp.int32),
                         jnp.asarray(dst, jnp.int32), HUB_V)
    tg = graph_from_coo(src, dst, HUB_V, device="cpu")
    rng = np.random.default_rng(cap)
    x = rng.standard_normal((HUB_V, 4)).astype(np.float32)
    cot = rng.standard_normal((HUB_V, 4)).astype(np.float32)
    w = rng.random(len(src)).astype(np.float32) if weighted else None
    layout = _capped_layout(tg.src.numpy(), tg.dst.numpy(), cap)

    def jloss(xx):
        return jnp.sum(jaggregate(jg, xx, op="sum", backend="xla",
                                  edge_weight=None if w is None
                                  else jnp.asarray(w)) * cot)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    h = aggregate(tg, xt, op="sum", backend="cuda", layout=layout,
                  edge_weight=None if w is None else torch.from_numpy(w))
    (got,) = torch.autograd.grad((h * torch.from_numpy(cot)).sum(), [xt])
    assert_allclose_dtype(got.numpy(), want)
    assert folds == {"fwd": 1, "bwd": 2}


def test_shard_transposes_stay_near_the_edges(monkeypatch):
    """At the test graph's 4 shards the capped transposed sub-layouts, cut
    at 64 slots, hold at most 2x the edges' slots (the uncapped ones'
    blocks grow with their longest row), every edge once."""
    monkeypatch.setattr(tdist, "TRANSPOSE_CAP", 64)
    tp = tpart.partition_1d(TG, 4, edge_balanced=False)
    tls = tdist.shard_transposed_layouts(tp)
    edges = sum(int(lay.mask.sum()) for lays in tls.values()
                for lay in lays)
    assert edges == TG.num_edges
    pieces = sum(lay.nblocks * lay.emax for lays in tls.values()
                 for lay in lays)
    assert pieces <= 2 * edges + 16 * 8 * TILE
    assert all(lay.emax <= 64 for lays in tls.values() for lay in lays)


# ---------------------------------------------------------------------------
# LocalMesh gradients against jax.grad of the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("strategy,overlap", STRATEGIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mesh_plan_gradients_match_reference(shape, strategy, overlap,
                                             dtype):
    """Every layer's W and bias gradient of the mean NLL through a mesh
    plan equals ``jax.grad`` of the reference in the dtype's band,
    relative to the leaf's largest magnitude: its eager single-device
    plan (f32, int8-agg), its distributed layer with the halo summed on
    one device (bf16)."""
    _, tm = _model()
    plan = tm.plan_for(TG, mesh=_mesh(shape), strategy=strategy,
                       overlap=overlap, dtype=dtype)
    assert [lp.order for lp in plan.layers] == ["combine_first"] * 2
    got = _port_grads(plan)
    want = _reference_dist_grads(shape[0]) if dtype == "bf16" else \
        _reference_grads(dtype, shape[1] if len(shape) == 2 else 1)
    for name, g in got.items():
        c, d, k = name.split(".")
        _assert_leaf(g.numpy(), want[c][d][k], dtype, name)


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_gradients_through_cut_rows_match_reference(monkeypatch, strategy):
    """With the transposed sub-layouts cut at 8 slots (every source row
    of more than 8 out-edges in a sub-layout folds back from pieces), the
    gradients stay in the f32 band of the reference's and within it of the
    uncut layouts' (another addition order)."""
    from repro_torch.core import plan as tplan
    _, tm = _model()
    uncut = _port_grads(tm.plan_for(TG, mesh=_mesh((2,)),
                                    strategy=strategy))
    tplan.clear_plan_cache()
    monkeypatch.setattr(tdist, "TRANSPOSE_CAP", 8)
    plan = tm.plan_for(TG, mesh=_mesh((2,)), strategy=strategy)
    lays = [lay for per in plan.shard_transposed().values() for lay in per]

    def pieces_and_rows(lay):
        m = lay.fold.mask != 0
        rows = torch.nonzero(m)[:, 0] * lay.tile_m + lay.fold.dstl[m]
        return int(m.sum()), len(rows.unique())
    assert any(p > r for p, r in map(pieces_and_rows, lays))
    assert all(lay.emax <= 8 for lay in lays)
    got = _port_grads(plan)
    tplan.clear_plan_cache()
    want = _reference_grads("f32")
    for name, g in got.items():
        c, d, k = name.split(".")
        _assert_leaf(g.numpy(), want[c][d][k], "f32", name)
        _assert_leaf(g.numpy(), uncut[name].numpy(), "f32", name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ring_schedules_give_bitwise_equal_gradients(shape, dtype):
    """none and pipelined rings add the same partials in the same order in
    the backward as in the forward: every gradient bit for bit."""
    _, tm = _model()
    grads = [_port_grads(tm.plan_for(TG, mesh=_mesh(shape), overlap=ov,
                                     dtype=dtype))
             for ov in ("none", "pipelined")]
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


@pytest.mark.parametrize("order", ["combine_first", "aggregate_first"])
def test_aggregate_first_gradients_match_reference(order):
    """Either phase order's gradients (the halo on dout- or din-wide
    rows) in the f32 band of the reference's same-order plan."""
    params, tm = _model()
    plan = tm.plan_for(TG, mesh=_mesh((4,)), ordering=order)
    got = _port_grads(plan)
    jplan = jbuild_plan(JG, JCFG, JSPEC.feature_len, JSPEC.num_classes,
                        backend="xla", machine="h100", ordering=order)
    want = jax.grad(lambda p: _nll(jplan.run_model(p, JX), JY))(params)
    for name, g in got.items():
        c, d, k = name.split(".")
        _assert_leaf(g.numpy(), np.asarray(want[c][d][k]), "f32", name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("strategy,overlap", STRATEGIES)
def test_backward_moves_the_forwards_bytes(shape, strategy, overlap):
    """The backward's counted collective bytes: the halo's equal the
    forward's (``schedule_wire_bytes``), each layer; on the 2-D mesh the
    ``psum_scatter``'s adjoint all-gathers the (block, fb_out) output
    gradient, 1/Q of the forward's reduce-scatter operand."""
    _, tm = _model()
    mesh = _mesh(shape)
    plan = tm.plan_for(TG, mesh=mesh, strategy=strategy, overlap=overlap)
    two_d = plan.partition_kind == "2d"
    sched = [tdist.schedule_wire_bytes(
        plan.partition, lp.din if lp.order == "aggregate_first" else lp.dout,
        strategy=strategy, overlap=overlap,
        combine_out_len=lp.dout if two_d else None)
        for lp in plan.layers]
    tm.zero_grad()
    mesh.reset_counts()
    loss = tm.loss_fn(TG, TX, TY, plan=plan)
    fwd = mesh.collective_bytes()
    mesh.reset_counts()
    loss.backward()
    bwd = mesh.collective_bytes()
    assert fwd["total"] == sum(s["total_bytes"] for s in sched)
    halo_f = fwd["collective-permute"] + fwd["all-gather"]
    halo_b = bwd["collective-permute"] + bwd["all-gather"]
    q = plan.partition.feat_shards if two_d else 1
    rs = fwd["reduce-scatter"]
    assert halo_b - rs // q == halo_f and bwd["reduce-scatter"] == 0
    assert bwd["all-reduce"] == 0             # one shared W: autograd sums
    if not two_d:
        assert bwd["total"] == fwd["total"]


def test_transposed_layouts_are_built_once_and_cached():
    """A mesh plan builds its transposed sub-layouts on the first
    backward and reuses them; both strategies fold the same ones; the
    host builder never runs inside a backward."""
    from repro_torch.core import plan as tplan
    tplan.clear_plan_cache()
    _, tm = _model()
    mesh = _mesh((4,))
    ring = tm.plan_for(TG, mesh=mesh)
    ag = tm.plan_for(TG, mesh=mesh, strategy="allgather")
    with torch.no_grad():
        tm(TG, TX, plan=ring)
    assert len(tplan._SHARD_CACHE) == 2       # the two strategies' layouts
    loss = tm.loss_fn(TG, TX, TY, plan=ring)
    assert len(tplan._SHARD_CACHE) == 3
    assert ring.shard_transposed() is ag.shard_transposed()
    built = tdist.shard_transposed_layouts
    try:
        tdist.shard_transposed_layouts = None     # any call would raise
        loss.backward()
        tm.loss_fn(TG, TX, TY, plan=ag).backward()
    finally:
        tdist.shard_transposed_layouts = built
    tplan.clear_plan_cache()


def test_standalone_layers_differentiate():
    """``distributed_gcn_layer`` (1-D) and ``distributed_gcn_layer_2d``
    outside a plan: x, w and bias gradients equal the plan-free local
    layer's in the f32 band (transposed sub-layouts built here)."""
    from repro_torch.core.phases import _mm
    rng = np.random.default_rng(5)
    w0 = torch.from_numpy(rng.standard_normal((32, 6)).astype(np.float32))
    b0 = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((TG.num_vertices, 6))
                           .astype(np.float32))

    def run(fn):
        x, w, b = (t.clone().requires_grad_() for t in (TX, w0, b0))
        out = fn(x, w, b)[:TG.num_vertices, :6]
        return torch.autograd.grad((out * cot).sum(), [x, w, b])

    def local(x, w, b):
        h = _mm(x, w)
        agg = torch.zeros_like(h).index_add_(0, TG.dst, h[TG.src])
        deg = TG.in_deg.float()[:, None] + 1.0
        return (agg + h) * (1.0 / deg) + b
    want = run(local)
    tp = tpart.partition_1d(TG, 4, edge_balanced=False)
    p2 = tpart.partition_2d(TG, 2, 2)
    got1 = run(lambda x, w, b: tdist.distributed_gcn_layer(
        tp, x, w, b, TG.in_deg, _mesh((4,)), order="combine_first"))
    got2 = run(lambda x, w, b: tdist.distributed_gcn_layer_2d(
        p2, tdist.pad_features_2d(x, p2), w, b, TG.in_deg,
        tdist.LocalMesh((2, 2), ("node", "feat"), device="cpu"),
        order="combine_first"))
    for got in (got1, got2):
        for g, wnt in zip(got, want):
            assert_allclose_dtype(g.numpy(), wnt.numpy(), "f32", scale=10)


# ---------------------------------------------------------------------------
# int8 error-feedback all-reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((8,), "data"), ((4, 2), "node"),
                                        ((4, 2), "feat")])
def test_compressed_allreduce_matches_mean(shape, axis):
    """The reference's ``test_compressed_allreduce_matches_mean`` contract
    on a LocalMesh: every shard holds the same replica, so the mean is the
    input up to int8 quantization, and out + residual gives it back."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((8, 32))
                               .astype(np.float32))}
    mesh = _mesh(shape)
    ar = tcomp.make_compressed_allreduce(mesh, axis)
    out, res2 = ar(g, tcomp.init_residuals(g))
    err = float((out["w"] - g["w"]).abs().max())
    scale = float(g["w"].abs().max()) / 127
    assert err <= scale * 1.01 + 1e-6
    assert float((out["w"] + res2["w"] - g["w"]).abs().max()) < 1e-5
    counts = mesh.collective_bytes()
    assert counts["counts"]["all-reduce"] == 2     # q and the scale
    assert counts["all-reduce"] == 8 * 32 * 4 + 4


@pytest.mark.parametrize("shards", [1, 2])
def test_compressed_allreduce_bitwise_reference(shards):
    """On the same numpy input the LocalMesh all-reduce equals, bit for
    bit, the reference's ``make_compressed_allreduce`` on a one-device
    mesh (its ``_quantize`` round trip, q * scale, and the residual): at
    one or two shards the mean scale and the int32 sum are exact."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((16, 5)).astype(np.float32) * 3
    r = rng.standard_normal((16, 5)).astype(np.float32) * 0.01
    jmesh = jax.make_mesh((1,), ("data",))
    with jmesh:
        jout, jres = jcomp.make_compressed_allreduce(jmesh, "data")(
            {"w": jnp.asarray(g)}, {"w": jnp.asarray(r)})
    out, res = tcomp.make_compressed_allreduce(_mesh((shards,)), "data")(
        {"w": torch.from_numpy(g)}, {"w": torch.from_numpy(r)})
    assert np.array_equal(out["w"].numpy(), np.asarray(jout["w"]))
    assert np.array_equal(res["w"].numpy(), np.asarray(jres["w"]))


def test_psum_keeps_integers():
    mesh = _mesh((4, 2))
    xs = [torch.full((3,), i, dtype=torch.int32) for i in range(8)]
    node = mesh.psum(xs, "node")
    assert node[0].dtype == torch.int32
    assert node[0].tolist() == [0 + 2 + 4 + 6] * 3
    assert mesh.psum(xs)[5].tolist() == [28] * 3


# ---------------------------------------------------------------------------
# the example's training half
# ---------------------------------------------------------------------------


def test_example_training_matches_reference_loop():
    """``launch/distributed_gcn.py``'s ``train`` over an 8-shard ring for
    5 steps, from the reference's initial params: its losses equal a loop
    of the reference's pieces -- ``jax.grad`` of the mean NLL through the
    reference's local plan, ``_quantize`` with error feedback (8 equal
    replicas: the mean is q * scale), SGD at lr 0.25 -- in the f32 band."""
    from repro.graph.datasets import make_features, make_labels, \
        make_synthetic_graph
    from repro_torch.launch import distributed_gcn as launch
    spec, g, x, y = launch.example_data("cpu")
    jspec = reduced_graph(CORA, 512, 64)
    jg, jy = make_synthetic_graph(jspec), make_labels(jspec)
    jx = make_features(jspec).at[:, :jspec.num_classes].add(
        4.0 * jax.nn.one_hot(jy, jspec.num_classes))
    assert np.array_equal(x.numpy(), np.asarray(jx))
    cfg = dataclasses.replace(JMODELS["gcn"], hidden_dims=(16,))
    params = JGCNModel(cfg, jspec.feature_len,
                       jspec.num_classes).init(jax.random.PRNGKey(0))
    model = GCNModel(TCFG, spec.feature_len, spec.num_classes, device="cpu")
    model.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
    jplan = jbuild_plan(jg, cfg, jspec.feature_len, jspec.num_classes,
                        backend="xla", machine="h100")
    grad_fn = jax.value_and_grad(lambda p: _nll(jplan.run_model(p, jx), jy))
    res = jcomp.init_residuals(params)
    want = []
    for _ in range(5):
        loss, grads = grad_fn(params)
        flat, tree = jax.tree_util.tree_flatten(grads)
        outs = [jcomp._quantize(gg, rr)
                for gg, rr in zip(flat, jax.tree_util.tree_leaves(res))]
        grads = tree.unflatten([q.astype(jnp.float32) * s
                                for q, s, _ in outs])
        res = tree.unflatten([r for _, _, r in outs])
        params = jax.tree_util.tree_map(lambda p, gg: p - 0.25 * gg,
                                        params, grads)
        want.append(float(loss))
    mesh = _mesh((8,))
    plan = model.plan_for(g, mesh=mesh)
    got = launch.train(model, plan, g, x, y, steps=5, lr=0.25,
                       allreduce=tcomp.make_compressed_allreduce(mesh,
                                                                 "data"))
    assert_allclose_dtype(np.array(got), np.array(want), "f32")
    final = jax.tree_util.tree_map(np.asarray, params)
    for name, p in model.named_parameters():
        c, d, k = name.split(".")
        assert_allclose_dtype(p.detach().numpy(), final[c][d][k], "f32",
                              scale=10, err_msg=name)


def test_launcher_trains_on_cpu(capsys, monkeypatch):
    """``--train`` on the CPU, cut to 6 of the example's steps."""
    from repro_torch.launch import distributed_gcn
    monkeypatch.setattr(distributed_gcn, "STEPS", 6)
    distributed_gcn.main(["--device", "cpu", "--train"])
    out = capsys.readouterr().out
    assert "step  0" in out and "step  5" in out
    assert "int8+EF" in out and "final accuracy" in out
    drift = float(out.rsplit("max |diff| ", 1)[1].split(")")[0])
    assert drift < 1e-4
