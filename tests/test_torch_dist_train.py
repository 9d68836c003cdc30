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


def _block_rows(lay):
    """The valid slots of a layout in slot order: (block row b * tile_m +
    dstl, the row each gathers, its eidx), and its row map flattened."""
    m = lay.mask.numpy() != 0
    b, j = np.nonzero(m)
    row = b * lay.tile_m + lay.dstl.numpy()[b, j]
    eidx = None if lay.eidx is None else lay.eidx.numpy()[b, j]
    return row, lay.src.numpy()[b, j], eidx, lay.out_rows.numpy().ravel()


@pytest.mark.parametrize("cap", [8, 64, 1024])
def test_capped_layout_holds_every_edge_once_in_order(cap):
    """The capped transposed layout of the hub graph: each forward slot
    once; each piece at most ``cap`` slots and each block at most
    ``tile_m`` pieces; every row of ``[0, HUB_V)`` written exactly once,
    by the pieces' row map (an uncut row: its piece holds its edges in
    their forward order) or by the fold-back's (a cut row: one over
    ``cap`` or over ``packed_split``); scratch rows only for the cut
    rows' pieces, each once; the fold-back holds exactly the cut sources,
    each gathering its pieces in order, which hold its edges in their
    forward order."""
    src, dst = _hub_edges()
    bg = _capped_layout(src, dst, cap)
    t, f = bg.transposed, bg.transposed.fold
    plain = dataflow.block_graph_arrays(src, dst, HUB_V, TILE,
                                        transpose_rows=HUB_V).transposed
    assert t.emax <= cap and plain.fold is None and plain.out_rows is None
    assert t.num_vertices == HUB_V and t.out_rows.shape == (t.nblocks, TILE)
    row, _, eidx, tmap = _block_rows(t)
    assert len(eidx) == len(src) and sorted(eidx.tolist()) == sorted(
        plain.eidx.numpy()[plain.mask.numpy() != 0].tolist())
    # pieces: block rows in slot order, at most cap slots each, and only
    # block rows with a destination hold slots
    assert np.all(np.diff(row) >= 0)
    assert np.bincount(row).max() <= cap
    assert np.all(tmap[row] >= 0)
    # each source's edges in forward order, and which sources are cut
    fwd = plain.eidx.numpy()[plain.mask.numpy() != 0]
    n = np.bincount(src, minlength=HUB_V)
    fwd_of = np.split(fwd, np.cumsum(n)[:-1])
    cut = np.flatnonzero(n > min(cap, k1.packed_split(cap, TILE)))
    assert 0 in cut.tolist()
    # the pieces' map: each uncut row once, scratch rows once each, in
    # piece order; the rows no piece took are -1
    used = tmap[tmap >= 0]
    final, scratch = used[used < HUB_V], used[used >= HUB_V]
    assert len(set(final.tolist())) == len(final)
    assert sorted(final.tolist()) == sorted(set(range(HUB_V)) - set(
        cut.tolist()))
    assert sorted(scratch.tolist()) == list(range(HUB_V, HUB_V + len(
        scratch)))
    assert len(scratch) == int((-(-n[cut] // cap)).sum())
    slots_of = {int(r): eidx[row == r].tolist() for r in np.unique(row)}
    for u in set(range(HUB_V)) - set(cut.tolist()):
        (k,) = np.flatnonzero(tmap == u)
        assert slots_of.get(int(k), []) == fwd_of[u].tolist()
    # the fold-back: exactly the cut rows, each its scratch rows in order
    assert f is not None and f.num_vertices == len(scratch)
    frow, fsrc, _, fmap = _block_rows(f)
    assert sorted(fmap[fmap >= 0].tolist()) == cut.tolist()
    assert np.all(fmap[frow] >= 0)
    assert sorted(fsrc.tolist()) == list(range(len(scratch)))
    for k in np.unique(frow):
        u = int(fmap[k])
        ps = fsrc[frow == k]
        assert np.all(np.diff(ps) > 0)
        mine = [e for p in ps
                for e in slots_of[int(np.flatnonzero(tmap == HUB_V + p)[0])]]
        assert mine == fwd_of[u].tolist()
    assert int((frow == np.flatnonzero(fmap == 0)[0]).sum()) == \
        -(-HUB_FANOUT // cap)


def test_capped_layout_with_no_cut_row_has_no_fold_back(monkeypatch):
    """The hub graph without its hub: no row over ``packed_split``, so
    no fold-back, each row's piece stored in place, and K1's backward one
    fold (one launch on a card), equal to the uncapped layout's plain
    fold."""
    folds = []
    fold = k1._fold
    monkeypatch.setattr(k1, "_fold", lambda *a, **kw: folds.append(1)
                        or fold(*a, **kw))
    src, dst = _hub_edges()
    src, dst = src[src != 0], dst[src != 0]
    assert np.bincount(src).max() <= k1.packed_split(1024, TILE)
    t = _capped_layout(src, dst, 1024).transposed
    assert t.fold is None and t.emax <= 1024
    tmap = t.out_rows.numpy().ravel()
    assert sorted(tmap[tmap >= 0].tolist()) == list(range(HUB_V))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (HUB_V, 5)).astype(np.float32))
    got = ops.seg_agg_transposed(t, g, backend="torch")
    assert len(folds) == 1 and got.shape == (HUB_V, 5)
    plain = dataflow.block_graph_arrays(src, dst, HUB_V, TILE,
                                        transpose_rows=HUB_V).transposed
    want = ops.seg_agg_transposed(plain, g, backend="torch")
    assert torch.equal(got, want)


#: the (vec, c) instances csrc/seg_agg.cu builds for a packed launch
PACKED_INSTANCES = {(4, 1), (2, 1), (2, 2), (1, 1), (1, 2), (1, 3), (1, 4)}


@pytest.mark.parametrize("f", [1, 7, 41, 64, 128, 602])
@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("align", [16, 8, 4, 2])
def test_packed_launches_have_an_instance(f, elt, align):
    """A packed launch (over a capped transposed layout) at any width: its
    slice is all of F up to ``PACKED_SLICE`` columns, and its (vec, c)
    over warp-wide units covers the slice with one of the instances the
    kernel builds, every lane's load inside the slice."""
    width, blocks_first = k1.packed_launch(f, elt, align)
    assert width == min(f, k1.PACKED_SLICE) and not blocks_first
    if align < elt:
        return
    vec, c = k1.launch_params(f, width, elt, align, k1.PACKED_LANES)
    assert (vec, c) in PACKED_INSTANCES
    assert k1.PACKED_LANES * vec * c >= width and vec * c <= 8
    assert f % vec == 0 and width % vec == 0 and align % (vec * elt) == 0
    # the forward's 8-lane units keep their own choice
    assert k1.launch_params(f, k1.slice_cols(f), elt, align) == \
        k1.launch_params(f, k1.slice_cols(f), elt, align, k1.UNIT_LANES)


@pytest.mark.parametrize("cap", [8, 256, 1024, 2048, 4096])
def test_packed_split_and_shared_memory(cap):
    """``packed_split``: a warp unit's share of a full block, the longest
    row the capped layout stores in place; a packed launch's shared memory
    (chunk table, row map, chunk sums of ``PACKED_SLICE`` columns) fits a
    CTA at every cap, and its chunk count bounds what the split rows of a
    full block can hold."""
    t = k1.packed_split(cap, 128)
    assert t == max(1, (cap + 128) // k1.PACKED_UNITS)
    chunks = k1.max_chunks(cap, t, k1.PACKED_UNITS)
    assert chunks == cap // (t + 1) + k1.PACKED_UNITS - 1
    smem = k1.fold_smem_bytes(128, cap, k1.PACKED_SLICE, True, t)
    assert smem == 4 * (2 * 129 + 128 + chunks * k1.PACKED_SLICE)
    assert smem <= k1.SMEM_LIMIT
    # the forward's default is unchanged
    assert k1.fold_smem_bytes(128, cap, 64) == \
        4 * (2 * 129 + k1.max_chunks(cap) * 64)


def test_plain_row_mapped_fold_leaves_unnamed_rows():
    """The plain version of a row-mapped fold (``_fold`` on the CPU):
    each block row's sum lands on the row its map names, the rows no map
    entry names keep what they held, and -1 rows are dropped."""
    src, dst = _hub_edges()
    t = _capped_layout(src, dst, 64).transposed
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (HUB_V, 3)).astype(np.float32))
    out = torch.full((HUB_V + t.fold.num_vertices + 5, 3), 7.0)
    k1._fold(g, t.src, t.dstl, t.mask, None, t.tile_m, backward=True,
             out=out, out_rows=t.out_rows, split_from=HUB_V)
    rows = k1.seg_agg_plain(g, t.src, t.dstl, t.mask, tile_m=t.tile_m)
    tmap = t.out_rows.reshape(-1)
    named = tmap >= 0
    assert torch.equal(out[tmap[named].long()], rows[named])
    assert bool((out[-5:] == 7.0).all())


def test_pack_pieces_respects_both_limits():
    lengths = np.array([3, 8, 1, 1, 1, 1, 8, 2, 6, 8], np.int64)
    starts = dataflow.pack_pieces(lengths, 3, 8)
    assert starts.tolist() == [0, 1, 2, 5, 6, 7, 9]
    ends = list(starts[1:]) + [len(lengths)]
    for a, e in zip(starts, ends):
        assert e - a <= 3 and lengths[a:e].sum() <= 8


def test_capped_layout_of_no_edges_is_one_empty_block():
    """No edges: empty blocks of one empty piece a row (the 50 rows fill
    two blocks of 32), so K1 stores each row's zeros once; no
    fold-back."""
    t = dataflow._transposed(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             np.zeros(0, np.int64), 50, TILE, "cpu", 64)
    assert t.nblocks == -(-50 // TILE) and not t.mask.any()
    assert t.fold is None
    tmap = t.out_rows.numpy().ravel()
    assert sorted(tmap[tmap >= 0].tolist()) == list(range(50))
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
    over the pieces and, where the hub's row is cut (its 3,000 slots over
    ``packed_split``), one over the fold-back -- equals
    ``jax.grad`` of the reference's ``aggregate``, in the f32 band at
    every cap."""
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
    cut = HUB_FANOUT > min(cap, k1.packed_split(cap, TILE))
    assert (layout.transposed.fold is not None) == cut
    assert folds == {"fwd": 1, "bwd": 1 + cut}


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
    of more than 8 out-edges in a sub-layout, and those over
    ``packed_split``, folds back from its pieces), the
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
        if lay.fold is None:
            return 0, 0
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
