"""Distributed GCN inference on a ``LocalMesh`` against the JAX package.

The reference's sharded execution needs a multi-device JAX mesh, which its
own tests fake in subprocesses; the port is held instead to what runs here:

* exact: ``partition_1d``/``partition_2d`` arrays and ``edge_balance``,
  ``halo_bytes(_2d)``, ``overlap_model``, ``choose_overlap`` on every
  Machine preset, ``schedule_wire_bytes`` for every (strategy, overlap,
  dtype), ``describe()`` and the instrumented records' analytic fields --
  all equal the reference's functions;
* per shard: the port's ``_local_agg`` / ``_hop_partial`` (K1's plain
  version over the shard layouts) against the reference's jnp functions
  called per shard, in the f32 band;
* aggregation and whole plans: against the reference's UNSHARDED eager
  output, in each dtype's band (``tests/tolerance.py``); the ring's two
  schedules bit for bit; the mesh's counted bytes equal to
  ``schedule_wire_bytes`` layer by layer.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA, reduced_graph
from repro.core import distributed as jdist
from repro.core import phases as jphases
from repro.core.plan import build_plan as jbuild_plan
from repro.graph import partition as jpart
from repro.graph.datasets import make_features as jfeatures
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.models.gcn import PAPER_MODELS as JMODELS
from repro.models.gcn import GCNModel as JGCNModel
from repro.profile import machine as jmachine
from repro_torch import config as tconfig
from repro_torch.core import characterize as tchar
from repro_torch.core import distributed as tdist
from repro_torch.core import plan as tplan
from repro_torch.graph import partition as tpart
from repro_torch.graph.datasets import make_features as tfeatures
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.kernels import seg_agg as k1
from repro_torch.models.gcn import PAPER_MODELS, GCNModel
from repro_torch.profile import machine as tmachine

torch.set_num_threads(2)

JSPEC = reduced_graph(CORA, 300, 32)
TSPEC = tconfig.reduced_graph(tconfig.CORA, 300, 32)
JG, TG = jgraph(JSPEC), tgraph(TSPEC, device="cpu")
JX, TX = jfeatures(JSPEC), tfeatures(TSPEC, device="cpu")
V = TSPEC.num_vertices
#: the reference's distributed tests' model: GCN 32 -> 16 -> 7
JCFG = dataclasses.replace(JMODELS["gcn"], hidden_dims=(16,))
TCFG = dataclasses.replace(PAPER_MODELS["gcn"], hidden_dims=(16,))
MESHES_1D = [1, 2, 4, 8]
MESHES_2D = [(2, 2), (4, 2)]
STRATEGIES = [("allgather", "none"), ("ring", "none"), ("ring", "pipelined"),
              ("ring", "auto")]


def _mesh(shape):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    names = ("data",) if len(shape) == 1 else ("node", "feat")
    return tdist.LocalMesh(shape, names, device="cpu")


def _fake_jmesh(shape):
    """A stand-in for a JAX mesh of ``shape``: the reference's build_plan
    reads only its axis names, shape and device count (the partition is
    built on the host), so its plan metadata needs no devices."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    names = ("data",) if len(shape) == 1 else ("node", "feat")
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)),
                                 devices=np.empty(shape, object))


_PARAMS = {}


def _model():
    """The reference's params (seed 0) and the port's model holding them."""
    if "p" not in _PARAMS:
        jm = JGCNModel(JCFG, JSPEC.feature_len, JSPEC.num_classes)
        params = jm.init(jax.random.PRNGKey(0))
        tm = GCNModel(TCFG, TSPEC.feature_len, TSPEC.num_classes,
                      device="cpu")
        tm.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
        _PARAMS["p"] = (params, tm)
    return _PARAMS["p"]


_REFS = {}


def _reference(order, dtype):
    """The reference's unsharded eager forward (local plan, xla tier)."""
    key = (order, dtype)
    if key not in _REFS:
        params, _ = _model()
        plan = jbuild_plan(JG, JCFG, JSPEC.feature_len, JSPEC.num_classes,
                           backend="xla", ordering=order, machine="h100",
                           dtype=dtype)
        _REFS[key] = np.asarray(plan.run_model(params, JX), np.float32)
    return _REFS[key]


def _np(t):
    return np.asarray(t.float().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t)


# ---------------------------------------------------------------------------
# partitions, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("balanced", [False, True])
def test_partition_1d_equals_reference(shards, balanced):
    jp = jpart.partition_1d(JG, shards, edge_balanced=balanced)
    tp = tpart.partition_1d(TG, shards, edge_balanced=balanced)
    assert tp.src.device.type == "cpu"
    for name in ("src", "dst_local", "mask", "vtx_start"):
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (tp.block_size, tp.num_vertices, tp.num_shards) == \
        (jp.block_size, jp.num_vertices, jp.num_shards)
    assert tp.src.shape[1] % 8 == 0
    assert tpart.edge_balance(tp) == jpart.edge_balance(jp)


@pytest.mark.parametrize("p,q", [(1, 1), (2, 2), (4, 2), (3, 4)])
def test_partition_2d_equals_reference(p, q):
    jp, tp = jpart.partition_2d(JG, p, q), tpart.partition_2d(TG, p, q)
    assert (tp.node_shards, tp.feat_shards, tp.block_size,
            tp.num_vertices) == (jp.node_shards, jp.feat_shards,
                                 jp.block_size, jp.num_vertices)
    for name in ("src", "dst_local", "mask", "vtx_start"):
        assert np.array_equal(getattr(tp.nodes, name).numpy(),
                              np.asarray(getattr(jp.nodes, name)))
    for f in (1, 7, 16, 32, 33):
        assert tp.feature_block(f) == jp.feature_block(f)
    with pytest.raises(ValueError, match="positive"):
        tpart.partition_2d(TG, 0, 2)


# ---------------------------------------------------------------------------
# the analytic side, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_halo_bytes_equal_reference(shards):
    jp = jpart.partition_1d(JG, shards, edge_balanced=False)
    tp = tpart.partition_1d(TG, shards, edge_balanced=False)
    for f in (7, 16, 32):
        for b in (2, 4):
            assert tdist.halo_bytes(tp, f, b) == jdist.halo_bytes(jp, f, b)
    j2, t2 = jpart.partition_2d(JG, shards, 2), tpart.partition_2d(
        TG, shards, 2)
    for f in (7, 16, 32):
        assert tdist.halo_bytes_2d(t2, f) == jdist.halo_bytes_2d(j2, f)
    # the reference's Q-fold halo saving on top of Table 4's in/out ratio
    assert tdist.halo_bytes_2d(t2, 32)["min_halo_bytes"] * 2 == \
        tdist.halo_bytes(tp, 32)["min_halo_bytes"]


@pytest.mark.parametrize("machine", sorted(tmachine.MACHINES))
@pytest.mark.parametrize("shards", [1, 4, 8])
def test_overlap_pricing_equals_reference(machine, shards):
    jp = jpart.partition_1d(JG, shards, edge_balanced=False)
    tp = tpart.partition_1d(TG, shards, edge_balanced=False)
    jm, tm = jmachine.MACHINES[machine], tmachine.MACHINES[machine]
    for strategy in ("ring", "allgather"):
        for f in (7, 16, 32):
            for b in (2, 4):
                assert tdist.overlap_model(tp, f, tm, strategy=strategy,
                                           dtype_bytes=b) == \
                    jdist.overlap_model(jp, f, jm, strategy=strategy,
                                        dtype_bytes=b)
        for lens in (16, [16, 7], [32, 16], [4, 1]):
            assert tdist.choose_overlap(tp, lens, tm, strategy=strategy) == \
                jdist.choose_overlap(jp, lens, jm, strategy=strategy)
    fast = dataclasses.replace(tm, interconnect_bw=1e18, link_latency_s=0.0)
    assert tdist.choose_overlap(tp, [16, 7], fast) == "none"


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
@pytest.mark.parametrize("overlap", ["none", "pipelined"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8-agg"])
def test_schedule_wire_bytes_equal_reference(strategy, overlap, dtype):
    for shards in (1, 2, 4, 8):
        jp = jpart.partition_1d(JG, shards, edge_balanced=False)
        tp = tpart.partition_1d(TG, shards, edge_balanced=False)
        for f in (7, 16, 32):
            assert tdist.schedule_wire_bytes(
                tp, f, strategy=strategy, overlap=overlap, dtype=dtype) == \
                jdist.schedule_wire_bytes(jp, f, strategy=strategy,
                                          overlap=overlap, dtype=dtype)
        j2, t2 = jpart.partition_2d(JG, shards, 2), \
            tpart.partition_2d(TG, shards, 2)
        assert tdist.schedule_wire_bytes(
            t2, 32, strategy=strategy, overlap=overlap, dtype=dtype,
            combine_out_len=16) == jdist.schedule_wire_bytes(
            j2, 32, strategy=strategy, overlap=overlap, dtype=dtype,
            combine_out_len=16)
    assert tdist.wire_dtype_bytes(dtype) == jdist.wire_dtype_bytes(dtype)
    with pytest.raises(ValueError, match="combine_out_len"):
        tdist.schedule_wire_bytes(tpart.partition_2d(TG, 2, 2), 32)


# ---------------------------------------------------------------------------
# per shard, against the reference's jnp functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_per_shard_bodies_match_reference(shards):
    """``_local_agg`` over a shard's all-gather layout and ``_hop_partial``
    over its ring sub-layouts, against the reference's jnp bodies called
    per shard with ``p`` a Python int."""
    jp = jpart.partition_1d(JG, shards, edge_balanced=False)
    tp = tpart.partition_1d(TG, shards, edge_balanced=False)
    block = tp.block_size
    xp = tdist.pad_features(TX, block, shards)
    jxp = jdist.pad_features(JX, block, shards)
    ag = tdist.shard_layouts(tp, "allgather")
    ring = tdist.shard_layouts(tp, "ring")
    for p in range(shards):
        args = (jp.src[p], jp.dst_local[p], jp.mask[p], block)
        got = tdist._local_agg(xp, ag[p], backend="torch")
        assert got.dtype == torch.float32 and got.shape == (block, 32)
        assert_allclose_dtype(_np(got), jdist._local_agg(jxp, *args))
        for k in range(shards):
            owner = (p - k) % shards
            buf = xp[owner * block:(owner + 1) * block]
            want = jdist._hop_partial(jxp[owner * block:(owner + 1) * block],
                                      k, p, *args, shards)
            got = tdist._hop_partial(buf, k, p, ring[p], shards,
                                     backend="torch")
            assert_allclose_dtype(_np(got), want)
        # a bf16 slab: f32 partials (K1's bf16-in/f32-out entry's plain
        # version), as the reference's promoted accumulator
        got = tdist._hop_partial(xp[:block].to(torch.bfloat16), 0, 0,
                                 ring[0], shards, backend="torch")
        want = jdist._hop_partial(jxp[:block].astype(jax.numpy.bfloat16), 0,
                                  0, jp.src[0], jp.dst_local[0], jp.mask[0],
                                  block, shards)
        assert got.dtype == torch.float32
        assert_allclose_dtype(_np(got), want)
    # the ring's sub-layouts hold each edge of the shard once
    slots = sum(int(lay.mask.sum()) for p in range(shards) for lay in ring[p])
    assert slots == TG.num_edges


# ---------------------------------------------------------------------------
# aggregation against the reference's unsharded aggregate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", MESHES_1D)
def test_aggregation_strategies_match_unsharded(shards):
    """The reference's ``test_distributed_aggregation_strategies`` held to
    its unsharded ``aggregate(op="sum", include_self=False)``; the ring's
    schedules bit for bit; the counted bytes as scheduled."""
    tp = tpart.partition_1d(TG, shards, edge_balanced=False)
    mesh = _mesh(shards)
    xp = tdist.pad_features(TX, tp.block_size, shards)
    ref = np.asarray(jphases.aggregate(JG, JX, op="sum", include_self=False))
    mesh.reset_counts()
    a1 = tdist.aggregate_allgather(tp, xp, mesh)
    assert mesh.collective_bytes()["all-gather"] == \
        tdist.schedule_wire_bytes(tp, 32, strategy="allgather")["total_bytes"]
    assert_allclose_dtype(_np(a1[:V]), ref, scale=10)
    outs = {}
    for ov in ("none", "pipelined"):
        mesh.reset_counts()
        outs[ov] = tdist.aggregate_ring(tp, xp, mesh, overlap=ov)
        cb = mesh.collective_bytes()
        sched = tdist.schedule_wire_bytes(tp, 32, overlap=ov)
        assert cb["collective-permute"] == cb["total"] == \
            sched["total_bytes"]
        assert cb["counts"]["collective-permute"] == sched["ppermute_sends"]
        assert_allclose_dtype(_np(outs[ov][:V]), ref, scale=10)
    assert torch.equal(outs["none"], outs["pipelined"])
    assert not outs["none"][V:].any()       # padding rows stay zero


def test_halo_refuses_bad_requests():
    tp = tpart.partition_1d(TG, 4, edge_balanced=True)
    xp = tdist.pad_features(TX, tp.block_size, 4)
    with pytest.raises(ValueError, match="uniform partition"):
        tdist.aggregate_ring(tp, xp, _mesh(4))
    with pytest.raises(ValueError, match="requires strategy='ring'"):
        tdist._halo_body("allgather", "pipelined")
    with pytest.raises(ValueError, match="unknown overlap"):
        tdist._halo_body("ring", "auto")
    with pytest.raises(ValueError, match="unknown strategy"):
        tdist._halo_body("tree", "none")
    with pytest.raises(ValueError, match="one positive size"):
        tdist.LocalMesh((4,), ("a", "b"), device="cpu")


# ---------------------------------------------------------------------------
# whole plans against the reference's unsharded eager forward
# ---------------------------------------------------------------------------


def _wire_per_layer(plan):
    two_d = plan.partition_kind == "2d"
    return [tdist.schedule_wire_bytes(
        plan.partition, lp.din if lp.order == "aggregate_first" else lp.dout,
        strategy=plan.strategy, overlap=plan.overlap, dtype=plan.dtype,
        combine_out_len=lp.dout if two_d else None)["total_bytes"]
        for lp in plan.layers]


@pytest.mark.parametrize("shape", MESHES_1D + MESHES_2D)
@pytest.mark.parametrize("strategy,overlap", STRATEGIES)
@pytest.mark.parametrize("order", ["combine_first", "aggregate_first"])
def test_plan_matches_unsharded_f32(shape, strategy, overlap, order):
    _, tm = _model()
    mesh = _mesh(shape)
    plan = tm.plan_for(TG, mesh=mesh, strategy=strategy, overlap=overlap,
                       ordering=order)
    assert plan.distributed and plan.partition_kind == \
        ("1d" if isinstance(shape, int) else "2d")
    assert [lp.order for lp in plan.layers] == [order] * 2
    mesh.reset_counts()
    with torch.no_grad():
        out = tm(TG, TX, plan=plan)
    assert out.shape == (V, TSPEC.num_classes) and out.dtype == torch.float32
    assert tchar.collective_bytes(mesh)["total"] == sum(_wire_per_layer(plan))
    assert_allclose_dtype(out.numpy(), _reference(order, "f32"), scale=100)


@pytest.mark.parametrize("shape", [4, (2, 2)])
@pytest.mark.parametrize("strategy,overlap", STRATEGIES[:3])
@pytest.mark.parametrize("order", ["combine_first", "aggregate_first"])
@pytest.mark.parametrize("dtype", ["bf16", "int8-agg"])
def test_plan_matches_unsharded_reduced(shape, strategy, overlap, order,
                                        dtype):
    _, tm = _model()
    mesh = _mesh(shape)
    plan = tm.plan_for(TG, mesh=mesh, strategy=strategy, overlap=overlap,
                       ordering=order, dtype=dtype)
    mesh.reset_counts()
    with torch.no_grad():
        out = tm(TG, TX, plan=plan)
    assert out.dtype == (torch.bfloat16 if dtype == "bf16"
                         else torch.float32)
    assert tchar.collective_bytes(mesh)["total"] == sum(_wire_per_layer(plan))
    assert_allclose_dtype(_np(out), _reference(order, dtype), dtype)


@pytest.mark.parametrize("shape", [2, 8, (4, 2)])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8-agg"])
def test_ring_schedules_bitwise_equal(shape, dtype):
    """none and pipelined: the same partials in the same order, bit for
    bit; two calls of one plan too."""
    _, tm = _model()
    mesh = _mesh(shape)
    outs = []
    with torch.no_grad():
        for ov in ("none", "pipelined", "pipelined"):
            plan = tm.plan_for(TG, mesh=mesh, strategy="ring", overlap=ov,
                               dtype=dtype)
            outs.append(tm(TG, TX, plan=plan))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


def test_reordered_plan_speaks_natural_order():
    _, tm = _model()
    plan = tm.plan_for(TG, mesh=_mesh(4), reorder="degree")
    assert plan.reorder == "degree"
    with torch.no_grad():
        out = tm(TG, TX, plan=plan)
    assert_allclose_dtype(out.numpy(), _reference(None, "f32"), scale=100)


def test_bare_layers_match_reference_layer():
    """The layer entries take the padded layout and return it; against the
    reference's ``phase_ordered_layer`` over the unsharded graph."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((32, 16)) * 0.2).astype(np.float32)
    b = np.zeros(16, np.float32)
    want = np.asarray(jphases.phase_ordered_layer(
        JG, JX, [(w, b)], order="combine_first", agg_op="mean",
        activation="none"))
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    tp = tpart.partition_1d(TG, 8, edge_balanced=False)
    for strategy in ("ring", "allgather"):
        for order in ("combine_first", "aggregate_first"):
            out = tdist.distributed_gcn_layer(
                tp, tdist.pad_features(TX, tp.block_size, 8), tw, tb,
                TG.in_deg, _mesh(8), order=order, strategy=strategy)
            assert out.shape == (8 * tp.block_size, 16)
            assert_allclose_dtype(out[:V].numpy(), want, scale=100)
    p2 = tpart.partition_2d(TG, 4, 2)
    out = tdist.distributed_gcn_layer_2d(
        p2, tdist.pad_features_2d(TX, p2), tw, tb, TG.in_deg,
        _mesh((4, 2)), order="combine_first")
    assert_allclose_dtype(out[:V, :16].numpy(), want, scale=100)
    with pytest.raises(ValueError, match="padded 2-D layout"):
        tdist.distributed_gcn_layer_2d(p2, TX[:-1], tw, tb, TG.in_deg,
                                       _mesh((4, 2)))
    # the Table-4 saving: combine-first halves the halo bytes 32 -> 16
    assert tdist.halo_bytes(tp, 32)["min_halo_bytes"] == \
        2 * tdist.halo_bytes(tp, 16)["min_halo_bytes"]


# ---------------------------------------------------------------------------
# plan metadata against the reference
# ---------------------------------------------------------------------------

#: every key but the tier and ``interpret`` (the reference's Pallas
#: interpret mode, which the port has no counterpart of)
DESCRIBE_KEYS = ("layer", "kind", "din", "dout", "order", "fused", "tile_m",
                 "distributed", "partition", "overlap", "dtype", "reorder",
                 "compiled", "dedup", "agg_bytes", "agg_flops")


@pytest.mark.parametrize("shape", [1, 4, 8, (4, 2)])
@pytest.mark.parametrize("strategy,overlap", STRATEGIES)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "auto"])
def test_describe_matches_reference(shape, strategy, overlap, dtype):
    """The reference builds its mesh plan on the host (a stand-in mesh of
    the same shape); every decision and the partition equal the port's.
    The reference's tier is xla, the port's torch here; both compile
    their mesh plans."""
    kw = dict(strategy=strategy, overlap=overlap, dtype=dtype)
    jp = jbuild_plan(JG, JCFG, JSPEC.feature_len, JSPEC.num_classes,
                     mesh=_fake_jmesh(shape), machine="h100", **kw)
    tp = tplan.build_plan(TG, TCFG, TSPEC.feature_len, TSPEC.num_classes,
                          device="cpu", mesh=_mesh(shape), **kw)
    assert (tp.overlap, tp.dtype, tp.partition_kind) == \
        (jp.overlap, jp.dtype, jp.partition_kind)
    for t, j in zip(tp.describe(), jp.describe(), strict=True):
        assert {k: t[k] for k in DESCRIBE_KEYS} == \
            {k: j[k] for k in DESCRIBE_KEYS}
        assert (t["backend"], j["backend"]) == ("torch", "xla")
        assert t["compiled"] is True and t["interpret"] is False
    jpart_ = jp.partition.nodes if jp.partition_kind == "2d" else jp.partition
    tpart_ = tp._node_partition
    assert np.array_equal(tpart_.src.numpy(), np.asarray(jpart_.src))


@pytest.mark.parametrize("shape", [4, (4, 2)])
@pytest.mark.parametrize("overlap", ["none", "pipelined"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_instrumented_records_match_reference_functions(shape, overlap,
                                                        dtype):
    """One "distributed" record a layer; its collective, wire and overlap
    fields equal the reference's analytic functions on the reference's
    partition, the report validates and describe() is truthful."""
    _, tm = _model()
    plan = tm.plan_for(TG, mesh=_mesh(shape), overlap=overlap, dtype=dtype)
    rep = plan.instrument().run_model(tm.tree(), TX).validate()
    assert rep.mismatches(plan) == []
    assert rep.plan_summary["partition"] == plan.partition_kind
    two_d = plan.partition_kind == "2d"
    jp = jpart.partition_2d(JG, 4, 2) if two_d else \
        jpart.partition_1d(JG, 4, edge_balanced=False)
    jnodes = jp.nodes if two_d else jp
    h100 = jmachine.MACHINES["h100"]
    for r, lp in zip(rep.records, plan.layers, strict=True):
        flen = lp.din if lp.order == "aggregate_first" else lp.dout
        assert (r.phase, r.feature_len, r.dtype) == ("distributed", flen,
                                                     dtype)
        halo = (jdist.halo_bytes_2d(jp, flen) if two_d
                else jdist.halo_bytes(jp, flen))["min_halo_bytes"]
        assert r.collective_bytes == float(halo) * {"f32": 4, "bf16": 2}[
            dtype] / 4.0
        assert r.wire_collective_bytes == float(jdist.schedule_wire_bytes(
            jp, flen, overlap=overlap, dtype=dtype,
            combine_out_len=lp.dout if two_d else None)["total_bytes"])
        m = jdist.overlap_model(jnodes, jp.feature_block(flen) if two_d
                                else flen, h100)
        want = (m["exposed_pipelined_s"], m["overlapped_pipelined_s"]) \
            if overlap == "pipelined" else (m["exposed_none_s"], 0.0)
        assert (r.exposed_collective_time,
                r.overlapped_collective_time) == want
        agg = jphases.aggregate_cost(JG, flen)
        comb = jphases.combine_cost(V, lp.dims)
        assert (r.flops, r.bytes) == (agg["flops"] + comb["flops"],
                                      agg["bytes"] + comb["bytes"])
    assert_allclose_dtype(_np(rep.output), _reference(None, dtype), dtype,
                          scale=100 if dtype == "f32" else 1)


# ---------------------------------------------------------------------------
# plan threading: validation, caching, refusals
# ---------------------------------------------------------------------------


def _build(**kw):
    return tplan.build_plan(TG, TCFG, TSPEC.feature_len, TSPEC.num_classes,
                            device="cpu", **kw)


def test_plan_validation_and_coercions():
    mesh = _mesh(4)
    with pytest.raises(ValueError, match="overlap"):
        _build(overlap="sometimes")
    with pytest.raises(ValueError, match="requires strategy='ring'"):
        _build(mesh=mesh, strategy="allgather", overlap="pipelined")
    with pytest.raises(ValueError, match="unknown strategy"):
        _build(mesh=mesh, strategy="tree")
    with pytest.raises(ValueError, match="num_shards"):
        _build(mesh=mesh, num_shards=8)
    with pytest.raises(ValueError, match="axes"):
        _build(mesh=mesh, axis="model")
    with pytest.raises(TypeError, match="LocalMesh"):
        _build(mesh=object())
    with pytest.raises(ValueError, match="single-matmul"):
        tplan.build_plan(TG, PAPER_MODELS["gin"], TSPEC.feature_len,
                         TSPEC.num_classes, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="one axis"):
        _build(mesh=tdist.LocalMesh((1, 1, 1), ("a", "b", "c"),
                                    device="cpu"))
    # a local plan has no collective to overlap; a mesh plan runs unfused
    # with dedup "none", as the reference's
    assert _build(overlap="pipelined").overlap == "none"
    p = _build(mesh=mesh, fused=True, dedup="pairs")
    assert all(not lp.fused for lp in p.layers) and p.dedup == "none"
    assert _build(mesh=mesh, num_shards=4).partition.num_shards == 4


def test_plan_cache_keys_on_the_mesh_and_schedule():
    tplan.clear_plan_cache()
    mesh = _mesh(4)
    kw = dict(mesh=mesh, strategy="ring")
    p_none, p_pipe = _build(overlap="none", **kw), \
        _build(overlap="pipelined", **kw)
    assert p_none is not p_pipe and _build(overlap="none", **kw) is p_none
    assert p_pipe.overlap == "pipelined" and \
        all(d["overlap"] == "pipelined" for d in p_pipe.describe())
    assert _build(overlap="auto", **kw).overlap in ("none", "pipelined")
    # another mesh of the same shape is another plan; the shards' layouts
    # are built once per graph and strategy and shared
    other = _build(mesh=_mesh(4), strategy="ring")
    assert other is not p_none
    assert other.shard_layouts is p_none.shard_layouts
    assert len(tplan._SHARD_CACHE) == 1
    assert tplan._mesh_key(mesh) == (id(mesh), ("data",), (4,))
    tplan.clear_plan_cache()
    assert not tplan._SHARD_CACHE


def test_distributed_plan_refusals():
    _, tm = _model()
    plan = tm.plan_for(TG, mesh=_mesh(2))
    # compile() works on a mesh plan (its graph-as-argument mode does not)
    fn = plan.compile()
    with torch.no_grad():
        assert torch.equal(fn(tm.tree(), TX), tm(TG, TX, plan=plan))
    with pytest.raises(ValueError, match="edge-derived shards"):
        plan.compile(dynamic=True)
    with pytest.raises(ValueError, match="edge-derived shards"):
        plan.run_model(tm.tree(), TX, graph=TG)
    # grad mode, parameters need one: the forward is differentiable, and
    # the logits' backward fills every parameter's gradient
    tm.zero_grad()
    logits = tm(TG, TX, plan=plan)
    assert logits.requires_grad
    logits.sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               and bool(p.grad.abs().sum() > 0) for p in tm.parameters())
    tm.zero_grad()
    with pytest.raises(ValueError, match="computes on"):
        tplan.build_plan(TG, TCFG, TSPEC.feature_len, TSPEC.num_classes,
                         device="cpu", mesh=tdist.LocalMesh(
                             (2,), ("data",), device="meta"))


def test_run_layer_takes_the_padded_layout():
    """run_layer on a distributed plan: padded layout in and out, equal to
    the whole forward's first layer."""
    _, tm = _model()
    plan = tm.plan_for(TG, mesh=_mesh((2, 2)), overlap="pipelined")
    params = tm.tree()
    with torch.no_grad():
        xp = plan._ingress(TX)
        assert xp.shape == (2 * plan.partition.block_size, 32)
        h0 = plan.run_layer(params["conv0"], xp, layer=0)
        h1 = plan.run_layer(params["conv1"], torch.relu(h0), layer=1)
        assert torch.equal(plan._egress(h1), tm(TG, TX, plan=plan))


# ---------------------------------------------------------------------------
# K1's bf16-in/f32-out entry (its plain version here) and the launcher
# ---------------------------------------------------------------------------


def test_k1_f32_output_of_bf16_rows():
    """``out_dtype=torch.float32`` over bf16 x: the f32 sums unrounded --
    the plain fold of the bf16 rows upcast; the C entry it names."""
    tp = tpart.partition_1d(TG, 2, edge_balanced=False)
    lay = tdist.shard_layouts(tp, "allgather")[0]
    xb = TX.to(torch.bfloat16)
    got = k1.seg_agg(xb, lay.src, lay.dstl, lay.mask, tile_m=lay.tile_m,
                     out_dtype=torch.float32)
    want = k1.seg_agg(xb.float(), lay.src, lay.dstl, lay.mask,
                      tile_m=lay.tile_m)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    rounded = k1.seg_agg(xb, lay.src, lay.dstl, lay.mask, tile_m=lay.tile_m)
    assert rounded.dtype == torch.bfloat16
    assert torch.equal(rounded, want.to(torch.bfloat16))
    assert k1._entry("seg_agg", torch.bfloat16, torch.float32) == \
        "seg_agg_bf16_f32"
    assert k1._entry("seg_agg", torch.float32, torch.float32) == \
        "seg_agg_f32"
    with pytest.raises(TypeError, match="f32 output"):
        k1._entry("seg_agg", torch.float32, torch.bfloat16)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import distributed_gcn
    distributed_gcn.main(["--device", "cpu", "--mesh", "4x2", "--vertices",
                          "128", "--features", "16", "--overlap",
                          "pipelined"])
    out = capsys.readouterr().out
    assert "2d partition" in out and "layer1" in out
    diff = float(out.rsplit("local plan: ", 1)[1].split()[0])
    assert diff < 1e-4
