"""The port's graph substrate and blocked layouts against the JAX package.

Same seed, same numpy generator: the port's ``Graph`` / ``BlockedGraph``
arrays must be array-equal to the reference's, on a reduced Cora and on full
Cora, and the fused tile size must agree on the H100 preset.
"""

import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CITESEER, CORA, PUBMED, REDDIT, reduced_graph
from repro.core.dataflow import block_graph as jblock_graph
from repro.core.dataflow import suggest_tile_m as jsuggest_tile_m
from repro.graph import datasets as jdata
from repro.graph import structure as jstruct
from repro.profile.machine import H100 as JH100
from repro_torch import config as tconfig
from repro_torch.core.dataflow import block_graph, suggest_tile_m
from repro_torch.graph import datasets as tdata
from repro_torch.graph import structure as tstruct
from repro_torch.profile.machine import H100, get_machine

torch.set_num_threads(2)

SPECS = {"cora_small": (reduced_graph(CORA, 512, 64),
                        tconfig.reduced_graph(tconfig.CORA, 512, 64)),
         "cora": (CORA, tconfig.CORA)}
GRAPH_FIELDS = ("src", "dst", "in_deg", "out_deg", "row_ptr")


def _graphs(name):
    jspec, tspec = SPECS[name]
    return (jdata.make_synthetic_graph(jspec),
            tdata.make_synthetic_graph(tspec, device="cpu"), jspec, tspec)


def _assert_graph_equal(jg, tg):
    assert tg.num_vertices == jg.num_vertices
    for f in GRAPH_FIELDS:
        t = getattr(tg, f)
        assert t.dtype == torch.int32, f
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jg, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", list(SPECS))
def test_synthetic_graph_and_features_equal_reference(name):
    jg, tg, jspec, tspec = _graphs(name)
    _assert_graph_equal(jg, tg)
    np.testing.assert_array_equal(
        tdata.make_features(tspec, device="cpu").numpy(),
        np.asarray(jdata.make_features(jspec)))
    np.testing.assert_array_equal(
        tdata.make_labels(tspec, device="cpu").numpy(),
        np.asarray(jdata.make_labels(jspec)))


def test_specs_equal_reference():
    for j, t in ((CORA, tconfig.CORA), (CITESEER, tconfig.CITESEER),
                 (PUBMED, tconfig.PUBMED), (REDDIT, tconfig.REDDIT)):
        assert tuple(vars(j).values()) == tuple(vars(t).values())
    j = reduced_graph(REDDIT, 1000, 32)
    t = tconfig.reduced_graph(tconfig.REDDIT, 1000, 32)
    assert tuple(vars(j).values()) == tuple(vars(t).values())


def test_graph_from_coo_and_helpers_equal_reference():
    rng = np.random.default_rng(3)
    v, e = 40, 150
    src, dst = rng.integers(0, v, e), rng.integers(0, v, e)
    jg = jstruct.graph_from_coo(src, dst, v)
    tg = tstruct.graph_from_coo(src, dst, v, device="cpu")
    _assert_graph_equal(jg, tg)
    _assert_graph_equal(jstruct.add_self_loops(jg),
                        tstruct.add_self_loops(tg))
    jp, tp = jstruct.pad_edges(jg, 200), tstruct.pad_edges(tg, 200)
    _assert_graph_equal(jp, tp)
    np.testing.assert_array_equal(
        tstruct.edge_mask(e, 200, device="cpu").numpy(),
        np.asarray(jstruct.edge_mask(e, 200)))
    np.testing.assert_array_equal(tstruct.to_dense_adj(tg).numpy(),
                                  np.asarray(jstruct.to_dense_adj(jg)))
    assert_allclose_dtype(tg.sym_norm_edge().numpy(),
                          np.asarray(jg.sym_norm_edge()))
    np.testing.assert_array_equal(tg.mean_norm().numpy(),
                                  np.asarray(jg.mean_norm()))


@pytest.mark.parametrize("name,tile_m", [("cora_small", 32), ("cora_small", 8),
                                         ("cora", 32), ("cora", 128)])
def test_blocked_graph_equals_reference(name, tile_m):
    jg, tg, _, _ = _graphs(name)
    jb, tb = jblock_graph(jg, tile_m), block_graph(tg, tile_m)
    assert (tb.tile_m, tb.num_vertices, tb.nblocks, tb.emax) == \
        (jb.tile_m, jb.num_vertices, jb.nblocks, jb.emax)
    for f in ("src", "dstl", "mask", "eidx"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.src.dtype == tb.dstl.dtype == tb.eidx.dtype == torch.int32


@pytest.mark.parametrize("spec", [CORA, CITESEER, PUBMED, REDDIT])
@pytest.mark.parametrize("dims", [(None, 128), (128, 16), (128, 128)])
def test_suggest_tile_m_equals_reference_on_h100(spec, dims):
    din = spec.feature_len if dims[0] is None else dims[0]
    avg_deg = spec.num_edges / spec.num_vertices
    assert suggest_tile_m(din, dims[1], avg_deg, machine=H100) == \
        jsuggest_tile_m(din, dims[1], avg_deg, machine=JH100)
    assert suggest_tile_m(din, dims[1], avg_deg) == \
        suggest_tile_m(din, dims[1], avg_deg, machine=H100)


def test_machine_presets_equal_reference():
    from repro.profile import machine as jm
    for name in jm.MACHINES:
        j, t = jm.get_machine(name), get_machine(name)
        for f in ("peak_flops", "hbm_bw", "on_chip_bytes", "target_ctas",
                  "row_align", "native_bf16", "kind"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.tile_budget() == j.tile_budget()
        assert t.balance == j.balance
        assert t.matmul_peak("f32") == j.matmul_peak("f32")
        assert t.classify(10.0) == j.classify(10.0)
    assert get_machine(None) is H100
