"""The port's phases, ordering model and fused layer against the JAX package.

Inputs are made once with numpy from a seed and fed to both packages; the
port runs its ``torch`` tier on the CPU, the reference its eager ``xla``
tier (and, for the blocked-layout glue, its Pallas tier in interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA, reduced_graph
from repro.core import dataflow as jflow
from repro.core import phases as jphases
from repro.core import scheduler as jsched
from repro.graph.datasets import make_features as jfeatures
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.kernels import ops as jops
from repro.profile.machine import H100 as JH100
from repro_torch import config as tconfig
from repro_torch.core import dataflow as tflow
from repro_torch.core import phases as tphases
from repro_torch.core import scheduler as tsched
from repro_torch.graph.datasets import make_features as tfeatures
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.kernels import ops as tops
from repro_torch.profile.machine import H100

torch.set_num_threads(2)

JSPEC = reduced_graph(CORA, 512, 64)
TSPEC = tconfig.reduced_graph(tconfig.CORA, 512, 64)
JG, TG = jgraph(JSPEC), tgraph(TSPEC, device="cpu")
JX, TX = jfeatures(JSPEC), tfeatures(TSPEC, device="cpu")
RNG = np.random.default_rng(11)
EDGE_W = RNG.random(JG.num_edges).astype(np.float32)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("include_self", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_matches_reference(op, include_self, weighted):
    w = EDGE_W if weighted else None
    want = jphases.aggregate(JG, JX, op=op, include_self=include_self,
                             edge_weight=None if w is None else jnp.asarray(w),
                             backend="xla")
    got = tphases.aggregate(TG, TX, op=op, include_self=include_self,
                            edge_weight=None if w is None
                            else torch.from_numpy(w), backend="torch")
    assert_allclose_dtype(got.numpy(), np.asarray(want))


def test_aggregate_edge_mask_matches_reference():
    mask = (RNG.random(JG.num_edges) < 0.7).astype(np.float32)
    for op in ("sum", "max"):
        want = jphases.aggregate(JG, JX, op=op, edge_mask=jnp.asarray(mask),
                                 edge_weight=jnp.asarray(EDGE_W))
        got = tphases.aggregate(TG, TX, op=op,
                                edge_mask=torch.from_numpy(mask),
                                edge_weight=torch.from_numpy(EDGE_W))
        assert_allclose_dtype(got.numpy(), np.asarray(want))


def test_aggregate_edge_chunking_is_exact(monkeypatch):
    """The torch tier gathers edge chunk by edge chunk; the chunk size does
    not change a bit of the result."""
    whole = tphases.aggregate(TG, TX, op="mean")
    monkeypatch.setattr(tphases, "EDGE_CHUNK_BYTES", 4 * 64 * 37)
    chunked = tphases.aggregate(TG, TX, op="mean")
    assert_allclose_dtype(chunked.numpy(), whole.numpy(), bitwise=True)


def test_combine_matches_reference():
    dims = (64, 32, 7)
    ws = [(RNG.standard_normal((a, b)).astype(np.float32) * 0.2,
           RNG.standard_normal(b).astype(np.float32))
          for a, b in zip(dims[:-1], dims[1:])]
    for act in ("relu", "gelu", "tanh", "none"):
        for final in (False, True):
            want = jphases.combine(JX, [(jnp.asarray(w), jnp.asarray(b))
                                        for w, b in ws], activation=act,
                                   final_activation=final)
            got = tphases.combine(TX, [(torch.from_numpy(w),
                                        torch.from_numpy(b)) for w, b in ws],
                                  activation=act, final_activation=final)
            assert_allclose_dtype(got.numpy(), np.asarray(want))


def test_costs_and_ordering_match_reference():
    for f in (7, 64, 602):
        assert tphases.aggregate_cost(TG, f) == jphases.aggregate_cost(JG, f)
    assert tphases.combine_cost(512, (64, 128, 7)) == \
        jphases.combine_cost(512, (64, 128, 7))
    for din, dout in ((64, 7), (7, 64), (64, 64)):
        for order in (tsched.COMBINE_FIRST, tsched.AGGREGATE_FIRST):
            t = tsched.ordering_cost(TG, din, dout, order)
            j = jsched.ordering_cost(JG, din, dout, order)
            assert vars(t) == vars(j)
            assert tsched.ordering_time(t, H100) == \
                jsched.ordering_time(j, JH100)
        for agg, n in (("mean", 1), ("sum", 2), ("max", 1)):
            for machine in (None, H100):
                assert tsched.choose_ordering(
                    TG, din, dout, agg, n, machine=machine) == \
                    jsched.choose_ordering(
                        JG, din, dout, agg, n,
                        machine=None if machine is None else JH100)
    assert tsched.swap_is_legal("mean", 1) and \
        not tsched.swap_is_legal("sum", 2)


@pytest.mark.parametrize("weighted", [False, True])
def test_seg_agg_planned_glue_matches_reference(weighted):
    """The blocked-layout glue (edge weights regrouped through ``eidx``) on
    the torch tier against the reference's Pallas-tier entry, interpreted."""
    w = EDGE_W if weighted else None
    want = jops.seg_agg_planned(jflow.block_graph(JG, 32), JX,
                                None if w is None else jnp.asarray(w),
                                tile_e=64, backend="pallas-tpu")
    got = tops.seg_agg_planned(tflow.block_graph(TG, 32), TX,
                               None if w is None else torch.from_numpy(w),
                               backend="torch")
    assert_allclose_dtype(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("agg_op", ["mean", "sum_self", "sum"])
def test_fused_gcn_layer_matches_reference(agg_op):
    """The fused layer's torch tier against the reference's ``lax.scan``
    (xla) tier; scale=10 as tests/test_kernels.py uses for fused products."""
    w = RNG.standard_normal((64, 16)).astype(np.float32) * 0.2
    b = RNG.standard_normal(16).astype(np.float32)
    want = jflow.fused_gcn_layer(jflow.block_graph(JG, 32), JX,
                                 jnp.asarray(w), jnp.asarray(b),
                                 agg_op=agg_op, in_deg=JG.in_deg,
                                 backend="xla")
    got = tflow.fused_gcn_layer(tflow.block_graph(TG, 32), TX,
                                torch.from_numpy(w), torch.from_numpy(b),
                                agg_op=agg_op, in_deg=TG.in_deg,
                                backend="torch")
    assert_allclose_dtype(got.numpy(), np.asarray(want), scale=10)


def test_unknown_tier_and_dedup_raise():
    with pytest.raises(ValueError):
        tphases.aggregate(TG, TX, backend="xla")
    with pytest.raises(TypeError):       # dedup takes a DedupLayout
        tphases.aggregate(TG, TX, dedup=object())
    with pytest.raises(ValueError):
        tphases.aggregate(TG, TX, op="median")
