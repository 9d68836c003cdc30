"""The paper's Table-4 pieces against the JAX package, and the two
launchers that use them (``examples/quickstart.py`` and
``examples/gcn_phase_ordering.py``), cut short on the CPU.

``reduction_ratios``: the counts (bytes and operations of both
orderings) exactly, the ratios within the f32 band (rtol 1e-6: both
divide the same integers).  ``GCNModel.layer_costs``: the reference's
dict for gcn, sage and gin.  ``apply_mlp`` on the reference's parameters,
carried across as numpy, within the f32 band (``tests/tolerance.py``).
``synthetic_mnist`` draws from a ``torch.Generator``, the reference from
``jax.random``: it is held by its shapes, dtypes and ranges.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA as JCORA
from repro.config import REDDIT as JREDDIT
from repro.config import reduced_graph as jreduced
from repro.core.scheduler import reduction_ratios as jratios
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.models import mlp as jmlp
from repro.models.gcn import make_paper_model as jmodel
from repro_torch import config as tconfig
from repro_torch.core.scheduler import reduction_ratios
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.launch import gcn_phase_ordering, quickstart
from repro_torch.models import mlp
from repro_torch.models.gcn import make_paper_model

torch.set_num_threads(2)

#: (graph, vertices, features, in -> out) of the seeded graphs the ratios
#: are held on
GRAPHS = [("cora", 512, 64, 64, 16), ("reddit", 1024, 602, 602, 128),
          ("reddit", 2048, 96, 96, 41)]


def _specs(name, v, f):
    jspec = jreduced({"cora": JCORA, "reddit": JREDDIT}[name], v, f)
    tspec = tconfig.reduced_graph(tconfig.GRAPHS[name], v, f)
    return jspec, tspec


def _costs_equal(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("name,v,f,din,dout", GRAPHS)
def test_reduction_ratios_match_reference(name, v, f, din, dout):
    jspec, tspec = _specs(name, v, f)
    want = jratios(jgraph(jspec), din, dout)
    got = reduction_ratios(tgraph(tspec, device="cpu"), din, dout)
    _costs_equal(got["combine_first"], want["combine_first"])
    _costs_equal(got["aggregate_first"], want["aggregate_first"])
    for k in ("data_access_reduction", "computation_reduction"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
    assert got["data_access_reduction"] > 1


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("layer", [0, 1])
def test_layer_costs_match_reference(name, layer):
    """``GCNModel.layer_costs(g, layer)`` is the reference's dict: the
    planned order, the aggregation's and combination's costs and the
    ordering's."""
    jspec, tspec = _specs("cora", 512, 64)
    want = jmodel(name, jspec).layer_costs(jgraph(jspec), layer)
    got = make_paper_model(name, tspec, device="cpu").layer_costs(
        tgraph(tspec, device="cpu"), layer)
    assert got.keys() == want.keys()
    assert got["order"] == want["order"]
    assert got["aggregation"] == want["aggregation"]
    assert got["combination"] == want["combination"]
    _costs_equal(got["ordering_cost"], want["ordering_cost"])


@pytest.mark.parametrize("din,dout,batch", [(784, 128, 64), (32, 8, 5)])
def test_apply_mlp_matches_reference(din, dout, batch):
    """``apply_mlp`` on the reference's ``init_mlp`` parameters and
    inputs, carried across as numpy: the f32 band."""
    params = jmlp.init_mlp(jax.random.PRNGKey(din), din, dout)
    params = {"b": params["b"] + 0.1, "w": params["w"]}
    x = np.random.default_rng(0).uniform(size=(batch, din)).astype(
        np.float32)
    want = np.asarray(jmlp.apply_mlp(params, x))
    got = mlp.apply_mlp({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()}, torch.from_numpy(x))
    assert_allclose_dtype(got.numpy(), want)
    assert (got >= 0).all() and (got > 0).any()


def test_init_mlp_shapes_and_scale():
    """``init_mlp``: the reference's shapes and dtypes, He-normal weights
    (std sqrt(2 / din) within 5 %), zero bias, the draw fixed by the
    generator."""
    p = mlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    q = mlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    ref = jmlp.init_mlp(jax.random.PRNGKey(0))
    for k in ("w", "b"):
        assert tuple(p[k].shape) == tuple(ref[k].shape)
        assert p[k].dtype == torch.float32 and torch.equal(p[k], q[k])
    std = float(p["w"].std())
    assert abs(std / (2.0 / mlp.MNIST_IN) ** 0.5 - 1) < 0.05
    assert not p["b"].any()


def test_synthetic_mnist_shapes_and_ranges():
    """``synthetic_mnist``: the reference's shapes, f32 pixels in [0, 1),
    labels in 0..9 (int64, PyTorch's index dtype), every class drawn."""
    x, y = mlp.synthetic_mnist(torch.Generator().manual_seed(0),
                               device="cpu")
    jx, jy = jmlp.synthetic_mnist(jax.random.PRNGKey(0))
    assert tuple(x.shape) == tuple(jx.shape) and tuple(y.shape) == \
        tuple(jy.shape)
    assert x.dtype == torch.float32 and y.dtype == torch.int64
    assert float(x.min()) >= 0 and float(x.max()) < 1
    assert set(y.tolist()) == set(range(10))
    x2, _ = mlp.synthetic_mnist(torch.Generator().manual_seed(0), 7,
                                device="cpu")
    assert x2.shape == (7, mlp.MNIST_IN)
    assert mlp.mlp_cost() == jmlp.mlp_cost()


def test_quickstart_cut_short(capsys):
    """The quickstart launcher with ``--device cpu --steps 3``: the first
    layer's costs and Table-4 ratio are the reference's on the same
    reduced Cora, the compiled forward equals the report's output, the
    loss is finite and falls, one trace for each signature."""
    out = quickstart.main(["--device", "cpu", "--steps", "3"])
    jspec = jreduced(JCORA, max_vertices=1024, max_feature=256)
    jg = jgraph(jspec)
    want = jmodel("gcn", jspec).layer_costs(jg)
    assert out["costs"]["order"] == want["order"]
    assert out["costs"]["aggregation"] == want["aggregation"]
    assert out["costs"]["combination"] == want["combination"]
    assert out["ratios"]["data_access_reduction"] == jratios(
        jg, jspec.feature_len, 128)["data_access_reduction"]
    assert out["compiled_equal"] and out["traces"] == 2
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    assert 0 <= out["accuracy"] <= 1
    text = capsys.readouterr().out
    assert "Workload report" in text and "final accuracy" in text


def test_gcn_phase_ordering_cut_short(capsys):
    """The phase-ordering launcher with ``--device cpu --vertices 1024
    --iters 1``: the reference's analytic counts and its planner's order,
    the four views printed, the fused plan within the f32 band of the
    unfused one."""
    out = gcn_phase_ordering.main(["--device", "cpu", "--vertices", "1024",
                                   "--iters", "1"])
    jspec = jreduced(JREDDIT, max_vertices=1024, max_feature=602)
    want = jratios(jgraph(jspec), 602, 128)
    _costs_equal(out["ratios"]["combine_first"], want["combine_first"])
    _costs_equal(out["ratios"]["aggregate_first"], want["aggregate_first"])
    assert out["decision"]["order"] == "combine_first"
    assert out["fused_err"] <= 1e-5 * max(1.0, out["unfused_scale"])
    assert min(out["combine_first_ms"], out["aggregate_first_ms"],
               out["fused_ms"]) > 0
    text = capsys.readouterr().out
    for view in ("1. analytic", "2. planner decision", "3. measured",
                 "4. fused"):
        assert view in text
