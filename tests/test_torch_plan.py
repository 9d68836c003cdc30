"""The whole slice against the JAX package: planned decisions and logits.

The port's GCN / SAGE / GIN models, with the reference's weights carried
across by ``params_from_reference``, must give logits within the f32 band of
the reference's eager ``plan.run_model`` over every fused x ordering
combination, and ``describe()`` must resolve every decision the way the
reference does on the H100 preset (``torch`` <-> ``xla``, ``cuda`` <->
``pallas-gpu``).
"""

import jax
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA, reduced_graph
from repro.core.plan import build_plan as jbuild_plan
from repro.graph.datasets import make_features as jfeatures
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.models.gcn import PAPER_MODELS as JMODELS
from repro.models.gcn import GCNModel as JGCNModel
from repro_torch import config as tconfig
from repro_torch.core import plan as tplan
from repro_torch.core.gcn_layers import GCNConv, GINConv
from repro_torch.graph.datasets import make_features as tfeatures
from repro_torch.graph.datasets import make_labels as tlabels
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.models.gcn import PAPER_MODELS, GCNModel, make_paper_model
from repro_torch.profile.machine import H100

torch.set_num_threads(2)

JSPEC = reduced_graph(CORA, 512, 64)
TSPEC = tconfig.reduced_graph(tconfig.CORA, 512, 64)
JG, TG = jgraph(JSPEC), tgraph(TSPEC, device="cpu")
JX, TX = jfeatures(JSPEC), tfeatures(TSPEC, device="cpu")
ORDERS = ["combine_first", "aggregate_first", "auto"]
TIER = {"torch": "xla", "cuda": "pallas-gpu"}
DESCRIBE_KEYS = ("layer", "kind", "din", "dout", "order", "fused", "tile_m",
                 "dtype", "reorder", "dedup", "agg_bytes", "agg_flops")


def _models(name):
    jm = JGCNModel(JMODELS[name], JSPEC.feature_len, JSPEC.num_classes)
    params = jm.init(jax.random.PRNGKey(3))
    tm = GCNModel(PAPER_MODELS[name], TSPEC.feature_len, TSPEC.num_classes,
                  device="cpu")
    tm.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
    return params, tm


def _assert_rows_match(trows, jrows, tier):
    assert len(trows) == len(jrows)
    for t, j in zip(trows, jrows):
        assert {k: t[k] for k in DESCRIBE_KEYS} == \
            {k: j[k] for k in DESCRIBE_KEYS}
        assert TIER[t["backend"]] == j["backend"] and t["backend"] == tier


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("order", ORDERS)
def test_logits_and_decisions_match_reference(name, fused, order):
    params, tm = _models(name)
    jp = jbuild_plan(JG, JMODELS[name], JSPEC.feature_len,
                     JSPEC.num_classes, backend="xla", fused=fused,
                     ordering=order, machine="h100")
    tp = tm.plan_for(TG, fused=fused, ordering=order)
    _assert_rows_match(tp.describe(), jp.describe(), "torch")
    with torch.no_grad():
        got = tm(TG, TX, plan=tp)
    assert got.shape == (TSPEC.num_vertices, TSPEC.num_classes)
    assert_allclose_dtype(got.numpy(), np.asarray(jp.run_model(params, JX)))


@pytest.mark.parametrize("name", ["gcn", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_tier_decisions_match_reference(name, fused):
    """The cuda tier's layouts and tiles, planned over CPU tensors (planning
    launches nothing), against the reference's pallas-gpu tier."""
    cfg = PAPER_MODELS[name]
    jp = jbuild_plan(JG, JMODELS[name], JSPEC.feature_len,
                     JSPEC.num_classes, backend="pallas-gpu", fused=fused,
                     machine="h100")
    dims = [lp.dims for lp in jp.layers]
    layers = [tplan._plan_layer(TG, i, cfg.conv, d, agg_op=cfg.aggregator,
                                ordering=cfg.ordering, backend="cuda",
                                fused=fused) for i, d in enumerate(dims)]
    plan = tplan.GraphExecutionPlan(TG, layers, machine=H100)
    _assert_rows_match(plan.describe(), jp.describe(), "cuda")
    for tl, jl in zip(layers, jp.layers):
        np.testing.assert_array_equal(tl.agg_layout.src.numpy(),
                                      np.asarray(jl.agg_layout.src))
        assert tl.agg_layout.tile_m == jl.agg_layout.tile_m


def test_fused_and_unfused_agree_and_loss_is_finite():
    torch.manual_seed(0)
    outs = {}
    for fused in (False, True):
        m = make_paper_model("gin", TSPEC, device="cpu", fused=fused,
                             generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            outs[fused] = m(TG, TX)
        loss = m.loss_fn(TG, TX, tlabels(TSPEC, device="cpu"))
        loss.backward()          # the torch tier is differentiable
        assert torch.isfinite(loss) and m.conv0.mlp1.w.grad is not None
    assert_allclose_dtype(outs[True].numpy(), outs[False].numpy(), scale=10)


def test_parameter_names_follow_reference_pytree():
    m = make_paper_model("gin", TSPEC, device="cpu")
    assert [n for n, _ in m.named_parameters()] == [
        f"conv{i}.mlp{j}.{k}" for i in (0, 1) for j in (1, 2)
        for k in ("w", "b")]
    m = make_paper_model("gcn", TSPEC, device="cpu")
    assert [n for n, _ in m.named_parameters()] == [
        "conv0.lin.w", "conv0.lin.b", "conv1.lin.w", "conv1.lin.b"]
    with pytest.raises(ValueError):
        m.params_from_reference({"conv0": {"lin": {"w": np.zeros((64, 128)),
                                                   "b": np.zeros(128)}}})


def test_standalone_convs_match_model_layers():
    conv = GCNConv(TSPEC.feature_len, 16, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    gin = GINConv(TSPEC.feature_len, 16, device="cpu",
                  generator=torch.Generator().manual_seed(1))
    for c in (conv, gin):
        with torch.no_grad():
            out = c(TG, TX)
            plan = tplan.plan_for_conv(c, TG)
            assert_allclose_dtype(out.numpy(),
                                  plan.run_layer(c.tree(), TX).numpy(),
                                  bitwise=True)
    assert conv.resolve_order(TG) == "combine_first"
    w = torch.zeros((TSPEC.feature_len, 8))
    pp = tplan.plan_for_phases(TG, [(w, None)], agg_op="mean")
    assert pp.layers[0].order == "combine_first"
    assert pp.run_phases(TX, [(w, None)], activation="none").shape == \
        (TSPEC.num_vertices, 8)


def test_plan_cache_identity():
    tplan.clear_plan_cache()
    cfg = PAPER_MODELS["gcn"]
    args = (cfg, TSPEC.feature_len, TSPEC.num_classes)
    p1 = tplan.build_plan(TG, *args, device="cpu")
    assert tplan.build_plan(TG, *args, device="cpu") is p1
    twin = TG._replace(src=TG.src.clone())     # same sizes, other tensor
    assert tplan.build_plan(twin, *args, device="cpu") is not p1
    stats = tplan.plan_cache_stats()
    assert (stats["hits"], stats["misses"], stats["size"]) == (1, 2, 2)
    assert tplan.clear_plan_cache() == 2


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"reorder": "degree"},
                                {"dtype": "bf16"}, {"dedup": "pairs"}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        tplan.build_plan(TG, PAPER_MODELS["gcn"], TSPEC.feature_len,
                         TSPEC.num_classes, device="cpu", **kw)


def test_compile_raises():
    """compile() refuses what the reference refuses: a runtime graph for a
    fused plan (its blocked layout is of the plan's own graph), dynamic
    with layer=, and a runtime graph passed to a static callable."""
    args = (PAPER_MODELS["gcn"], TSPEC.feature_len, TSPEC.num_classes)
    fused = tplan.build_plan(TG, *args, device="cpu", fused=True)
    with pytest.raises(ValueError, match="blocked layout"):
        fused.compile(dynamic=True)
    plan = tplan.build_plan(TG, *args, device="cpu")
    with pytest.raises(ValueError, match="layer="):
        plan.compile(dynamic=True, layer=0)
    with pytest.raises(ValueError, match="static"):
        plan.compile()(make_paper_model("gcn", TSPEC, device="cpu").tree(),
                       TX, TG)
