"""The planner's other decisions against the JAX package: execution dtype
(bf16, int8-agg), degree reordering and pair dedup, each priced for
``"auto"``.

Decision parity: the pricing functions, the host-side transforms
(``degree_reorder``, ``build_dedup_layout``, ``quantize_int8``) and the
``"auto"`` resolution of ``build_plan`` on every preset must equal the
reference's on the same inputs.  Forward parity: the port's torch tier
against the reference's eager XLA path on the same seeded graph, features
and weights, within the band of each plan's dtype
(``tests/tolerance.py``).  Port-internal contracts: a dedup f32 plan
equals the naive plan bit for bit, a reordered plan speaks the natural
vertex order, the plan cache keys on every decision, ``compile()`` equals
eager bit for bit, and ``instrument()`` reports what ran.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro import config as jconfig
from repro.core import phases as jphases
from repro.core.plan import build_plan as jbuild_plan
from repro.graph import dedup as jdedup
from repro.graph import reorder as jreorder
from repro.graph.datasets import make_features as jfeatures
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.models.gcn import PAPER_MODELS as JMODELS
from repro.models.gcn import GCNModel as JGCNModel
from repro.profile import machine as jmachine
from repro_torch import config as tconfig
from repro_torch.core import phases as tphases
from repro_torch.core import plan as tplan
from repro_torch.graph import dedup as tdedup
from repro_torch.graph import reorder as treorder
from repro_torch.graph.datasets import make_features as tfeatures
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.models.gcn import PAPER_MODELS, GCNModel, make_paper_model
from repro_torch.profile import machine as tmachine

torch.set_num_threads(2)

PRESETS = ["tpu-v5e", "a100", "h100", "v100"]
#: reduced Cora (V=512, E=1026; 23 leading pairs shared) and a denser
#: reduced Reddit (V=999, E=49822, 77 pairs: past choose_reorder's
#: 20,000-edge sample)
JSPEC = jconfig.reduced_graph(jconfig.CORA, 512, 64)
TSPEC = tconfig.reduced_graph(tconfig.CORA, 512, 64)
JSPEC_R = jconfig.reduced_graph(jconfig.REDDIT, 1000, 32)
TSPEC_R = tconfig.reduced_graph(tconfig.REDDIT, 1000, 32)
JG, TG = jgraph(JSPEC), tgraph(TSPEC, device="cpu")
JX, TX = jfeatures(JSPEC), tfeatures(TSPEC, device="cpu")
JG_R, TG_R = jgraph(JSPEC_R), tgraph(TSPEC_R, device="cpu")
HIDDEN = {"gcn": (32,), "sage": (32,), "gin": (32, 32)}
#: the forward cases: each decision on its own, then all three together
CASES = {"bf16": {"dtype": "bf16"}, "int8": {"dtype": "int8-agg"},
         "degree": {"reorder": "degree"}, "pairs": {"dedup": "pairs"},
         "all": {"dtype": "bf16", "reorder": "degree", "dedup": "pairs"}}


def _cfgs(name):
    return (dataclasses.replace(JMODELS[name], hidden_dims=HIDDEN[name]),
            dataclasses.replace(PAPER_MODELS[name], hidden_dims=HIDDEN[name]))


def _models(name, seed=3):
    """The reference's params and a port model loaded with them (2 layers,
    hidden 32)."""
    jcfg, tcfg = _cfgs(name)
    jm = JGCNModel(jcfg, JSPEC.feature_len, JSPEC.num_classes)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GCNModel(tcfg, TSPEC.feature_len, TSPEC.num_classes, device="cpu")
    tm.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
    return params, tm


def _jplan(name, g=JG, spec=JSPEC, **kw):
    return jbuild_plan(g, _cfgs(name)[0], spec.feature_len, spec.num_classes,
                       backend="xla", **{"machine": "h100", **kw})


def _band(kw):
    return kw.get("dtype", "f32")


# ---------------------------------------------------------------------------
# Decision parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_dtype_and_dedup_pricing_match_reference(preset):
    jm, tm = jmachine.get_machine(preset), tmachine.get_machine(preset)
    assert tmachine.DTYPE_BYTES == jmachine.DTYPE_BYTES
    assert tmachine.DTYPE_SAVING_THRESHOLD == jmachine.DTYPE_SAVING_THRESHOLD
    assert tmachine.DEDUP_SAVING_THRESHOLD == jmachine.DEDUP_SAVING_THRESHOLD
    for nbytes in (0, 1 << 10, 123457):
        assert tm.hop_time(nbytes) == jm.hop_time(nbytes)
    for v, e, f, fo, shards in [(256, 1024, 128, 128, 1), (232965, 11606919,
                                602, 128, 1), (2708, 5429, 1433, 7, 1),
                                (1000, 49821, 32, 41, 4), (96, 128, 8, 300,
                                                           2)]:
        dts = ("f32", "bf16", "int8-agg")
        assert tmachine.dtype_model(v, e, f, fo, machine=tm,
                                    num_shards=shards, dtypes=dts) == \
            jmachine.dtype_model(v, e, f, fo, machine=jm, num_shards=shards,
                                 dtypes=dts)
        assert tmachine.choose_dtype(v, e, f, fo, machine=tm,
                                     num_shards=shards) == \
            jmachine.choose_dtype(v, e, f, fo, machine=jm, num_shards=shards)
        for p, e2, dt in [(0, e, "f32"), (e // 50, e - e // 40, "bf16"),
                          (e // 8, e // 2, "f32"), (3, e - 3, "int8-agg")]:
            kw = dict(num_pairs=p, num_edges2=e2, dtype=dt)
            assert tmachine.dedup_model(v, e, f, machine=tm, **kw) == \
                jmachine.dedup_model(v, e, f, machine=jm, **kw)
            assert tmachine.choose_dedup(v, e, f, machine=tm, **kw) == \
                jmachine.choose_dedup(v, e, f, machine=jm, **kw)


def test_pricing_docstring_cases():
    """The reference's docstring cases: the dtype decision flips between
    presets on one workload, the dedup decision between workloads; and
    Reddit at 602 -> 128 on the H100 resolves to bf16."""
    assert tmachine.choose_dtype(256, 1024, 128, machine=tmachine.V100) \
        == "f32"
    assert tmachine.choose_dtype(256, 1024, 128, machine=tmachine.TPU_V5E) \
        == "bf16"
    assert tmachine.choose_dedup(96, 128, 128, num_pairs=8, num_edges2=80,
                                 machine=tmachine.TPU_V5E) == "pairs"
    assert tmachine.choose_dedup(96, 128, 128, num_pairs=2, num_edges2=126,
                                 machine=tmachine.TPU_V5E) == "none"
    assert tmachine.choose_dtype(232965, 11606919, 602, 128) == "bf16"


@pytest.mark.parametrize("which", ["cora", "reddit"])
def test_degree_reorder_matches_reference(which):
    jg, tg = (JG, TG) if which == "cora" else (JG_R, TG_R)
    jg2, jperm = jreorder.degree_reorder(jg)
    tg2, tperm = treorder.degree_reorder(tg)
    np.testing.assert_array_equal(tperm, jperm)
    for k in ("src", "dst", "in_deg", "out_deg", "row_ptr"):
        np.testing.assert_array_equal(getattr(tg2, k).numpy(),
                                      np.asarray(getattr(jg2, k)))
    assert tg2.device == tg.device
    x = np.arange(3 * tg.num_vertices, dtype=np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(treorder.apply_vertex_perm(x, tperm),
                                  jreorder.apply_vertex_perm(x, jperm))
    dst = np.asarray(jg.dst)
    for f in (1, 4, 64):
        assert treorder.atomic_collision_model(dst, f) == \
            jreorder.atomic_collision_model(dst, f)


@pytest.mark.parametrize("preset", PRESETS)
def test_reuse_distance_and_choose_reorder_match_reference(preset):
    """Both streams of choose_reorder: the whole stream (Cora, 1026
    edges) and the seeded 20,000-edge sample (Reddit, 49,822 edges), at
    the preset's rows and at a few narrow budgets where degree wins."""
    jm, tm = jmachine.get_machine(preset), tmachine.get_machine(preset)
    stream = np.asarray(JG_R.src)[:3000]
    budgets = (8, 64, 256)
    assert treorder.reuse_distance_stats(stream, budgets) == \
        jreorder.reuse_distance_stats(stream, budgets)
    for jg, tg in ((JG, TG), (JG_R, TG_R)):
        jg2, jperm = jreorder.degree_reorder(jg)
        tg2, tperm = treorder.degree_reorder(tg)
        for f in (1, 32, 602, 1 << 14):
            assert treorder.choose_reorder(tg, tg2, tperm, f, tm) == \
                jreorder.choose_reorder(jg, jg2, jperm, f, jm)


def test_build_dedup_layout_matches_reference():
    for jg, tg in ((JG, TG), (JG_R, TG_R)):
        j = jdedup.dedup_layout_for_graph(jg)
        t = tdedup.dedup_layout_for_graph(tg)
        assert t.num_pairs > 0
        for k in ("pair_left", "pair_right", "src2", "dst2"):
            assert getattr(t, k).dtype == torch.int32
            np.testing.assert_array_equal(getattr(t, k).numpy(),
                                          np.asarray(getattr(j, k)))
        for k in ("num_pairs", "num_edges2", "matched_edges", "naive_edges",
                  "num_vertices", "edges_removed"):
            assert getattr(t, k) == getattr(j, k)
        for f in (1, 32, 128):
            assert t.flops_saved(f) == j.flops_saved(f)
            for incl in (True, False):
                assert tdedup.dedup_cost(t, f, include_self=incl) == \
                    jdedup.dedup_cost(j, f, include_self=incl)
        tb, jb = tdedup.attach_blocked(t, 32).blocked, \
            jdedup.attach_blocked(j, 32).blocked
        for k in ("src", "dstl", "mask", "eidx"):
            np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                          np.asarray(getattr(jb, k)))
        assert int(tb.src.max()) >= tg.num_vertices   # gathers partials
        caps = (t.num_pairs + 5, t.num_edges2 + 9, tg.num_vertices - 1)
        for a, b in zip(tdedup.pad_dedup_arrays(t, *caps),
                        jdedup.pad_dedup_arrays(j, *caps)):
            np.testing.assert_array_equal(a, b)
    # no shared pair: an empty layout, the edge list unchanged
    src, dst = np.array([0, 1, 2, 3]), np.array([1, 1, 2, 2])
    t = tdedup.build_dedup_layout(src, dst, 4, device="cpu")
    j = jdedup.build_dedup_layout(src, dst, 4)
    assert t.num_pairs == j.num_pairs == 0
    np.testing.assert_array_equal(t.src2.numpy(), np.asarray(j.src2))


def test_quantize_int8_is_bitwise_the_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 37)).astype(np.float32)
    x[3] = 0.0                                   # a zero row: scale 1
    x[5] *= 1e-30                                # a tiny row
    x[7] = np.float32(0.5) * np.arange(37, dtype=np.float32)  # ties
    got = tphases.quantize_int8(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert_allclose_dtype(got.numpy(), np.asarray(jphases.quantize_int8(x)),
                          bitwise=True)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jphases.quantize_int8(np.asarray(xb.float().numpy()).astype(
        jax.numpy.bfloat16))
    assert_allclose_dtype(tphases.quantize_int8(xb).numpy(),
                          np.asarray(want), bitwise=True)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("name", ["gcn", "gin"])
def test_auto_decisions_match_reference(preset, name):
    """``build_plan`` with "auto" for all three decisions resolves as the
    reference does on the same machine; so do the explicit decisions, and
    the decisions the planner coerces (max aggregation has no dedup)."""
    for jg, tg, js, ts in ((JG, TG, JSPEC, TSPEC),
                           (JG_R, TG_R, JSPEC_R, TSPEC_R)):
        for fused in (False, True):
            kw = dict(reorder="auto", dtype="auto", dedup="auto",
                      fused=fused)
            jrows = _jplan(name, jg, js, machine=preset, **kw).describe()
            tp = tplan.build_plan(tg, _cfgs(name)[1], ts.feature_len,
                                  ts.num_classes, device="cpu",
                                  machine=preset, **kw)
            for t, j in zip(tp.describe(), jrows):
                for k in ("dtype", "reorder", "dedup", "order", "fused",
                          "tile_m", "din", "dout"):
                    assert t[k] == j[k], (k, t[k], j[k])
    maxcfg = dataclasses.replace(PAPER_MODELS["gcn"], aggregator="max")
    tp = tplan.build_plan(TG, maxcfg, TSPEC.feature_len, TSPEC.num_classes,
                          device="cpu", dedup="pairs")
    assert tp.dedup == "none" and tp.dedup_layout is None


# ---------------------------------------------------------------------------
# Forward parity
# ---------------------------------------------------------------------------


#: every decision alone, unfused and fused; the combination fused
FORWARD = [(n, f, c) for n in ("gcn", "sage", "gin") for f in (False, True)
           for c in CASES if f or c != "all"]


@pytest.mark.parametrize("name,fused,case", FORWARD)
def test_forward_matches_reference(name, fused, case):
    kw = CASES[case]
    params, tm = _models(name)
    jp = _jplan(name, fused=fused, **kw)
    tp = tm.plan_for(TG, fused=fused, **kw)
    d, jd = tp.describe(), jp.describe()
    for t, j in zip(d, jd):
        assert (t["dtype"], t["reorder"], t["dedup"], t["tile_m"]) == \
            (j["dtype"], j["reorder"], j["dedup"], j["tile_m"])
    if "dedup" in kw:
        assert tp.dedup == "pairs" and tp.dedup_layout.num_pairs > 0
    with torch.no_grad():
        got = tm(TG, TX, plan=tp)
    want = np.asarray(jp.run_model(params, JX))
    assert got.shape == want.shape and got.dtype == (
        torch.bfloat16 if kw.get("dtype") == "bf16" else torch.float32)
    assert_allclose_dtype(got.float().numpy(), want.astype(np.float32),
                          _band(kw))


# ---------------------------------------------------------------------------
# Port-internal contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_dedup_f32_plan_is_bitwise_the_naive_plan(name, fused):
    """The CPU's index_add_ folds each destination in edge order from 0,
    so (0 + (a + b)) + rest is the naive ((0 + a) + b) + rest."""
    _, tm = _models(name)
    x = tfeatures(TSPEC_R, device="cpu")
    tm2 = GCNModel(_cfgs(name)[1], TSPEC_R.feature_len, TSPEC_R.num_classes,
                   device="cpu", generator=torch.Generator().manual_seed(1))
    naive = tm2.plan_for(TG_R, fused=fused)
    ded = tm2.plan_for(TG_R, fused=fused, dedup="pairs")
    assert ded.dedup == "pairs" and ded.dedup_layout.num_pairs > 50
    with torch.no_grad():
        assert torch.equal(tm2(TG_R, x, plan=ded), tm2(TG_R, x, plan=naive))


def test_cuda_tier_dedup_without_blocking_goes_to_the_kernel():
    """A cuda-tier aggregation over a dedup layout with no blocking
    attached hands its level-2 sum to the seg_agg wrapper, which refuses
    CPU tensors, rather than running the torch tier's index_add_; the
    torch tier's two-level sum is the naive one bit for bit."""
    lay = tdedup.dedup_layout_for_graph(TG_R)
    assert lay.blocked is None and lay.num_pairs > 0
    x = tfeatures(TSPEC_R, device="cpu")
    with pytest.raises(ValueError, match="backend='cuda'"):
        tphases.aggregate(TG_R, x, op="sum", backend="cuda", dedup=lay)
    assert torch.equal(
        tphases.aggregate(TG_R, x, op="sum", backend="torch", dedup=lay),
        tphases.aggregate(TG_R, x, op="sum", backend="torch"))


def test_reordered_plan_speaks_the_natural_order():
    _, tm = _models("gcn")
    plain, re = tm.plan_for(TG), tm.plan_for(TG, reorder="degree")
    assert re.reorder == "degree" and re.g is not TG
    assert torch.equal(re.perm[re.inv], torch.arange(TG.num_vertices))
    with torch.no_grad():
        assert_allclose_dtype(tm(TG, TX, plan=re).numpy(),
                              tm(TG, TX, plan=plain).numpy())
        w = [(tm.conv0.lin.w.detach(), None)]
        assert_allclose_dtype(re.run_phases(TX, w).numpy(),
                              plain.run_phases(TX, w).numpy())
    with pytest.raises(ValueError, match="natural"):
        re.run_model(tm.tree(), TX[:-1])
    with pytest.raises(ValueError, match="edge_weight"):
        re.run_phases(TX, w, edge_weight=torch.ones(TG.num_edges))
    with pytest.raises(ValueError, match="reordered"):
        re.compile(dynamic=True)
    assert tplan.plan_cache_stats()["reorder_size"] >= 1


def test_plan_cache_keys_on_every_decision():
    tplan.clear_plan_cache()
    args = (PAPER_MODELS["gcn"], TSPEC.feature_len, TSPEC.num_classes)
    plans = {}
    for kw in ({}, {"dtype": "bf16"}, {"dtype": "int8-agg"},
               {"reorder": "degree"}, {"dedup": "pairs"},
               {"dtype": "auto", "reorder": "auto", "dedup": "auto"}):
        p = tplan.build_plan(TG, *args, device="cpu", **kw)
        assert tplan.build_plan(TG, *args, device="cpu", **kw) is p
        plans[tuple(sorted(kw.items()))] = p
    assert len({id(p) for p in plans.values()}) == len(plans)
    stats = tplan.plan_cache_stats()
    assert (stats["size"], stats["hits"]) == (len(plans), len(plans))
    assert stats["reorder_size"] == 1           # one renumbering, shared
    # the bucket form (dedup_pad=) is its own plan, its layout padded to
    # the capacities with sink no-ops
    padded = tplan.build_plan(TG, *args, device="cpu", dedup="pairs",
                              dedup_pad=(40, 1100))
    assert padded is not plans[(("dedup", "pairs"),)]
    assert tplan.build_plan(TG, *args, device="cpu", dedup="pairs",
                            dedup_pad=(40, 1100)) is padded
    lay = padded.dedup_layout
    assert (lay.num_pairs, lay.num_edges2) == (40, 1100)
    assert int(lay.dst2[-1]) == TG.num_vertices - 1
    with pytest.raises(ValueError, match="dedup_pad"):
        tplan.build_plan(TG, *args, device="cpu", dedup_pad=(40, 1100))
    tplan.clear_plan_cache()
    assert tplan.plan_cache_stats()["reorder_size"] == 0


def test_padded_dedup_plan_serves_runtime_dispatch_only(monkeypatch):
    """A plan built with dedup_pad= refuses a static forward and a static
    compile (its padded layout would add the sink edges' copies into the
    last row); given a graph and that graph's dedup layout it equals the
    unpadded plan.  On the cuda tier it keeps no level-2 blocking of its
    own: each dispatch brings one."""
    _, tm = _models("gcn")
    plain = tm.plan_for(TG, fused=False, dedup="pairs")
    padded = tm.plan_for(TG, fused=False, dedup="pairs",
                         dedup_pad=(40, 1100))
    assert padded.dedup_pad == (40, 1100) and plain.dedup_pad is None
    with pytest.raises(ValueError, match="dedup_pad"):
        padded.run_model(tm.tree(), TX)
    with pytest.raises(ValueError, match="dedup_pad"):
        padded.compile()
    with torch.no_grad():
        got = padded.run_model(tm.tree(), TX, graph=TG,
                               dedup_layout=plain.dedup_layout)
        assert torch.equal(got, plain.run_model(tm.tree(), TX))
    monkeypatch.setattr(tplan, "require_device", lambda backend, dev: None)
    on_cuda = {k: tm.plan_for(TG, fused=False, backend="cuda", dedup="pairs",
                              **kw)
               for k, kw in (("plain", {}), ("padded",
                                           {"dedup_pad": (40, 1100)}))}
    assert on_cuda["plain"].dedup_layout.blocked is not None
    assert on_cuda["padded"].dedup_layout.blocked is None


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fused", [False, True])
def test_compile_equals_eager_bitwise(case, fused):
    name = "gin" if fused else "gcn"
    _, tm = _models(name)
    plan = tm.plan_for(TG, fused=fused, **CASES[case])
    params = tm.tree()
    with torch.no_grad():
        want = plan.run_model(params, TX)
    fn = plan.compile()
    for _ in range(3):
        assert torch.equal(fn(params, TX), want)
    assert (fn.num_traces, fn.num_replays) == (1, 2)
    h = plan._ingress(TX)
    for i in range(plan.num_layers):
        sub = params[f"conv{i}"]
        with torch.no_grad():
            ref = plan.run_layer(sub, h, layer=i)
        assert torch.equal(plan.compile(layer=i)(sub, h), ref)
        h = torch.relu(ref)


def test_dynamic_compile_of_dedup_plan_raises():
    """A dynamic dedup plan raises without the block's dedup arrays, and
    with them equals the eager forward."""
    _, tm = _models("gcn")
    plan = tm.plan_for(TG, dedup="pairs")
    fn = plan.compile(dynamic=True)
    with pytest.raises(ValueError, match="dedup="):
        fn(tm.tree(), TX, TG)
    with torch.no_grad():
        want = plan.run_model(tm.tree(), TX)
        assert torch.equal(fn(tm.tree(), TX, TG, dedup=plan.dedup_layout),
                           want)
    with pytest.raises(ValueError, match="dedup_layout"):
        plan.run_model(tm.tree(), TX, graph=TG)
    # the graph's own layout, handed in, serves an eager dispatch
    with torch.no_grad():
        assert torch.equal(
            plan.run_model(tm.tree(), TX, graph=TG,
                           dedup_layout=plan.dedup_layout),
            plan.run_model(tm.tree(), TX))


@pytest.mark.parametrize("case", ["bf16", "int8", "pairs", "degree"])
@pytest.mark.parametrize("fused", [False, True])
def test_reports_match_reference(case, fused):
    """The records' dtype (f32 for an int8-agg combine), quantization
    error (> 0 exactly where the reference's is), dedup pairs and saved
    adds equal the reference's; bytes and FLOPs (the two-level layout's
    for dedup) within the f32 band; the report validates and describes
    what ran."""
    name = "gin"
    kw = CASES[case]
    params, tm = _models(name)
    jrep = _jplan(name, fused=fused, **kw).instrument().run_model(params, JX)
    plan = tm.plan_for(TG, fused=fused, **kw)
    rep = plan.instrument().run_model(tm.tree(), TX).validate()
    assert rep.mismatches(plan) == []
    assert rep.reorder_applied == jrep.reorder_applied == (case == "degree")
    assert len(rep.records) == len(jrep.records)
    for t, j in zip(rep.records, jrep.records):
        assert (t.phase, t.dtype, t.dedup_pairs) == \
            (j.phase, j.dtype, j.dedup_pairs)
        assert (t.quant_error > 0) == (j.quant_error > 0)
        assert_allclose_dtype([t.bytes, t.flops, t.dedup_flops_saved],
                              [j.bytes, j.flops, j.dedup_flops_saved])
    if case == "pairs":
        assert "Dedup:" in rep.to_markdown()
    if kw.get("dtype"):
        assert any(r.quant_error > 0 for r in rep.records)
    assert_allclose_dtype(rep.output.float().numpy(),
                          np.asarray(jrep.output).astype(np.float32),
                          _band(kw))
    # describe() that lies about the reorder is caught
    if case == "degree":
        rep.reorder_applied = False
        assert any("reorder" in m for m in rep.mismatches(plan))


def test_models_carry_the_decisions():
    """``plan_for`` passes the decisions through to ``build_plan``, as in
    the reference; ``make_paper_model`` takes config fields only."""
    m = make_paper_model("gcn", TSPEC, device="cpu", fused=True)
    plan = m.plan_for(TG, dtype="bf16", dedup="pairs")
    assert (plan.dtype, plan.dedup, plan.layers[0].fused) == \
        ("bf16", "pairs", True)
    assert m.plan_for(TG).dtype == "f32"
    with torch.no_grad():
        assert m(TG, TX, plan=plan).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        make_paper_model("gcn", TSPEC, device="cpu", dtype="bf16")
