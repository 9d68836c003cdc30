"""Characterization against the JAX package: ``plan.instrument()`` and its
``WorkloadReport``, the bench harness, the roofline half of
``core/characterize.py``, ``phase_ordered_layer``, ``layer_costs``, and
the paper's contrast cases (``models/mlp.py``, ``models/pagerank.py``).

The port's records must equal the reference's record by record on the
same plan -- layer, phase, order, fusion, feature length, FLOPs, bytes,
bound -- with the tier names mapped (``xla`` -> ``torch``, ``pallas-*``
-> ``cuda``), and its reports must validate against the shared golden
schema.  Wall times are the CPU's and are only checked to be positive.
"""

import copy
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA, reduced_graph
from repro.core import characterize as jchar
from repro.core.phases import phase_ordered_layer as jpol
from repro.core.plan import build_plan as jbuild_plan
from repro.graph.datasets import make_features as jfeatures
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.models import mlp as jmlp
from repro.models import pagerank as jpr
from repro.models.gcn import PAPER_MODELS as JMODELS
from repro.models.gcn import GCNModel as JGCNModel
from repro.profile import V100 as JV100
from repro.profile import bench as jbench
from repro.profile import instrument as jinst
from repro_torch import config as tconfig
from repro_torch.core import characterize as tchar
from repro_torch.core.phases import phase_ordered_layer as tpol
from repro_torch.graph.datasets import make_features as tfeatures
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.models import mlp as tmlp
from repro_torch.models import pagerank as tpr
from repro_torch.models.gcn import PAPER_MODELS, GCNModel, make_paper_model
from repro_torch.profile import (H100, V100, BenchSpec, WorkloadReportError,
                                 run_specs, timeit, validate_report_dict)
from repro_torch.profile import bench as tbench

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden" / "workload_report.schema.json"
JSPEC = reduced_graph(CORA, 512, 64)
TSPEC = tconfig.reduced_graph(tconfig.CORA, 512, 64)
JG, TG = jgraph(JSPEC), tgraph(TSPEC, device="cpu")
JX, TX = jfeatures(JSPEC), tfeatures(TSPEC, device="cpu")
TIER = {"torch": "xla", "cuda": "pallas-gpu"}
RECORD_KEYS = ("layer", "phase", "order", "fused", "feature_len", "flops",
               "bytes", "bound", "collective_bytes", "dtype", "quant_error",
               "dedup_pairs", "wire_collective_bytes")


def _models(name, seed=3):
    jm = JGCNModel(JMODELS[name], JSPEC.feature_len, JSPEC.num_classes)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GCNModel(PAPER_MODELS[name], TSPEC.feature_len, TSPEC.num_classes,
                  device="cpu")
    tm.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
    return params, tm


def _jplan(name, **kw):
    return jbuild_plan(JG, JMODELS[name], JSPEC.feature_len,
                       JSPEC.num_classes, backend="xla", machine="h100", **kw)


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_report_records_match_reference(name, fused):
    params, tm = _models(name)
    jrep = _jplan(name, fused=fused).instrument().run_model(params, JX)
    plan = tm.plan_for(TG, fused=fused)
    rep = plan.instrument().run_model(tm.tree(), TX).validate()
    assert rep.machine is H100
    assert len(rep.records) == len(jrep.records)
    for t, j in zip(rep.records, jrep.records):
        assert {k: getattr(t, k) for k in RECORD_KEYS} == \
            {k: getattr(j, k) for k in RECORD_KEYS}
        assert TIER[t.backend] == j.backend and t.backend == "torch"
        assert t.arithmetic_intensity == j.arithmetic_intensity
        assert t.wall_time_s > 0
    assert rep.mismatches(plan) == []
    assert_allclose_dtype(rep.output.numpy(), np.asarray(jrep.output))
    with torch.no_grad():
        assert torch.equal(rep.output, plan.run_model(tm.tree(), TX))


def test_report_json_schema_golden():
    golden = json.loads(GOLDEN.read_text())
    m = make_paper_model("gin", TSPEC, device="cpu", fused=True)
    for compiled in (False, True):
        d = json.loads(m.plan_for(TG).instrument().run_model(
            m.tree(), TX, compiled=compiled).to_json())
        assert d["schema"] == golden["schema"]
        assert d["version"] == golden["version"]
        assert sorted(d) == sorted(golden["top"]
                                   + (["compiled"] if compiled else []))
        assert sorted(d["machine"]) == golden["machine"]
        assert sorted(d["plan"]) == golden["plan"]
        assert sorted(d["totals"]) == golden["totals"]
        for rec in d["phases"]:
            assert sorted(rec) == golden["phase_record"]
        for lay in d["plan"]["layers"]:
            assert sorted(lay) == golden["layer"]
        assert validate_report_dict(d) == []


def _doctored(d):
    """Reports broken one rule at a time."""
    out = []
    for key, val in (("phase", "gather"), ("bound", "io"), ("dtype", "f16"),
                     ("flops", -1.0), ("quant_error", 0.5),
                     ("wire_collective_bytes", 8.0), ("dedup_pairs", 3),
                     ("fused", 1), ("layer", "0")):
        bad = copy.deepcopy(d)
        bad["phases"][0][key] = val       # a combine record
        out.append(bad)
    bad = copy.deepcopy(d)
    del bad["phases"][0]["bytes"]
    bad["totals"]["flops"] += 1.0
    out.append(bad)
    bad = copy.deepcopy(d)
    bad["phases"] = []
    bad["version"] = 2
    out.append(bad)
    bad = copy.deepcopy(d)
    bad["compiled"] = {"model_s": -1.0, "layers_s": ["x"]}
    bad["serving"] = {"requests": 3, "bucket_misses": -1, "retraces": 0,
                      "p50_ms": 3.0, "p95_ms": 2.0, "p99_ms": 4.0,
                      "throughput_rps": 1.0, "buckets": [{"num_seeds": 1}]}
    out.append(bad)
    bad = copy.deepcopy(d)
    bad["plan"]["layers"][0]["dedup"] = "pairs"
    for rec in bad["phases"]:
        rec["dtype"] = "bf16"
    out.append(bad)
    return out


def test_validate_report_dict_matches_reference():
    """The port's validator finds the same problems as the reference's on
    the same (doctored) report dicts."""
    m = make_paper_model("gcn", TSPEC, device="cpu")
    d = m.plan_for(TG, ordering="combine_first").instrument().run_model(
        m.tree(), TX).to_dict()
    assert d["phases"][0]["phase"] == "combine"
    assert jinst.validate_report_dict(d) == validate_report_dict(d) == []
    for bad in _doctored(d):
        problems = validate_report_dict(bad)
        assert problems and problems == jinst.validate_report_dict(bad)


def test_validate_raises_and_mismatches_see_drift():
    m = make_paper_model("gcn", TSPEC, device="cpu")
    plan = m.plan_for(TG, ordering="combine_first")
    rep = plan.instrument().run_model(m.tree(), TX, compiled=True)
    assert rep.mismatches(plan) == []

    class Liar:
        """The plan, describing other decisions than it ran."""

        def describe(self):
            rows = plan.describe()
            rows[0].update(order="aggregate_first", fused=True)
            rows[1].update(backend="cuda", compiled=False)
            return rows

    got = rep.mismatches(Liar())
    assert any("describe fused=True" in s for s in got)
    assert any("describe backend=cuda" in s for s in got)
    assert any("compiled=False" in s for s in got)
    assert any("describe order=aggregate_first" in s for s in got)
    rep.records[0] = rep.records[0].__class__(
        **{**rep.records[0].__dict__, "bound": "io"})
    with pytest.raises(WorkloadReportError, match="bad bound"):
        rep.validate()


@pytest.mark.parametrize("fused", [False, True])
def test_compiled_report_states_speedup_per_layer(fused):
    m = make_paper_model("gin", TSPEC, device="cpu", fused=fused)
    plan = m.plan_for(TG)
    rep = plan.instrument().run_model(m.tree(), TX, compiled=True).validate()
    ct = rep.compiled_times
    assert ct["model_s"] > 0 and len(ct["layers_s"]) == plan.num_layers
    sp = rep.compiled_speedup()
    assert len(sp["layers"]) == plan.num_layers and sp["model"] > 0
    md = rep.to_markdown()
    assert "Compiled (plan.compile)" in md and "layer 1:" in md
    assert "| layer | phase | order | backend |" in md
    assert plan.compile().num_traces == 1
    assert all(plan.compile(layer=i).num_traces == 1 for i in range(2))


def test_instrument_machine_and_other_entries():
    m = make_paper_model("gcn", TSPEC, device="cpu")
    plan = m.plan_for(TG)
    assert plan.instrument().machine is H100
    rep = plan.instrument(machine="v100", warmup=1).run_model(m.tree(), TX)
    assert rep.machine is V100
    for r in rep.records:
        assert r.bound == V100.classify(r.arithmetic_intensity)
    assert f"balance {V100.balance:.1f}" in rep.to_markdown()
    lrep = plan.instrument().run_layer(m.tree()["conv0"], TX, layer=0)
    assert [r.phase for r in lrep.records] == \
        [r.phase for r in rep.records if r.layer == 0]
    w = torch.zeros((TSPEC.feature_len, 8))
    prep = plan.instrument().run_phases(TX, [(w, None)], activation="none")
    assert prep.output.shape == (TSPEC.num_vertices, 8)
    assert {r.phase for r in prep.records} == {"aggregate", "combine"}


@pytest.mark.parametrize("name", ["gcn", "gin"])
@pytest.mark.parametrize("order", ["combine_first", "aggregate_first"])
def test_layer_costs_match_reference(name, order):
    jp = _jplan(name, ordering=order)
    tp = make_paper_model(name, TSPEC, device="cpu").plan_for(
        TG, ordering=order)
    for i in range(2):
        t, j = tp.layer_costs(i), jp.layer_costs(i)
        assert t["order"] == j["order"]
        assert t["aggregation"] == j["aggregation"]
        assert t["combination"] == j["combination"]
        assert dataclasses.asdict(t["ordering_cost"]) == \
            dataclasses.asdict(j["ordering_cost"])


@pytest.mark.parametrize("order", ["combine_first", "aggregate_first", None])
@pytest.mark.parametrize("agg_op", ["mean", "sum"])
def test_phase_ordered_layer_matches_reference(order, agg_op):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((JSPEC.feature_len, 16)).astype(np.float32) * .3
    b = rng.standard_normal(16).astype(np.float32) * .1
    want = jpol(JG, JX, [(jnp.asarray(w), jnp.asarray(b))], order=order,
                agg_op=agg_op)
    got = tpol(TG, TX, [(torch.from_numpy(w), torch.from_numpy(b))],
               order=order, agg_op=agg_op)
    assert_allclose_dtype(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tpol(TG, TX, [(torch.from_numpy(w), None)], order="sideways")


def _restricted(mine, theirs):
    """``theirs`` cut to the keys of ``mine``, recursively."""
    if isinstance(mine, dict):
        return {k: _restricted(v, theirs[k]) for k, v in mine.items()}
    return theirs


def test_roofline_and_phase_report_match_reference():
    for flops, byt, coll in ((197e12, 1e9, 0), (1e12, 819e9 * 10, 5e10)):
        jr = jchar.roofline(jchar.StepCost(flops=flops, hbm_bytes=byt,
                                           collective={"total": coll}),
                            chips=4, model_flops=3e12, machine=JV100)
        tr = tchar.roofline(tchar.StepCost(flops=flops, hbm_bytes=byt,
                                           collective={"total": coll}),
                            chips=4, model_flops=3e12, machine=V100)
        assert tr.row() == jr.row()
        assert (tr.dominant, tr.mfu) == (jr.dominant, jr.mfu)
    assert tchar.roofline(tchar.StepCost(1.0, 1.0), 1).machine is H100
    from repro.core.phases import aggregate_cost, combine_cost
    from repro_torch.core import phases as tphases
    jrep = jchar.phase_report(aggregate_cost(JG, 128),
                              combine_cost(JG.num_vertices, (602, 128)),
                              machine=JV100)
    trep = tchar.phase_report(tphases.aggregate_cost(TG, 128),
                              tphases.combine_cost(TG.num_vertices,
                                                   (602, 128)),
                              machine=V100)
    assert trep == _restricted(trep, jrep)
    assert trep["aggregation"]["bound"] == "memory"
    assert trep["combination"]["bound"] == "compute"


def test_mlp_and_pagerank_match_reference():
    assert tmlp.mlp_cost() == jmlp.mlp_cost()
    assert tmlp.mlp_cost(64, 100, 10) == jmlp.mlp_cost(64, 100, 10)
    assert tpr.pagerank_cost(TG, iters=3) == jpr.pagerank_cost(JG, iters=3)
    want = np.asarray(jpr.pagerank(JG, iters=25))
    got = tpr.pagerank(TG, iters=25)
    assert got.dtype == torch.float32 and got.shape == (TSPEC.num_vertices,)
    assert_allclose_dtype(got.numpy(), want)
    assert_allclose_dtype(tpr.pagerank_reference(TG, iters=25).numpy(),
                          np.asarray(jpr.pagerank_reference(JG, iters=25)))
    assert_allclose_dtype(got.numpy(),
                          tpr.pagerank_reference(TG, iters=25).numpy())
    assert abs(float(got.sum()) - 1.0) < 1e-4


def test_bench_rows_and_csv_match_reference(tmp_path):
    rows = [tbench.make_row("a", 12.3456, x=1, order="cf"),
            tbench.make_row("b", 7.0, y=2.5)]
    jrows = [jbench.make_row("a", 12.3456, x=1, order="cf"),
             jbench.make_row("b", 7.0, y=2.5)]
    assert rows == jrows
    assert [tbench.format_row(r) for r in rows] == \
        [jbench.format_row(r) for r in jrows]
    assert tbench.csv_columns(rows) == jbench.csv_columns(jrows)
    p = tbench.write_csv(rows, tmp_path / "t" / "rows.csv")
    q = jbench.write_csv(jrows, tmp_path / "j" / "rows.csv")
    assert p.read_text() == q.read_text()
    assert tbench.write_csv([], tmp_path / "none.csv") is None
    assert dataclasses.asdict(tbench.bench_graph("reddit", 4096)) == \
        dataclasses.asdict(jbench.bench_graph("reddit", 4096))


def test_run_specs_dry_run_and_timing(tmp_path, capsys):
    seen = []

    def measure(ctx, point):
        seen.append((point, ctx.g.num_vertices, ctx.x.shape[1]))
        plan = make_paper_model("gcn", ctx.spec, device="cpu").plan_for(ctx.g)
        us = ctx.time(lambda: plan.run_model(
            make_paper_model("gcn", ctx.spec, device="cpu").tree(), ctx.x))
        ctx.emit(f"gcn_{point}", us, vertices=ctx.g.num_vertices)

    run = BenchSpec("gcn_small", measure, graph="cora", max_vertices=300,
                    max_feature=32, sweep=(1, 2), dry="run",
                    dry_max_vertices=200, device="cpu")
    skip = BenchSpec("timing_only", measure, graph="cora", device="cpu")
    rows = run_specs([run, skip], dry=True, csv=tmp_path / "dry.csv")
    assert [r["us_per_call"] for r in rows] == [0.0, 0.0]
    assert seen == [(1, 200, 32), (2, 200, 32)]
    out = capsys.readouterr().out
    assert "# skipped: timing_only" in out and "gcn_1,0.0," in out
    assert (tmp_path / "dry.csv").read_text().startswith(
        "name,us_per_call,vertices")
    rows = run_specs([run])
    assert len(rows) == 2 and all(r["us_per_call"] > 0 for r in rows)
    assert timeit(lambda: torch.ones(4).sum(), warmup=1, iters=3) > 0
    with pytest.raises(ValueError):
        BenchSpec("bad", measure, dry="maybe")
