"""GCN node-prediction serving against the JAX package
(``serve/graph_engine.py``, ``core/plan.py::clear_plan_cache``).

Parity: the reference's ``GraphServeEngine`` and the port's (on the CPU)
over the same graph, features, seed and parameters (the reference's,
loaded through ``GCNModel.params_from_reference``) sample the same blocks
request by request -- the same bucket, frontier and edge count, exactly --
and the port's served seed logits agree with the reference's EAGER
``run_eager`` within the f32 band (1e-5, 1e-5).  The reference's own
compiled path is 1 ulp off its eager one on this tree
(``tests/test_serving.py::test_graph_padded_bit_identical_to_eager``), so
it is not the oracle.

The reference's graph-serving tests (``tests/test_serving.py:145-380``)
are ported against the port alone, each in the reference's terms; the
cuda tier's serving path -- runtime layouts at a bucket's fixed capacity
for the replay, fitted to the unpadded block for the oracle -- runs here
with the tier's device check lifted (``cuda_tier_on_cpu``), so each fold
takes K1's plain version.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA as JCORA
from repro.config import reduced_graph as jreduced
from repro.graph.datasets import make_features as jfeatures
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.models.gcn import PAPER_MODELS as JMODELS
from repro.serve import GraphServeEngine as JEngine
from repro.serve import default_buckets as jdefault_buckets
from repro_torch.config import CORA, reduced_graph
from repro_torch.core import plan as tplan
from repro_torch.core.scheduler import AGGREGATE_FIRST
from repro_torch.graph.datasets import make_synthetic_graph
from repro_torch.kernels import ops
from repro_torch.launch import serve_gcn
from repro_torch.models.gcn import PAPER_MODELS, GCNModel
from repro_torch.serve import (Bucket, GraphRequest, GraphServeEngine,
                               default_buckets)

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden" / "workload_report.schema.json"
SPEC = reduced_graph(CORA, max_vertices=220, max_feature=24)


@pytest.fixture(scope="module")
def graph_setup():
    """The reference test's graph (``reduced_graph(CORA, 220, 24)``) in
    both packages, and its features as numpy."""
    jspec = jreduced(JCORA, max_vertices=220, max_feature=24)
    jg = jgraph(jspec)
    tg = make_synthetic_graph(SPEC, device="cpu")
    assert np.array_equal(tg.src.numpy(), np.asarray(jg.src))
    return jg, tg, np.asarray(jfeatures(jspec))


def _engine(graph_setup, name="gcn", **kw):
    _, tg, x = graph_setup
    kw.setdefault("fanouts", (3, 3))
    kw.setdefault("max_batch", 4)
    kw.setdefault("device", "cpu")
    eng = GraphServeEngine(tg, PAPER_MODELS[name], None, x,
                           SPEC.num_classes, **kw)
    eng.params = eng.init_params(torch.Generator().manual_seed(0))
    return eng


def _seeds(rng, n, lo=1, hi=17):
    return rng.choice(SPEC.num_vertices, size=int(rng.integers(lo, hi)),
                      replace=False)


@pytest.fixture(scope="module")
def drained_engine(graph_setup):
    """The acceptance drain: 200 requests through the (4, 16) ladder."""
    eng = _engine(graph_setup, max_batch=8,
                  buckets=default_buckets((3, 3), seed_levels=(4, 16),
                                          max_inputs=SPEC.num_vertices))
    traces = eng.warmup()
    rng = np.random.default_rng(7)
    for i in range(200):
        eng.submit(GraphRequest(rid=i, seeds=_seeds(rng, 200)))
    done = eng.run()
    return eng, traces, done


@pytest.fixture
def cuda_tier_on_cpu(monkeypatch):
    """Plans may take the cuda tier over CPU tensors, whose folds then run
    K1's plain version."""
    def check(backend, x):
        assert backend in ("torch", "cuda")
    monkeypatch.setattr(ops, "_check_tier", check)
    monkeypatch.setattr(tplan, "require_device", lambda backend, dev: None)


# --------------------------------------------------------------------------
# Parity with the reference engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,buckets", [
    ("gcn", None), ("sage", None), ("gin", None),
    ("gcn", [(1, 2, 1)]),            # every request a miss: per-request plans
])
def test_engine_matches_reference(graph_setup, name, buckets):
    """A wave through the port's submit/run against the reference's
    prepare + eager ``run_eager`` in the same admission order: the same
    sampled blocks, and seed logits within the f32 band."""
    jg, tg, x = graph_setup
    je = JEngine(jg, JMODELS[name], None, x, SPEC.num_classes,
                 fanouts=(3, 3), buckets=buckets)
    je.params = je.init_params(jax.random.PRNGKey(0))
    eng = _engine(graph_setup, name, buckets=buckets)
    model = GCNModel(PAPER_MODELS[name], SPEC.feature_len, SPEC.num_classes,
                     device="cpu")
    eng.params = model.params_from_reference(
        jax.tree_util.tree_map(np.asarray, je.params)).tree()
    assert eng.buckets == tuple(tuple(b) for b in je.buckets)
    eng.warmup()
    rng = np.random.default_rng(5)
    reqs = [GraphRequest(rid=i, seeds=_seeds(rng, 10)) for i in range(10)]
    for r in reqs:
        eng.submit(r)
    done = {r.rid: r for r in eng.run()}
    for r in reqs:
        jp = je.prepare(r.seeds)
        got = done[r.rid]
        assert got.bucket == (None if jp.bucket is None else tuple(jp.bucket))
        assert (got.frontier_size, got.edge_count) == \
            (len(jp.frontier), jp.graph.num_edges)
        assert np.array_equal(got.prep.frontier, np.asarray(jp.frontier))
        assert got.logits.shape == (len(r.seeds), SPEC.num_classes)
        assert_allclose_dtype(got.logits, np.asarray(je.run_eager(jp)),
                              err_msg=f"request {r.rid}")
    assert eng.stats()["bucket_misses"] == (len(reqs) if buckets else 0)


@pytest.mark.parametrize("fanouts,levels,cap", [
    ((3, 3), (2, 4), None), ((5, 5), (4, 16, 64), None),
    ((25, 10), (4, 16, 64), 232965), ((3, 3), (4, 16), 220)])
def test_default_buckets_match_reference(fanouts, levels, cap):
    """The worst-case ladder equals the reference's, and each level's
    worst case fits its bucket by design."""
    got = default_buckets(fanouts, seed_levels=levels, max_inputs=cap)
    assert [tuple(b) for b in got] == [
        tuple(b) for b in jdefault_buckets(fanouts, seed_levels=levels,
                                           max_inputs=cap)]
    f1, f2 = fanouts
    for s, b in zip(sorted(levels), got):
        frontier = s * (1 + f1) * (1 + f2)
        if cap is None or frontier < cap:
            assert b.fits(s, frontier, s * f1 + s * (1 + f1) * f2)


# --------------------------------------------------------------------------
# The reference's graph-serving tests, against the port
# --------------------------------------------------------------------------


def test_bucket_fits_rule():
    b = Bucket(num_seeds=4, num_inputs=10, num_edges=20)
    assert b.fits(4, 10, 20)          # exact fit: no pad edges needed
    assert b.fits(4, 9, 19)           # pad edges -> last row is the sink
    assert not b.fits(4, 10, 19)      # pad edges but no free sink row
    assert not b.fits(5, 9, 19)       # too many seeds
    assert not b.fits(4, 9, 21)       # too many edges


def test_select_bucket_smallest_fitting(graph_setup):
    eng = _engine(graph_setup,
                  buckets=[(8, 80, 160), (2, 20, 30), (4, 40, 80)])
    assert eng.select_bucket(1, 10, 10) == Bucket(2, 20, 30)
    # full frontier with pad edges pending: the sink row rule kicks in
    assert eng.select_bucket(2, 20, 29) == Bucket(4, 40, 80)
    assert eng.select_bucket(3, 10, 10) == Bucket(4, 40, 80)
    assert eng.select_bucket(8, 80, 160) == Bucket(8, 80, 160)
    assert eng.select_bucket(9, 10, 10) is None


@pytest.mark.parametrize("tier", ["torch", "cuda"])
@pytest.mark.parametrize("name", ["gcn", "gin"])
def test_padded_matches_eager(graph_setup, request, tier, name):
    """The served (padded, compiled) logits against the eager oracles.

    Bit for bit the bucket plan's eager forward over the same padded
    block: the capture records exactly that forward.  Against the eager
    forward over the UNPADDED block (the reference's oracle) the
    aggregation is the same fold of the same real edges in the same order
    -- pad edges touch only the sink row and stay out of the cuda tier's
    layout -- but the combination multiplies matrices of other row counts,
    which a BLAS may split differently.  On the CPU the results are bit
    for bit all the same (measured here, every case); on a card the
    contract is the f32 band (PERF.md §6), which is also held here.
    On the cuda tier the replay's layout has the bucket's fixed capacity
    and the oracle's is fitted to the block: the slots hold the same edges
    in the same order."""
    if tier == "cuda":
        request.getfixturevalue("cuda_tier_on_cpu")
    eng = _engine(graph_setup, name, backend=tier)
    assert eng.donate is True                       # the default
    eng.warmup()
    assert all(fn.donate for fn in eng._fns.values())
    rng = np.random.default_rng(3)
    for s in (1, 4, 13, 2, 9, 4):                   # sustained bucket reuse
        prep = eng.prepare(rng.choice(SPEC.num_vertices, size=s,
                                      replace=False))
        assert prep.bucket is not None
        plan, _ = eng._bucket_plan(prep.bucket)
        if tier == "cuda":
            _, _, lay = eng._pad_into(prep, prep.bucket)
            assert lay.emax == -(-plan.agg_tile * 6 // 8) * 8
        served = eng.run_prepared(prep)
        assert served.shape == (s, SPEC.num_classes)
        assert np.array_equal(served, eng.run_eager(prep, padded=True))
        unpadded = eng.run_eager(prep)
        assert_allclose_dtype(served, unpadded)
        assert np.array_equal(served, unpadded)
    assert eng.retraces() == 0                      # one trace per bucket


def test_cuda_tier_serving_matches_torch_tier(graph_setup, cuda_tier_on_cpu):
    """The cuda tier's bucket plans (runtime layouts, K1's plain version)
    serve what the torch tier serves, within the f32 band, with one trace
    per bucket over a drain."""
    out = {}
    for tier in ("torch", "cuda"):
        eng = _engine(graph_setup, backend=tier, max_batch=3)
        assert (eng._bucket_plan(eng.buckets[0])[0].agg_tile > 0) == \
            (tier == "cuda")
        eng.warmup()
        rng = np.random.default_rng(11)
        for i in range(12):
            eng.submit(GraphRequest(rid=i, seeds=_seeds(rng, 12, hi=40)))
        out[tier] = {r.rid: r.logits for r in eng.run()}
        assert eng.retraces() == 0 and eng.stats()["bucket_misses"] == 0
    for rid, logits in out["torch"].items():
        assert_allclose_dtype(out["cuda"][rid], logits)


def test_graph_slot_reuse(graph_setup):
    eng = _engine(graph_setup, max_batch=2)
    eng.warmup()
    for i in range(7):
        eng.submit(GraphRequest(rid=i, seeds=np.array([i, i + 1], np.int32)))
    done = eng.run()
    assert {r.rid for r in done} == set(range(7))
    s = eng.stats()
    assert s["served"] == 7 and s["queued"] == 0 and s["active"] == 0
    # 2 slots served 7 requests: every request got a slot, steps batched
    assert s["slot_assignments"] == 7
    assert s["steps"] < s["served"]
    for r in done:
        assert r.logits.shape == (2, SPEC.num_classes)
        assert np.isfinite(r.logits).all()


def test_graph_warmup_once_and_zero_retraces(drained_engine):
    eng, traces, done = drained_engine
    assert len(eng.buckets) <= 4
    assert traces == {eng._bucket_name(b): 1 for b in eng.buckets}
    assert eng.warmup() == traces          # idempotent: no second trace
    s = eng.stats()
    assert s["served"] == len(done) == 200
    assert s["retraces"] == 0 and s["bucket_misses"] == 0
    assert s["bucket_hits"] == 200
    assert all(b["compiled"] == 1 for b in s["buckets"])
    assert sorted(s["host_ms"]) == sorted(
        ("sample", "union", "pad", "layouts", "gather", "replay"))
    assert all(v >= 0 for v in s["host_ms"].values())


#: the stats a warm-up leaves as a fresh engine has them
_FRESH_STATS = ("steps", "served", "active", "queued", "slot_assignments",
                "p50_ms", "p95_ms", "p99_ms", "throughput_rps",
                "bucket_hits", "bucket_misses", "retraces", "host_ms")


@pytest.mark.parametrize("tier", ["torch", "cuda"])
def test_warmup_drives_the_request_path_uncounted(graph_setup, request,
                                                  tier):
    """``warmup()`` runs one template request per bucket through the path a
    request takes (prepare, padding with the capacity layout, the gather,
    the replay, the seed rows), drawing from an RNG of its own: the
    engine's RNG state, its stats and ``retraces()`` stay as a fresh
    engine's, one trace per bucket.  (``test_engine_matches_reference``
    holds the frontiers served after a warm-up to the reference's.)"""
    if tier == "cuda":
        request.getfixturevalue("cuda_tier_on_cpu")
    fresh = _engine(graph_setup, backend=tier)
    eng = _engine(graph_setup, backend=tier)
    seen = {"prepare": 0, "pad": 0, "seed_rows": 0}

    def spy(name, fn):
        def wrapped(*args, **kw):
            seen[name] += 1
            return fn(*args, **kw)
        return wrapped
    eng.prepare = spy("prepare", eng.prepare)
    eng._pad_into = spy("pad", eng._pad_into)
    eng._seed_rows = spy("seed_rows", eng._seed_rows)
    traces = eng.warmup()
    n = len(eng.buckets)
    assert seen == {"prepare": n, "pad": n, "seed_rows": n}
    assert traces == {eng._bucket_name(b): 1 for b in eng.buckets}
    assert eng.rng.bit_generator.state == fresh.rng.bit_generator.state
    got, want = eng.stats(), fresh.stats()
    assert {k: got[k] for k in _FRESH_STATS} == \
        {k: want[k] for k in _FRESH_STATS}
    assert eng.stage_ms == {} and eng.latencies_s == [] and \
        eng.retraces() == 0
    assert eng.warmup() == traces and seen["prepare"] == n   # once only


def test_graph_latency_percentiles_monotone(drained_engine):
    eng, _, _ = drained_engine
    s = eng.stats()
    assert 0 < s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    assert s["throughput_rps"] > 0


def test_graph_bucket_miss_eager_path_and_cache_sweep(graph_setup):
    # one bucket too small for any 2-seed request: every request misses,
    # is served eagerly, and the transient plans trip the watermark sweep
    eng = _engine(graph_setup, buckets=[(1, 2, 1)], max_batch=2,
                  plan_cache_watermark=2)
    eng.warmup()
    kept = dict(eng._plans)
    for i in range(6):
        eng.submit(GraphRequest(rid=i,
                                seeds=np.array([i, i + 1], np.int32)))
    done = eng.run()
    s = eng.stats()
    assert s["bucket_misses"] == 6 and s["bucket_hits"] == 0
    assert all(r.bucket is None for r in done)
    for r in done:
        assert r.logits.shape == (2, SPEC.num_classes)
    assert s["cache_sweeps"] >= 2          # warmup pin + watermark sweeps
    assert s["plan_cache"]["size"] <= 1 + 2 * eng.max_batch
    assert s["plan_cache"]["evictions"] >= 1
    # the sweep never drops a bucket plan: it is still the cached one
    b = eng.buckets[0]
    assert eng._plans == kept and eng._bucket_plan(b)[0] is kept[b]
    assert tplan.build_plan(kept[b].g, PAPER_MODELS["gcn"], SPEC.feature_len,
                            SPEC.num_classes, fused=False,
                            device="cpu") is kept[b]


def test_plan_cache_stats_and_eviction(graph_setup):
    _, g, _ = graph_setup
    args = (g, PAPER_MODELS["gcn"], SPEC.feature_len, SPEC.num_classes)
    tplan.clear_plan_cache()
    assert tplan.plan_cache_stats() == {
        "size": 0, "limit": 64, "blocked_size": 0, "reorder_size": 0,
        "hits": 0, "misses": 0, "evictions": 0}
    p1 = tplan.build_plan(*args, fused=False, device="cpu")
    assert tplan.plan_cache_stats()["misses"] == 1
    assert tplan.build_plan(*args, fused=False, device="cpu") is p1
    assert tplan.plan_cache_stats()["hits"] == 1
    tplan.build_plan(*args, fused=False, ordering=AGGREGATE_FIRST,
                     device="cpu")
    assert tplan.plan_cache_stats()["size"] == 2
    tplan.clear_plan_cache(keep=[p1])      # explicit eviction policy
    s = tplan.plan_cache_stats()
    assert s["size"] == 1 and s["evictions"] >= 1
    assert tplan.build_plan(*args, fused=False, device="cpu") is p1
    tplan.clear_plan_cache()               # full wipe resets the counters
    assert tplan.plan_cache_stats()["size"] == 0
    assert tplan.plan_cache_stats()["hits"] == 0


@pytest.mark.parametrize("keep_reordered", [False, True])
def test_plan_cache_eviction_accounting(graph_setup, keep_reordered):
    """``clear_plan_cache(keep=...)`` counts every dropped cache line --
    plan entries plus the blocked and reorder layouts swept with them --
    and the hit and miss counters survive the sweep.  A kept reordered
    plan keeps its graph's reorder line and its renumbered graph's
    blocked layout."""
    _, g, _ = graph_setup
    cfg, f, c = PAPER_MODELS["gcn"], SPEC.feature_len, SPEC.num_classes
    tplan.clear_plan_cache()
    p_keep = tplan.build_plan(g, cfg, f, c, fused=False, device="cpu")
    # a second graph seeds blocked (fused) and reorder (degree) cache
    # lines -- all swept together with its plan entries
    g2 = make_synthetic_graph(dataclasses.replace(SPEC, seed=SPEC.seed + 1),
                              device="cpu")
    p_fused = tplan.build_plan(g2, cfg, f, c, fused=True, device="cpu")
    p_reord = tplan.build_plan(g2, cfg, f, c, fused=True, reorder="degree",
                               device="cpu")
    keep = [p_keep] + ([p_reord] if keep_reordered else [])
    s0 = tplan.plan_cache_stats()
    assert s0["blocked_size"] >= 2 and s0["reorder_size"] >= 1
    dropped = tplan.clear_plan_cache(keep=keep)
    s1 = tplan.plan_cache_stats()
    assert dropped == s0["size"] - len(keep)
    # every dropped line counted, plan entries AND swept layouts
    assert s1["evictions"] == dropped + \
        (s0["blocked_size"] - s1["blocked_size"]) + \
        (s0["reorder_size"] - s1["reorder_size"])
    assert s1["size"] == len(keep)
    if keep_reordered:
        # p_reord is cached under g2 and runs over g2's renumbered twin:
        # the lines of both graphs stay (g2's blocked layout, the twin's,
        # g2's reorder line)
        assert (s1["blocked_size"], s1["reorder_size"]) == (2, 1)
        assert tplan.build_plan(g2, cfg, f, c, fused=True, reorder="degree",
                                device="cpu") is p_reord
    else:
        assert s1["blocked_size"] == 0 and s1["reorder_size"] == 0
    assert tplan.build_plan(g2, cfg, f, c, fused=True,
                            device="cpu") is not p_fused
    # hit/miss counters accumulate ACROSS the sweep: the kept plan is
    # still a cache hit afterwards
    assert (s1["hits"], s1["misses"]) == (s0["hits"], s0["misses"])
    assert tplan.build_plan(g, cfg, f, c, fused=False,
                            device="cpu") is p_keep
    assert tplan.plan_cache_stats()["hits"] == s0["hits"] + \
        (2 if keep_reordered else 1)
    tplan.clear_plan_cache()


def test_graph_workload_report_golden_schema(drained_engine):
    eng, _, _ = drained_engine
    report = eng.workload_report()         # .validate() runs inside
    d = json.loads(report.to_json())
    golden = json.loads(GOLDEN.read_text())
    assert sorted(d) == golden["top_serving"]
    assert sorted(d["serving"]) == golden["serving"]
    for b in d["serving"]["buckets"]:
        assert sorted(b) == golden["serving_bucket"]
    assert d["serving"]["requests"] == 200
    assert d["serving"]["bucket_misses"] == 0
    assert d["serving"]["retraces"] == 0
    assert "Serving: 200 requests" in report.to_markdown()


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------


def test_launcher_serves_on_cpu(capsys):
    serve_gcn.main(["--device", "cpu", "--requests", "12", "--vertices",
                    "256", "--report"])
    out = capsys.readouterr().out
    assert "served 12 requests" in out and "misses=0 retraces=0" in out
    assert "Serving: 12 requests" in out


def test_launcher_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        serve_gcn.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cuda'"):
        GraphServeEngine(make_synthetic_graph(SPEC, device="cpu"),
                         PAPER_MODELS["gcn"], None,
                         np.zeros((SPEC.num_vertices, 4), np.float32), 7)
