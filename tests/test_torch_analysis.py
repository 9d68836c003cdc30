"""repro_torch.analysis: static contract verification of the port's plans
and source, against the reference's ``repro.analysis`` where the two meet.

Every rule catches its seeded plant and the port's rule ids are the
reference's; the shipped ``src/repro_torch`` tree and the CPU plan matrix
are clean under ``--strict`` (the cuda tier's plans linted over CPU
tensors with the tier's device check lifted, K1 and K2 opaque nodes);
suppression pragmas work; the dynamic and dedup rules see what they
price; ``plan_expected_collectives`` equals the reference's arithmetic
and the mesh's counted bytes across a trace; K1's and K2's fake
implementations give their plain versions' shapes and dtypes; no trace
moves a launch counter; ``kernels.ops.seg_agg`` refuses a trace with the
remediation text the ``host-in-trace`` finding carries.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import jaxpr_lint as jlint
from repro.analysis.selftest import PLANTS as REF_PLANTS
from repro.config import CORA as JCORA
from repro.config import reduced_graph as jreduced
from repro.graph import partition as jpart
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro_torch import analysis
from repro_torch.analysis import ast_lint, trace_lint as tl
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.report import AnalysisReport, Finding
from repro_torch.analysis.selftest import PLANTS, check_suppression
from repro_torch.config import CORA, reduced_graph
from repro_torch.core import plan as tplan
from repro_torch.core.dataflow import block_graph_arrays, transposed_layout
from repro_torch.core.distributed import LocalMesh
from repro_torch.core.plan import CompiledPlan, build_plan
from repro_torch.graph.datasets import make_synthetic_graph
from repro_torch.kernels import fused_agg_combine as k2
from repro_torch.kernels import ops
from repro_torch.kernels import seg_agg as k1
from repro_torch.models.gcn import PAPER_MODELS

torch.set_num_threads(2)

ALL_RULES = sorted(PLANTS)
SPEC = reduced_graph(CORA, 64, 16)
CFG = dataclasses.replace(PAPER_MODELS["gcn"], hidden_dims=(8,))


@pytest.fixture
def cuda_tier_on_cpu(monkeypatch):
    """Plans may take the cuda tier over CPU tensors: their folds go
    through K1's and K2's ops, whose real bodies run the plain versions
    on the CPU and whose fake implementations serve a trace."""
    def check(backend, x):
        assert backend in ("torch", "cuda")
    monkeypatch.setattr(ops, "_check_tier", check)
    monkeypatch.setattr(tplan, "require_device", lambda backend, dev: None)


# ---------------------------------------------------------------------------
# Report core and the rule registry
# ---------------------------------------------------------------------------


def test_report_core_roundtrip():
    r = AnalysisReport()
    r.add("no-f64", "error", "plan[x]", "boom", "evidence")
    r.add("tracer-branch", "warning", "f.py:3", "maybe")
    assert not r.ok(strict=True)
    assert r.counts() == {"error": 1, "warning": 1, "info": 0}
    assert "no-f64" in r.to_json() and "boom" in r.to_markdown()
    r2 = AnalysisReport([Finding("tracer-branch", "warning", "f.py:3", "m")])
    assert r2.ok(strict=True) and not r2.ok(strict=False)
    with pytest.raises(ValueError):
        r.add("x", "fatal", "y", "z")


@pytest.mark.parametrize("rule", ALL_RULES)
def test_rule_detects_its_plant(rule):
    report = PLANTS[rule]()
    assert any(f.rule == rule for f in report.findings), \
        f"rule {rule} missed its seeded violation:\n{report.render()}"


def test_rule_registry_covers_both_front_ends():
    assert {"no-callbacks", "no-f64", "bf16-f32-accum", "donation",
            "collective-bytes", "dynamic-edge-free",
            "dedup-accounting"} <= set(ALL_RULES)
    assert {"host-in-trace", "tracer-branch", "broadcast-div",
            "acc-dtype", "grid-arity"} <= set(ALL_RULES)


def test_rule_ids_are_the_reference_s():
    """The same ids; the two whose port reads CUDA sources instead of
    Pallas calls are documented as counterparts."""
    assert set(ALL_RULES) == set(REF_PLANTS)
    assert set(analysis.CUDA_COUNTERPARTS) <= set(ALL_RULES)
    for rule in analysis.CUDA_COUNTERPARTS:
        assert f"``{rule}``" in analysis.__doc__


def test_suppression_pragmas():
    assert check_suppression()
    src = ("# analysis: allow-file(broadcast-div)\n"
           "def f(h, deg):\n"
           "    return h / deg[:, None]\n")
    assert not ast_lint.lint_source(src).findings
    # an unrelated rule id does NOT suppress
    src = ("def f(h, deg):\n"
           "    return h / deg[:, None]  # analysis: allow(acc-dtype)\n")
    assert ast_lint.lint_source(src).findings
    # a pragma covers its line and the next, no further
    src = ("def f(x):\n"
           "    y = torch.sum(x)  # analysis: allow(host-in-trace)\n"
           "    a = y.item()\n"
           "    b = y.item()\n")
    hits = ast_lint.lint_source(src).findings
    assert [f.where for f in hits] == ["<string>:4"]


def test_source_rules_spare_numpy_and_reciprocals():
    """numpy-only code is not device code, a branch on a numpy value is
    no tracer branch, and the mean's reciprocal multiply is clean."""
    src = ("def f(cut, h, d):\n"
           "    m = np.asarray(cut)\n"
           "    if not m.any():\n"
           "        return None\n"
           "    n = int(m.sum())\n"
           "    return h * (1.0 / d)[:, None], n, cut.tolist()\n")
    assert not ast_lint.lint_source(src).findings
    src = ("def f(h, d):\n"
           "    return h / d.unsqueeze(-1)\n")
    assert [f.rule for f in ast_lint.lint_source(src).findings] == \
        ["broadcast-div"]


@pytest.mark.parametrize("path,old,new", [
    ("kernels/seg_agg.py", "[ctypes.c_int] * 11", "[ctypes.c_int] * 10"),
    ("kernels/fused_agg_combine.py", "[ctypes.c_int] * 9",
     "[ctypes.c_int] * 10"),
    ("kernels/flash_attention.py", "[ctypes.c_float] * 2",
     "[ctypes.c_float] * 1"),
])
def test_grid_arity_holds_each_wrapper_to_its_entry(path, old, new):
    """Each shipped wrapper's argtypes agree with its extern "C" entries;
    one argument more or fewer fires."""
    src = (analysis.PACKAGE / path).read_text()
    assert old in src
    assert not ast_lint.lint_source(src, path).findings
    hits = ast_lint.lint_source(src.replace(old, new), path).findings
    assert hits and all(f.rule == "grid-arity" for f in hits)


def test_acc_dtype_reads_the_shipped_kernels():
    """The kernels accumulate in f32: clean; a bf16 accumulator or an f16
    wgmma accumulator planted into K1's source fires."""
    src = (analysis.PACKAGE / "csrc" / "seg_agg.cu").read_text()
    assert not ast_lint.lint_cuda_source(src).findings
    planted = src + "\n__device__ void k(bf16* o) { bf16 sum = 0; o[0] = sum; }\n"
    assert [f.rule for f in ast_lint.lint_cuda_source(planted).findings] \
        == ["acc-dtype"]
    wg = "asm volatile(\"wgmma.mma_async.sync.aligned.m64n64k16.f16.bf16.bf16 {}\");\n"
    assert ast_lint.lint_cuda_source(wg).findings


# ---------------------------------------------------------------------------
# The shipped tree and the plan matrix are clean
# ---------------------------------------------------------------------------


def test_shipped_tree_is_clean():
    report = ast_lint.lint_tree(analysis.PACKAGE)
    assert report.ok(strict=False), report.render()


#: cells of the CPU matrix: the torch tier's 6 local, 1 donation, 1
#: reorder, 2 dedup, 7 LocalMesh((8,)) and 6 LocalMesh((4, 2)) plans
CPU_CELLS = 23


@pytest.fixture(scope="module")
def matrix():
    return list(analysis.build_matrix("cpu"))


def test_matrix_has_the_reference_cells(matrix):
    assert len(matrix) == CPU_CELLS
    labels = [tl.plan_label(p) for p, _ in matrix]
    assert len(set(labels)) == CPU_CELLS - 1    # the donation cell's
    assert sum(kw.get("dynamic", False) for _, kw in matrix) == 1


@pytest.mark.parametrize("index", range(CPU_CELLS))
def test_matrix_cells_clean(matrix, index):
    plan, kwargs = matrix[index]
    report = tl.lint_plan(plan, **kwargs)
    assert report.ok(strict=False), report.render()
    infos = [f for f in report.findings if f.severity == "info"]
    assert all(f.rule == "donation" for f in infos)
    assert bool(infos) == bool(kwargs.get("donate"))


def test_runner_on_cpu(capsys, monkeypatch, matrix):
    """The runner's self-test and gate over (a cut of) the CPU matrix: an
    error finding fails ``--strict`` only."""
    monkeypatch.setattr(analysis, "build_matrix",
                        lambda device: iter(matrix[:2]))
    assert analysis_main(["--device", "cpu", "--strict", "--selftest"]) == 0
    out = capsys.readouterr().out
    assert "analysis --selftest: OK (12 rules" in out
    assert "analysis: OK (2 plan cells on cpu, 0 error(s)" in out

    def failing(plan, **kw):
        report = AnalysisReport()
        report.add("no-f64", "error", tl.plan_label(plan), "planted")
        return report
    monkeypatch.setattr(tl, "lint_plan", failing)
    assert analysis_main(["--device", "cpu", "--strict", "--json"]) == 1
    assert analysis_main(["--device", "cpu"]) == 0
    assert "analysis: FAILED (2 plan cells on cpu, 2 error(s)" in \
        capsys.readouterr().out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8-agg"])
@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_cuda_tier_plans_clean_with_opaque_kernels(cuda_tier_on_cpu, fused,
                                                   dtype, dedup):
    """The cuda tier's plans over CPU tensors: every rule clean, K1 (or
    K2 when fused) one opaque node a layer, no aggregation ops of theirs
    in the trace, no launch counted."""
    g = _hub_graph() if dedup == "pairs" else \
        make_synthetic_graph(SPEC, device="cpu")
    plan = build_plan(g, CFG, SPEC.feature_len, SPEC.num_classes,
                      backend="cuda", device="cpu", fused=fused,
                      dtype=dtype, dedup=dedup)
    before = ops.launch_counts()
    report = tl.lint_plan(plan, dynamic=not fused and dedup == "none")
    assert report.ok(strict=False), report.render()
    tr = tl.trace(lambda p, x: plan.run_model(p, x), tl.plan_params(plan),
                  tl.TensorSpec((SPEC.num_vertices, SPEC.feature_len)))
    names = [op.packet for op in tr.ops]
    kern = "repro_torch.fused_agg_combine" if fused else \
        "repro_torch.seg_agg"
    assert names.count(kern) == plan.num_layers
    assert "aten.index_add_" not in names
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# The dynamic, dedup and collective rules see what they price
# ---------------------------------------------------------------------------


def test_dynamic_rule_catches_a_plan_that_bakes_its_edges(monkeypatch):
    g = make_synthetic_graph(SPEC, device="cpu")
    plan = build_plan(g, CFG, SPEC.feature_len, SPEC.num_classes,
                      device="cpu")
    assert tl.lint_plan(plan, dynamic=True).ok(strict=False)
    # a forward that ignores the runtime graph folds the template's edges
    monkeypatch.setattr(CompiledPlan, "_forward",
                        lambda self, params, x, *arrays:
                        self.plan.run_model(params, x))
    hits = [f for f in tl.lint_plan(plan, dynamic=True).findings
            if f.rule == "dynamic-edge-free"]
    assert {f.message.split("'s ")[-1].split(" ")[0] for f in hits} >= \
        {"src", "dst", "in_deg"}
    # a fused plan folds over its own graph's layout: refused outright
    fused = build_plan(g, CFG, SPEC.feature_len, SPEC.num_classes,
                       device="cpu", fused=True)
    with pytest.raises(ValueError, match="dynamic graph dispatch"):
        fused.compile(dynamic=True)


def _hub_graph():
    """Every destination draws two of four hub in-neighbours, so pairs
    are guaranteed to match (the matrix's dedup block)."""
    from repro_torch.graph.structure import graph_from_coo
    rng = np.random.default_rng(0)
    hub = np.array([(a, b) for a in range(4) for b in range(a + 1, 4)])
    sel = hub[rng.integers(0, len(hub), SPEC.num_vertices)]
    return graph_from_coo(sel.reshape(-1),
                          np.repeat(np.arange(SPEC.num_vertices), 2),
                          SPEC.num_vertices, device="cpu")


def test_dedup_rule_sees_the_shortened_fold(cuda_tier_on_cpu):
    g = _hub_graph()
    plan = build_plan(g, CFG, SPEC.feature_len, SPEC.num_classes,
                      device="cpu", dedup="pairs")
    lay = plan.dedup_layout
    assert 0 < lay.num_pairs and lay.num_edges2 < lay.naive_edges
    spec_x = tl.TensorSpec((SPEC.num_vertices, SPEC.feature_len))
    tr = tl.trace(lambda p, x: plan.run_model(p, x), tl.plan_params(plan),
                  spec_x)
    dims = tl.dedup_fold_dims(tr)
    assert dims["scatter"] == [lay.num_edges2] * plan.num_layers
    assert lay.num_pairs in dims["gather"]
    rep = AnalysisReport()
    tl.check_dedup_fold(tr, lay, "dedup", rep)
    assert not rep.findings
    # the naive plan's trace, held to the same layout, fires
    naive = build_plan(g, CFG, SPEC.feature_len, SPEC.num_classes,
                       device="cpu")
    tr = tl.trace(lambda p, x: naive.run_model(p, x), tl.plan_params(naive),
                  spec_x)
    rep = AnalysisReport()
    tl.check_dedup_fold(tr, lay, "naive", rep)
    assert {f.message for f in rep.findings} >= {
        "naive-length fold inside a dedup='pairs' trace",
        "two-level fold absent from the trace"}
    # on the cuda tier K1 gathers [x ; partials]
    cplan = build_plan(g, CFG, SPEC.feature_len, SPEC.num_classes,
                       device="cpu", backend="cuda", dedup="pairs")
    tr = tl.trace(lambda p, x: cplan.run_model(p, x),
                  tl.plan_params(cplan), spec_x)
    assert tl.dedup_fold_dims(tr)["kernel"] == \
        [SPEC.num_vertices + cplan.dedup_layout.num_pairs] * 2
    rep = AnalysisReport()
    tl.check_dedup_fold(tr, cplan.dedup_layout, "cuda", rep, tier="cuda")
    assert not rep.findings


#: (mesh shape, axis names, strategy, overlap): the all-gather halo has no
#: per-hop schedule to pipeline
MESHES = [((8,), ("data",), "ring", "none"),
          ((8,), ("data",), "ring", "pipelined"),
          ((8,), ("data",), "allgather", "none"),
          ((4, 2), ("node", "feat"), "ring", "none"),
          ((4, 2), ("node", "feat"), "ring", "pipelined")]


@pytest.mark.parametrize("shape,axes,strategy,overlap", MESHES)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8-agg"])
def test_expected_collectives_equal_reference_and_trace(shape, axes,
                                                        strategy, overlap,
                                                        dtype):
    """``plan_expected_collectives`` is the reference's arithmetic on the
    reference's partition of the same graph, and the bytes the mesh
    counted across a fake trace of the forward."""
    g = make_synthetic_graph(SPEC, device="cpu")
    mesh = LocalMesh(shape, axes, device="cpu")
    plan = build_plan(g, CFG, SPEC.feature_len, SPEC.num_classes,
                      device="cpu", mesh=mesh, strategy=strategy,
                      overlap=overlap, dtype=dtype)
    jg = jgraph(jreduced(JCORA, 64, 16))
    jp = jpart.partition_2d(jg, *shape) if len(shape) == 2 else \
        jpart.partition_1d(jg, shape[0], edge_balanced=False)
    stand_in = types.SimpleNamespace(
        distributed=True, partition_kind=plan.partition_kind, partition=jp,
        layers=plan.layers, strategy=plan.strategy, overlap=plan.overlap,
        dtype=plan.dtype)
    want = tl.plan_expected_collectives(plan)
    assert want == jlint.plan_expected_collectives(stand_in)
    assert sum(want.values()) > 0
    tr = tl.trace(lambda p, x: plan.run_model(p, x), tl.plan_params(plan),
                  tl.TensorSpec((SPEC.num_vertices, SPEC.feature_len)),
                  mesh=mesh)
    assert tr.collectives == want


# ---------------------------------------------------------------------------
# K1 and K2 as opaque ops: fake implementations, no launch in a trace
# ---------------------------------------------------------------------------


def _layout():
    g = make_synthetic_graph(SPEC, device="cpu")
    return block_graph_arrays(g.src.numpy(), g.dst.numpy(), SPEC.num_vertices,
                              32, device="cpu", transpose_rows=SPEC.num_vertices)


K1_ENTRIES = [(torch.float32, None), (torch.bfloat16, None),
              (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("dtype,out_dtype", K1_ENTRIES)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_k1_fake_matches_plain(dtype, out_dtype, weighted, backward):
    bg = _layout()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (SPEC.num_vertices, 24)).astype(np.float32)).to(dtype)
    w = torch.rand(bg.src.shape) if weighted else None
    args = (x, bg.src, bg.dstl, bg.mask, w, bg.tile_m, backward, out_dtype)
    real = torch.ops.repro_torch.seg_agg(*args)
    plain = k1.seg_agg_plain(x, bg.src, bg.dstl, bg.mask, w,
                             tile_m=bg.tile_m, out_dtype=out_dtype)
    assert torch.equal(real, plain)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = torch.ops.repro_torch.seg_agg(*args)
    assert (fake.shape, fake.dtype) == (plain.shape, plain.dtype)
    assert fake.shape[0] == bg.nblocks * bg.tile_m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_packed_fake_matches_plain(dtype):
    """The packed op over a capped transposed layout: the real body on
    the CPU is the plain store; the fake stores nothing and keeps out."""
    g = make_synthetic_graph(SPEC, device="cpu")
    bg = block_graph_arrays(g.src.numpy(), g.dst.numpy(), SPEC.num_vertices,
                            32, device="cpu")
    t = transposed_layout(bg, SPEC.num_vertices, 8)
    assert t.out_rows is not None and t.fold is not None
    gx = torch.randn((bg.nblocks * 32, 16)).to(dtype)
    want = k1.fold_transposed(gx, t, plain=True)
    got = k1.fold_transposed(gx, t)
    assert torch.equal(got, want)
    n = t.num_vertices + (0 if t.fold is None else t.fold.num_vertices)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        out = torch.empty((n, 16))
        res = torch.ops.repro_torch.seg_agg_packed(
            mode.from_tensor(gx), t.src, t.dstl, t.mask, None, out,
            t.out_rows, t.tile_m, t.num_vertices, True)
        assert res is None
        assert (out.shape, out.dtype) == (want.shape, want.dtype)


K2_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("xd,wd", K2_PAIRS)
def test_k2_fake_matches_plain(xd, wd):
    bg = _layout()
    x = torch.randn((SPEC.num_vertices, 24)).to(xd)
    w = torch.randn((24, 10)).to(wd)
    args = (x, bg.src, bg.dstl, bg.mask, w, bg.tile_m)
    real = torch.ops.repro_torch.fused_agg_combine(*args)
    plain = k2.fused_agg_combine_plain(x, bg.src, bg.dstl, bg.mask, w,
                                       tile_m=bg.tile_m)
    assert torch.equal(real, plain)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = torch.ops.repro_torch.fused_agg_combine(*args)
    assert (fake.shape, fake.dtype) == (plain.shape, plain.dtype)


def test_eager_calls_skip_the_op_dispatch():
    """``opaque_call`` runs a kernel's body directly on plain tensors (and
    parameters) outside a trace, and through its op under a dispatch mode
    or with a fake tensor among the arguments."""
    op = lambda *a: "op"            # noqa: E731
    body = lambda *a: "body"        # noqa: E731
    x = torch.ones(2)
    assert k1.opaque_call(op, body, x, torch.nn.Parameter(x), 3) == "body"
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        assert k1.opaque_call(op, body, x) == "op"
        fake = mode.from_tensor(x)
    assert k1.opaque_call(op, body, fake) == "op"
    tr = tl.trace(lambda t: k1.opaque_call(op, body, t), tl.TensorSpec((2,)))
    assert tr.output == "op"


def test_fake_refuses_what_the_kernels_refuse():
    bg = _layout()
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty((SPEC.num_vertices, 8), dtype=torch.float64)
        with pytest.raises(TypeError, match="seg_agg"):
            torch.ops.repro_torch.seg_agg(x, bg.src, bg.dstl, bg.mask, None,
                                          32, False, None)
        with pytest.raises(TypeError, match="fused_agg_combine"):
            torch.ops.repro_torch.fused_agg_combine(
                x.to(torch.bfloat16), bg.src, bg.dstl, bg.mask,
                torch.empty((8, 4)), 32)


def test_no_trace_moves_a_launch_counter(cuda_tier_on_cpu, monkeypatch):
    """A trace of cuda-tier plans reaches no real body (their plain
    versions stay uncalled), and a trace whose function moves a counter
    is refused."""
    calls = []
    monkeypatch.setattr(k1, "seg_agg_plain",
                        lambda *a, **kw: calls.append("k1"))
    monkeypatch.setattr(k2, "fused_agg_combine_plain",
                        lambda *a, **kw: calls.append("k2"))
    g = make_synthetic_graph(SPEC, device="cpu")
    before = ops.launch_counts()
    for fused in (False, True):
        plan = build_plan(g, CFG, SPEC.feature_len, SPEC.num_classes,
                          backend="cuda", device="cpu", fused=fused)
        tl.lint_plan(plan)
    assert not calls and ops.launch_counts() == before

    def launches(x):
        k1.seg_agg.launches += 1
        return x

    with pytest.raises(AssertionError, match="launched"):
        tl.trace(launches, tl.TensorSpec((4,)))
    k1.seg_agg.launches -= 1


# ---------------------------------------------------------------------------
# kernels.ops.seg_agg under a trace
# ---------------------------------------------------------------------------


def test_seg_agg_raises_under_a_trace():
    rows = torch.ones((6, 2))
    seg = torch.zeros((6,), dtype=torch.int32)
    assert ops.seg_agg(rows, seg, 4, backend="torch").shape == (4, 2)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        with pytest.raises(ValueError) as ei:
            ops.seg_agg(mode.from_tensor(rows), seg, 4, backend="torch")
        assert str(ei.value) == ops.SEG_AGG_REMEDIATION
        # a real tensor under an active fake mode too
        with pytest.raises(ValueError):
            ops.seg_agg(rows, seg, 4, backend="torch")
    with pytest.raises(ValueError, match="seg_agg_planned"):
        tl.trace(lambda r: ops.seg_agg(r, seg, 4, backend="torch"),
                 tl.TensorSpec((6, 2)))


def test_seg_agg_remediation_shared_with_ast_rule():
    """The error a user hits when tracing ``seg_agg`` and the
    host-in-trace finding a reviewer reads agree VERBATIM on the fix."""
    text = ops.SEG_AGG_REMEDIATION
    assert "seg_agg_planned" in text
    for entry in ("build_plan", "plan_for_conv", "plan_for_phases"):
        assert entry in text
    src = ("def f(x):\n"
           "    y = torch.sum(x)\n"
           "    return float(torch.max(y))\n")
    hits = [f for f in ast_lint.lint_source(src).findings
            if f.rule == "host-in-trace"]
    assert hits and text in hits[0].detail
