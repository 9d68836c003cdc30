"""Fake-tensor trace linter: prove the port's plan contracts from the trace
(the counterpart of ``repro/analysis/jaxpr_lint.py``).

A trace (:func:`trace`) runs a function under ``FakeTensorMode`` with a
recording ``TorchDispatchMode`` on top: every aten op the function reaches,
and K1's and K2's opaque ops (``repro_torch::seg_agg``,
``repro_torch::seg_agg_packed``, ``repro_torch::fused_agg_combine``), is
recorded with the shapes, dtypes and devices of its tensors -- the op list
plays the part of a jaxpr's equations.  Nothing executes: fake tensors
carry metadata only, the kernels' fake implementations launch nothing,
and a real tensor the function reads (a plan's layouts, its degrees) is a
constant of the trace.  Every trace asserts that
``kernels.ops.launch_counts()`` is unchanged across it.

:func:`lint_plan` traces (never executes) a
:class:`~repro_torch.core.plan.GraphExecutionPlan`'s eager forward and its
``plan.compile()`` forward, under ``torch.no_grad()``, and runs the rule
registry over both traces:

  * ``no-callbacks``      -- no host sync inside traced code:
    ``aten._local_scalar_dense`` (``.item()``, ``float(t)``,
    ``.tolist()``), a device-to-host ``_to_copy``/``copy_``, or a
    ``.numpy()`` read of a traced tensor.  A ``data_ptr()`` read, which a
    fake tensor only warns about, feeds a launch, and every trace asserts
    that no launch counter moved.
  * ``no-f64``            -- no float64 value or constant in the trace.
  * ``bf16-f32-accum``    -- every ``mm``/``addmm``/``bmm``/``matmul``
    node with a bf16 operand gives an f32 result (``aten.mm.dtype`` with
    ``out_dtype=float32``, or f32 operands after an upcast).  K1's and K2's
    accumulators are opaque here: the source rule ``acc-dtype`` reads
    them in ``csrc/*.cu``.
  * ``donation``          -- the port's own contract
    (``GraphExecutionPlan.compile``): on a card two replays of
    ``compile(donate=True)`` return the graph's static output storage
    (same ``data_ptr``), and without ``donate`` each call returns fresh
    storage.  It needs a capture, so it is checked on a card and is an
    info finding (unprovable) on the CPU.
  * ``collective-bytes``  -- the bytes each collective took in over one
    forward equal :func:`plan_expected_collectives` exactly (the
    reference's ``schedule_wire_bytes`` summed over layers).  A trace
    does not see a ``LocalMesh``'s stream copies as collectives, so the
    rule reads the mesh's own counters (``Mesh.collective_bytes()``),
    which move across the fake trace as they do in a run; on a card the
    bytes a compiled plan's capture counted
    (``CompiledPlan.capture_collectives``) are held to it too.
  * ``dedup-accounting``  -- a ``dedup="pairs"`` plan's trace runs the
    shortened fold it prices: on the unfused torch tier its
    ``index_add_`` folds (a fold's edge chunks added up) sum over
    ``num_edges2`` rows, never the naive ``num_edges``, and it gathers
    ``num_pairs`` pair rows; on the cuda tier every K1/K2 node gathers
    from the ``V + num_pairs`` rows of ``[x ; partials]``.
  * ``dynamic-edge-free`` -- a ``compile(dynamic=True)`` plan's traced
    forward has no constant equal to the template graph's
    ``src``/``dst``/``in_deg`` (on the cuda tier, nor to its layers'
    blocked layouts): every dispatch folds the runtime graph.

:func:`lint_callable` runs the trace-level rules over any function (the
self-test plants use it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import AnalysisReport

#: the collectives the halo schedules move, by the reference's primitive
#: names, with the ``Mesh.collective_bytes()`` key each is counted under
COLLECTIVE_PRIMS = ("ppermute", "all_gather", "reduce_scatter", "psum")
MESH_NAMES = {"ppermute": "collective-permute", "all_gather": "all-gather",
              "reduce_scatter": "reduce-scatter", "psum": "all-reduce"}
#: op packets that multiply matrices
MATMUL_OPS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm",
              "aten.mv", "aten.addmv", "aten.dot", "aten.matmul")
#: K1's and K2's opaque ops (``kernels.seg_agg``, ``kernels.fused_agg_
#: combine``), by op packet
KERNEL_OPS = ("repro_torch.seg_agg", "repro_torch.seg_agg_packed",
              "repro_torch.fused_agg_combine")

_aten = torch.ops.aten


class TensorSpec(NamedTuple):
    """A traced input given by its metadata: made a fake tensor of this
    shape, dtype and device inside the trace."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    device: Any = "cpu"


@dataclasses.dataclass
class TracedOp:
    """One op of a trace: its overload (``aten.mm.dtype``), its packet
    (``aten.mm``), the ``(shape, dtype, device)`` of its tensor arguments
    and results in order, and its first tensor argument (an in-place op's
    destination), held so that its identity stays unique."""

    name: str
    packet: str
    inputs: Tuple
    outputs: Tuple
    target: Optional[torch.Tensor]


@dataclasses.dataclass
class Trace:
    """What :func:`trace` recorded: the ops in order, the real tensors the
    function read (its constants), its host reads by kind, why it stopped
    early ('' when it ran to its end), the bytes the mesh counted across
    it by primitive, and the function's (fake) result."""

    ops: List[TracedOp]
    consts: List[torch.Tensor]
    host: Dict[str, int]
    stopped: str
    collectives: Dict[str, int]
    output: Any = None


class _HostRead(Exception):
    """Raised inside a trace at a host sync, which a trace cannot serve."""


def _meta(t: torch.Tensor) -> Tuple:
    return (tuple(t.shape), t.dtype, t.device)


class _Recorder(TorchDispatchMode):
    """Records every op under ``FakeTensorMode`` (which sits below it and
    computes the fake results)."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        self._fake = FakeTensor
        self.ops: List[TracedOp] = []
        self.consts: Dict[int, torch.Tensor] = {}
        self.host: Dict[str, int] = {}

    def _host(self, kind: str) -> None:
        self.host[kind] = self.host.get(kind, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [a for a in pytree.tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        for t in tensors:
            if not isinstance(t, self._fake):
                self.consts.setdefault(id(t), t)
        if func is _aten._local_scalar_dense.default:
            self._host(".item()")
            raise _HostRead(str(func))
        if func is _aten._to_copy.default and tensors and \
                tensors[0].device.type != "cpu" and \
                torch.device(kwargs.get("device") or
                             tensors[0].device).type == "cpu":
            self._host("device-to-host copy")
        if func is _aten.copy_.default and len(tensors) >= 2 and \
                tensors[0].device.type == "cpu" and \
                tensors[1].device.type != "cpu":
            self._host("device-to-host copy")
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        self.ops.append(TracedOp(
            str(func), str(func.overloadpacket),
            tuple(_meta(t) for t in tensors),
            tuple(_meta(t) for t in outs),
            tensors[0] if tensors else None))
        return out


def _fake_inputs(args, mode):
    def conv(a):
        if isinstance(a, TensorSpec):
            with mode:
                return torch.zeros(a.shape, dtype=a.dtype,
                                   device=torch.device(a.device))
        if isinstance(a, torch.Tensor):
            return mode.from_tensor(a)
        return a
    return pytree.tree_map(conv, args,
                           is_leaf=lambda a: isinstance(a, TensorSpec))


def trace(fn, *args, mesh=None) -> Trace:
    """Trace ``fn(*args)`` under fake tensors, never executing it.

    ``args`` may hold real tensors (made fake, metadata only),
    ``TensorSpec``s and any nesting of lists, tuples and dicts of them.
    ``mesh`` (a ``core.distributed.Mesh``): the bytes its counters moved
    across the trace are returned by primitive.  Runs under
    ``torch.no_grad()``.  Raises ``AssertionError`` if a kernel launch
    counter moved: a trace launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.ops import launch_counts
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake_args = _fake_inputs(args, mode)
    rec = _Recorder()
    before = launch_counts()
    bytes0 = None if mesh is None else mesh.collective_bytes()
    stopped, out = "", None
    try:
        with torch.no_grad(), mode, rec:
            out = fn(*fake_args)
    except _HostRead as e:
        stopped = str(e)
    except RuntimeError as e:
        msg = str(e)
        kind = next((k for k in ("numpy", "data pointer", "data_ptr")
                     if k in msg), None)
        if kind is None:
            raise
        rec._host(".numpy()" if kind == "numpy" else ".data_ptr()")
        stopped = msg.splitlines()[0]
    moved = {k: n - before[k] for k, n in launch_counts().items()
             if n != before[k]}
    if moved:
        raise AssertionError(f"a fake-tensor trace launched kernels: "
                             f"{moved}")
    got = {p: 0 for p in COLLECTIVE_PRIMS}
    if mesh is not None:
        now = mesh.collective_bytes()
        got = {p: int(now[MESH_NAMES[p]] - bytes0[MESH_NAMES[p]])
               for p in COLLECTIVE_PRIMS}
    return Trace(rec.ops, list(rec.consts.values()), rec.host, stopped, got,
                 out)


# ---------------------------------------------------------------------------
# Rules over a trace
# ---------------------------------------------------------------------------


def check_no_callbacks(tr: Trace, where: str, report: AnalysisReport) -> None:
    """Rule no-callbacks: traced code stays on the device."""
    for kind, n in sorted(tr.host.items()):
        report.add("no-callbacks", "error", where,
                   f"host read {kind} inside traced code",
                   f"{n} occurrence(s)"
                   + (f"; the trace stopped at {tr.stopped}"
                      if tr.stopped else ""))


def check_no_f64(tr: Trace, where: str, report: AnalysisReport) -> None:
    """Rule no-f64: no float64 value or constant anywhere in the trace."""
    n_vals = sum(1 for op in tr.ops for _, dt, _ in op.inputs + op.outputs
                 if dt == torch.float64)
    n_consts = sum(1 for c in tr.consts if c.dtype == torch.float64)
    if n_vals or n_consts:
        report.add("no-f64", "error", where,
                   "float64 values inside traced code",
                   f"{n_vals} value(s), {n_consts} const(s)")


def check_bf16_accum(tr: Trace, where: str, report: AnalysisReport) -> None:
    """Rule bf16-f32-accum: a matrix product with a bf16 operand gives
    the f32 accumulator (``torch.mm(..., out_dtype=torch.float32)``), or
    runs on f32 operands after an exact upcast -- reduced-precision
    storage never becomes reduced-precision math."""
    bad, example = 0, ""
    for op in tr.ops:
        if op.packet not in MATMUL_OPS:
            continue
        ins = [dt for _, dt, _ in op.inputs]
        if torch.bfloat16 not in ins:
            continue
        outs = [dt for _, dt, _ in op.outputs]
        if outs != [torch.float32]:
            bad += 1
            example = f"{op.name} operands {ins} -> {outs}"
    if bad:
        report.add("bf16-f32-accum", "error", where,
                   "bf16 matrix product without an f32 accumulator",
                   f"{bad} product(s); e.g. {example}")


def check_donation(first: torch.Tensor, second: torch.Tensor, donate: bool,
                   where: str, report: AnalysisReport, *,
                   captured: bool = True) -> None:
    """Rule donation: ``first`` and ``second`` are the results of two
    replays of one compiled signature.  With ``donate`` both are the
    graph's static output (one storage); without it each is fresh.
    ``captured=False`` (no CUDA graph: the CPU runs the eager forward)
    makes the contract unprovable: an info finding."""
    if not captured:
        if donate:
            report.add("donation", "info", where,
                       "donation declared but no graph was captured (the "
                       "CPU runs the eager forward); unprovable here")
        return
    same = first.data_ptr() == second.data_ptr()
    if donate and not same:
        report.add("donation", "error", where,
                   "donate=True but two replays returned distinct storage",
                   "the static output was cloned")
    elif not donate and same:
        report.add("donation", "error", where,
                   "donate=False but two replays share storage",
                   "the caller's result would be overwritten by the next "
                   "replay")


def check_collective_bytes(got: Dict[str, int], expected: Dict[str, int],
                           where: str, report: AnalysisReport) -> None:
    """Rule collective-bytes: per-collective byte totals equal the
    analytic schedule accounting EXACTLY."""
    for name in COLLECTIVE_PRIMS:
        if int(got.get(name, 0)) != int(expected.get(name, 0)):
            report.add("collective-bytes", "error", where,
                       f"{name} bytes diverge from the analytic schedule",
                       f"counted {int(got.get(name, 0))}, "
                       f"expected {int(expected.get(name, 0))}")


def dedup_fold_dims(tr: Trace) -> Dict[str, list]:
    """The lengths each fold in a trace runs over: ``scatter`` one entry a
    fold, the rows its ``index_add_`` chunks add into one destination
    summed (how many edge contributions it sums); ``gather`` each
    ``index.Tensor`` gather's rows; ``kernel`` the rows K1's and K2's
    nodes gather from."""
    folds: Dict[int, int] = {}
    dims = {"scatter": [], "gather": [], "kernel": []}
    for op in tr.ops:
        if op.packet in ("aten.index_add_", "aten.index_add") and \
                len(op.inputs) >= 3:
            key = id(op.target)
            folds[key] = folds.get(key, 0) + int(op.inputs[2][0][0])
        elif op.name == "aten.index.Tensor" and op.outputs:
            dims["gather"].append(int(op.outputs[0][0][0]))
        elif op.packet in KERNEL_OPS and op.inputs:
            dims["kernel"].append(int(op.inputs[0][0][0]))
    dims["scatter"] = list(folds.values())
    return dims


def check_dedup_fold(tr: Trace, layout, where: str, report: AnalysisReport,
                     *, tier: str = "torch") -> None:
    """Rule dedup-accounting: the trace executes the two-level fold the
    layout prices (``graph.dedup.dedup_cost`` keys its savings on
    ``(num_pairs, num_edges2)``).  On the torch tier a fold over the
    NAIVE edge count means the decision was priced but not executed, and
    a missing ``num_edges2`` fold or ``num_pairs`` pair gather means the
    two-level layout never reached the trace; on the cuda tier K1 and K2
    are opaque, and each of their nodes must gather from ``[x ;
    partials]``, ``V + num_pairs`` rows."""
    e, e2, p = layout.naive_edges, layout.num_edges2, layout.num_pairs
    dims = dedup_fold_dims(tr)
    gather = set(dims["gather"])
    if p and p not in gather:
        report.add("dedup-accounting", "error", where,
                   "pair-partial gathers absent from the trace",
                   f"no gather of the layout's {p} pair rows "
                   f"(gather rows seen: {sorted(gather)})")
    if tier != "torch":
        rows = layout.num_vertices + p
        off = sorted({n for n in dims["kernel"] if n != rows})
        if not dims["kernel"] or off:
            report.add("dedup-accounting", "error", where,
                       "a kernel node folds outside the two-level layout",
                       f"K1/K2 gather from {off or 'no'} rows; the layout "
                       f"prices [x ; partials] of {rows}")
        return
    scatter = set(dims["scatter"])
    if e != e2 and e in scatter:
        report.add("dedup-accounting", "error", where,
                   "naive-length fold inside a dedup='pairs' trace",
                   f"index_add_ over {e} rows; the layout prices the "
                   f"shortened {e2}-edge fold")
    if e2 not in scatter:
        report.add("dedup-accounting", "error", where,
                   "two-level fold absent from the trace",
                   f"no index_add_ fold over the layout's {e2} level-2 "
                   f"edges (fold rows seen: {sorted(scatter)})")


def check_dynamic_consts(tr: Trace, templates: Dict[str, torch.Tensor],
                         where: str, report: AnalysisReport) -> None:
    """Rule dynamic-edge-free: a dynamic plan's trace holds no constant
    equal to one of ``templates`` (the template graph's ``src``/``dst``/
    ``in_deg``, its blocked layouts): such a constant means the trace
    baked the edges and every dispatch would fold THIS graph."""
    for c in tr.consts:
        for name, tpl in templates.items():
            if c.shape == tpl.shape and c.dtype == tpl.dtype and \
                    c.device == tpl.device and torch.equal(c, tpl):
                report.add("dynamic-edge-free", "error", where,
                           f"trace holds the template graph's {name} as a "
                           f"constant",
                           f"const shape {tuple(c.shape)}, dtype {c.dtype}")
                break


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def lint_callable(fn, *args, where: str = "callable",
                  expected_collectives: Optional[Dict[str, int]] = None,
                  mesh=None) -> AnalysisReport:
    """Trace ``fn(*args)`` and run every trace-level rule over it.

    The self-test plants route through this, so a seeded violation
    exercises the same detection path as a real plan.  Pass
    ``expected_collectives`` (and the ``mesh`` whose counters to read) to
    also run the collective-bytes rule."""
    report = AnalysisReport()
    tr = trace(fn, *args, mesh=mesh)
    check_no_callbacks(tr, where, report)
    check_no_f64(tr, where, report)
    check_bf16_accum(tr, where, report)
    if expected_collectives is not None:
        check_collective_bytes(tr.collectives, expected_collectives, where,
                               report)
    return report


def plan_label(plan) -> str:
    """Stable cell label for findings, e.g.
    ``plan[backend=cuda,fused=False,partition=1d,mesh=(8,),dtype=bf16,...]``."""
    lp = plan.layers[0]
    mesh = "" if plan.mesh is None else \
        f"mesh={tuple(plan.mesh.shape.values())},"
    return (f"plan[{lp.kind},backend={lp.backend},fused={lp.fused},"
            f"partition={plan.partition_kind},{mesh}"
            f"strategy={plan.strategy},overlap={plan.overlap},"
            f"dtype={plan.dtype},reorder={plan.reorder},dedup={plan.dedup}]")


def plan_expected_collectives(plan) -> Dict[str, int]:
    """Analytic per-collective byte totals of one full forward of
    ``plan`` -- :func:`~repro_torch.core.distributed.schedule_wire_bytes`
    summed over layers (the halo width follows each layer's phase order:
    din under aggregate-first, dout under combine-first), as the
    reference's ``plan_expected_collectives`` sums it."""
    from repro_torch.core.distributed import schedule_wire_bytes
    from repro_torch.core.scheduler import AGGREGATE_FIRST
    totals = {name: 0 for name in COLLECTIVE_PRIMS}
    if not plan.distributed:
        return totals
    two_d = plan.partition_kind == "2d"
    for lp in plan.layers:
        flen = lp.din if lp.order == AGGREGATE_FIRST else lp.dout
        acc = schedule_wire_bytes(
            plan.partition, flen, strategy=plan.strategy,
            overlap=plan.overlap, dtype=plan.dtype,
            combine_out_len=lp.dout if two_d else None)
        totals["ppermute"] += acc["ppermute_bytes"]
        totals["all_gather"] += acc["all_gather_bytes"]
        totals["reduce_scatter"] += acc["reduce_scatter_bytes"]
        totals["psum"] += acc["psum_bytes"]
    return totals


def plan_params(plan) -> Dict:
    """The params tree a plan's forward takes, as ``TensorSpec``s on the
    plan's device: ``conv<i>.lin.{w,b}``, or ``conv<i>.mlp<j>.{w,b}`` for
    a layer of several matmuls."""
    dev = plan.device
    tree = {}
    for i, lp in enumerate(plan.layers):
        pairs = list(zip(lp.dims[:-1], lp.dims[1:]))
        names = ["lin"] if len(pairs) == 1 else \
            [f"mlp{j + 1}" for j in range(len(pairs))]
        tree[f"conv{i}"] = {n: {"w": TensorSpec((a, b), device=dev),
                                "b": TensorSpec((b,), device=dev)}
                            for n, (a, b) in zip(names, pairs)}
    return tree


def _captured(cp) -> bool:
    return any(c is not None for c in cp._traces.values())


def _tier(plan) -> str:
    return "cuda" if any(lp.backend == "cuda" for lp in plan.layers) \
        else "torch"


def donation_replays(plan, params, x, donate: bool):
    """Three calls of ``plan.compile(donate=donate)`` under
    ``torch.no_grad()`` (the capture, then two replays): the replays'
    results, and whether a graph was captured.  Launches the kernels on a
    card."""
    cp = plan.compile(donate=donate)
    with torch.no_grad():
        cp(params, x)
        first = cp(params, x)
        ptr = first.data_ptr()
        first = first if donate else first.clone()
        second = cp(params, x)
    if donate:
        assert first.data_ptr() == ptr
    return first, second, _captured(cp)


def lint_plan(plan, *, params=None, x=None, donate: bool = False,
              dynamic: bool = False, dynamic_args=None) -> AnalysisReport:
    """Statically verify one ``GraphExecutionPlan`` -- trace, never execute
    (apart from the donation rule's replays on a card).

    Traces the eager forward (``plan.run_model``) and the compiled one
    (``plan.compile(donate=...)``'s forward) under fake tensors, then
    applies the rule registry: no-callbacks, no-f64, bf16-f32-accum on
    both traces; collective-bytes against ``plan_expected_collectives``
    (the mesh's counters across each trace, and a compiled plan's
    ``capture_collectives`` once captured); dedup-accounting on a
    ``dedup="pairs"`` plan's unfused layers; donation (``donate=True``:
    replays of ``compile(donate=True)`` and of ``compile()`` on a card, an
    info finding on the CPU); and, with ``dynamic=True``,
    dynamic-edge-free over ``compile(dynamic=True)``'s traced forward.

    ``params``/``x`` default to ``plan_params(plan)`` and a zero feature
    matrix as ``TensorSpec``s -- a trace reads metadata only; the
    donation rule runs the plan and needs real ones.  ``dynamic_args``:
    ``(graph, layout, dedup)`` for the dynamic trace, default the plan's
    own graph (with ``plan.runtime_layout`` of it on the cuda tier)."""
    report = AnalysisReport()
    where = plan_label(plan)
    if params is None:
        params = plan_params(plan)
    if x is None:
        x = TensorSpec((plan.g.num_vertices, plan.layers[0].din),
                       device=plan.device)
    expected = plan_expected_collectives(plan)
    tier = _tier(plan)
    dedup_visible = plan.dedup == "pairs" and \
        plan.dedup_layout is not None and \
        (tier == "cuda" or all(not lp.fused for lp in plan.layers))
    # a bucket plan (dedup_pad=) serves runtime dispatch only
    cp = plan.compile(donate=donate) if plan.dedup_pad is None else None
    static = () if cp is None else (
        ("eager", lambda p, xx: plan.run_model(p, xx)),
        ("compiled", cp._forward))
    for tag, fn in static:
        w = f"{where}:{tag}"
        tr = trace(fn, params, x, mesh=plan.mesh)
        check_no_callbacks(tr, w, report)
        check_no_f64(tr, w, report)
        check_bf16_accum(tr, w, report)
        check_collective_bytes(tr.collectives, expected, w, report)
        if dedup_visible:
            check_dedup_fold(tr, plan.dedup_layout, w, report, tier=tier)

    if donate:
        w = f"{where}:compiled"
        captured = plan.device.type == "cuda"
        if captured and isinstance(x, TensorSpec):
            raise ValueError("the donation rule runs the plan on a card: "
                             "pass real params and x")
        if captured:
            for don in (True, False):
                first, second, captured = donation_replays(plan, params, x,
                                                           don)
                check_donation(first, second, don, w, report,
                               captured=captured)
        else:
            check_donation(None, None, True, w, report, captured=False)
    if cp is not None and _captured(cp) and plan.mesh is not None:
        got = cp.capture_collectives
        check_collective_bytes({p: got.get(MESH_NAMES[p], 0)
                                for p in COLLECTIVE_PRIMS}, expected,
                               f"{where}:captured", report)

    if dynamic:
        cpd = plan.compile(dynamic=True)
        g, layout, dedup = dynamic_args or (plan.g, None, None)
        if layout is None and tier == "cuda":
            layout = plan.runtime_layout(g.src.cpu().numpy(),
                                         g.dst.cpu().numpy())
        # no gradient: the layouts come without their transposed ones
        arrays = cpd._graph_args(g, layout, False)[0]
        if plan.dedup == "pairs":
            arrays += cpd._dedup_args(dedup, False)[0]
        w = f"{where}:dynamic"
        tr = trace(cpd._forward, params, x, *arrays)
        check_no_callbacks(tr, w, report)
        check_no_f64(tr, w, report)
        check_bf16_accum(tr, w, report)
        templates = {"src": plan.g.src, "dst": plan.g.dst,
                     "in_deg": plan.g.in_deg}
        for lp in plan.layers:
            for name in ("src", "dstl", "mask"):
                if lp.agg_layout is not None:
                    templates[f"layer {lp.index} layout {name}"] = \
                        getattr(lp.agg_layout, name)
        check_dynamic_consts(tr, templates, w, report)
    return report
