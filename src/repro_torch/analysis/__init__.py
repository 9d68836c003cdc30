"""Static contract verification for the port's plans and source
(``repro/analysis``).

The paper's guidelines (2001.10160) assume the *measured* execution
matches the *planned* one.  ``repro_torch.analysis`` proves the planner's
contracts from the traced program without executing it:

  * :mod:`repro_torch.analysis.trace_lint` -- trace a
    ``GraphExecutionPlan`` (its eager forward and ``plan.compile()``'s)
    under fake tensors, K1 and K2 as opaque torch ops, then verify trace
    purity, f32 accumulation under bf16, donation, schedule-exact
    collective bytes, the shortened fold of a dedup plan and the
    edge-content freedom of a dynamic plan.
  * :mod:`repro_torch.analysis.ast_lint` -- a source pass over
    ``src/repro_torch/`` (Python and ``csrc/*.cu``) for capture and
    bitwise hazards.
  * :mod:`repro_torch.analysis.report` -- the typed ``Finding`` /
    ``AnalysisReport`` core (JSON, markdown, severity levels).
  * :mod:`repro_torch.analysis.selftest` -- one seeded violation per rule.

Run it as ``python -m repro_torch.analysis [--strict] [--selftest]
[--json] [--markdown] [--device cuda|cpu]``: the self-test, then every
cell of :func:`build_matrix` and the source tree.  The default device is
``cuda``; ``--device cpu`` lints the ``torch`` tier (the cuda tier's plans
are built over CUDA tensors, which a CPU has none of; the CPU tests lint
them over CPU tensors with the tier's device check lifted).

Rule catalog (the ids are the reference's):

=====================  ========  ==========================================
rule                   severity  what fires it
=====================  ========  ==========================================
``no-callbacks``       error     a host sync in a trace: ``.item()``,
                                 ``float(t)``, ``.tolist()``
                                 (``aten._local_scalar_dense``), a
                                 device-to-host copy, ``.numpy()``
``no-f64``             error     a float64 value or constant in a trace
``bf16-f32-accum``     error     an ``mm``/``addmm``/``bmm``/``matmul``
                                 with a bf16 operand and no f32 result
``donation``           error     two replays of ``compile(donate=True)``
                                 in different storage, or of
                                 ``compile()`` in the same (on a card;
                                 ``info`` on the CPU, where nothing is
                                 captured)
``collective-bytes``   error     a mesh's counted bytes over one forward
                                 (across the fake trace, and in a
                                 compiled plan's capture) other than
                                 ``schedule_wire_bytes`` summed over
                                 layers
``dedup-accounting``   error     a pairs plan's trace folding the naive
                                 edge count, or missing the
                                 ``num_edges2`` fold / ``num_pairs``
                                 gathers (torch tier), or a K1/K2 node
                                 not gathering ``[x ; partials]`` (cuda)
``dynamic-edge-free``  error     a ``compile(dynamic=True)`` trace holding
                                 the template's ``src``/``dst``/
                                 ``in_deg`` or blocked layout as a
                                 constant
``host-in-trace``      error     ``.item()``, ``.tolist()``, ``.cpu()``,
                                 ``.numpy()``, ``float(torch...)`` or
                                 ``torch.cuda.synchronize()`` in a
                                 function that calls ``torch.``/``F.``
                                 compute
``tracer-branch``      warning   ``if``/``while`` on a value a ``torch.``
                                 call made in the same function
``broadcast-div``      error     ``h / d[:, None]``, ``h / d.unsqueeze()``
``acc-dtype``          error     CUDA counterpart of the Pallas scratch
                                 dtype rule: a 16-bit accumulator in
                                 ``csrc/*.cu`` (a ``+=`` target or an
                                 ``acc``/``sum`` name), or a ``wgmma``
                                 with an f16 accumulator
``grid-arity``         error     CUDA counterpart of the grid/BlockSpec
                                 arity rule: ctypes ``argtypes`` whose
                                 length is not the parameter count of the
                                 ``extern "C"`` entry the wrapper loads
=====================  ========  ==========================================

K5 (``flash_attention``) stays a ctypes call: no plan reaches it, and no
trace of the LM path is linted; its ``argtypes`` are checked by
``grid-arity``.

Pragmas: ``# analysis: allow(rule-id)`` on the offending line or the line
above, ``# analysis: allow-file(rule-id)`` anywhere in the file (``//``
in a ``.cu`` file).  Each pragma in the shipped tree says why the code
runs at build time, never inside a trace or a capture.
"""

from __future__ import annotations

from pathlib import Path

from repro_torch.analysis.report import AnalysisReport, Finding  # noqa: F401

#: rule id -> the reference rule it stands for, where the port's reads
#: another front end (the CUDA sources instead of Pallas calls)
CUDA_COUNTERPARTS = {"acc-dtype": "Pallas VMEM/SMEM scratch dtype",
                     "grid-arity": "pallas_call grid vs BlockSpec arity"}

LOCAL_DTYPES = ("f32", "bf16", "int8-agg")
OVERLAPS = ("none", "pipelined")
#: the package root the source rules walk
PACKAGE = Path(__file__).resolve().parents[1]


def build_matrix(device: str = "cuda"):
    """Yield ``(plan, lint_plan kwargs)`` for every cell of the static
    matrix on ``device`` (the reference's cells): the local tiers x fusion
    x dtype, ``dynamic`` on the torch/unfused/f32 cell; a donation cell
    (``feature_len == num_classes``, real params and features); a
    ``reorder="degree"`` cell; the hub-pair ``dedup="pairs"`` block on each
    tier; ``LocalMesh((8,))`` ring over overlap x dtype, plus all-gather;
    ``LocalMesh((4, 2))`` over overlap x dtype.  The local tiers are
    ``torch`` on the CPU, ``torch`` and ``cuda`` on a card."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import CORA, reduced_graph
    from repro_torch.core.distributed import LocalMesh
    from repro_torch.core.plan import build_plan
    from repro_torch.graph.datasets import make_features, make_synthetic_graph
    from repro_torch.graph.structure import graph_from_coo
    from repro_torch.models.gcn import PAPER_MODELS, make_paper_model

    tiers = ("torch",) if device == "cpu" else ("torch", "cuda")
    spec = reduced_graph(CORA, 64, 16)
    g = make_synthetic_graph(spec, device=device)
    cfg = dataclasses.replace(PAPER_MODELS["gcn"], hidden_dims=(8,))

    def plan(graph, **kw):
        return build_plan(graph, cfg, spec.feature_len, spec.num_classes,
                          device=device, **kw)

    for tier in tiers:
        for fused in (False, True):
            for dtype in LOCAL_DTYPES:
                dyn = tier == "torch" and not fused and dtype == "f32"
                yield plan(g, backend=tier, fused=fused, dtype=dtype), \
                    {"dynamic": dyn}

    # donation: a cell whose logits have the features' shape; the rule
    # runs the plan on a card, so its params and features are real
    spec_d = dataclasses.replace(spec, feature_len=spec.num_classes)
    g_d = make_synthetic_graph(spec_d, device=device)
    gen = torch.Generator().manual_seed(0)
    m = make_paper_model("gcn", spec_d, device=device, generator=gen,
                         hidden_dims=(8,))
    for tier in tiers:
        yield m.plan_for(g_d, backend=tier), {
            "donate": True, "params": m.tree(),
            "x": make_features(spec_d, device=device)}

    yield plan(g, reorder="degree"), {}

    # dedup: a fanout-regular block where every destination draws two hub
    # in-neighbours, so pairs are guaranteed to match
    rng = np.random.default_rng(0)
    hub_pairs = np.array([(a, b) for a in range(4) for b in range(a + 1, 4)])
    sel = hub_pairs[rng.integers(0, len(hub_pairs), spec.num_vertices)]
    g_dd = graph_from_coo(sel.reshape(-1),
                          np.repeat(np.arange(spec.num_vertices), 2),
                          spec.num_vertices, device=device)
    for tier in tiers:
        for fused in (False, True):
            yield plan(g_dd, backend=tier, fused=fused, dedup="pairs"), {}

    mesh = LocalMesh((8,), ("data",), device=device)
    for overlap in OVERLAPS:
        for dtype in LOCAL_DTYPES:
            yield plan(g, mesh=mesh, overlap=overlap, dtype=dtype), {}
    yield plan(g, mesh=mesh, strategy="allgather"), {}

    mesh2 = LocalMesh((4, 2), ("node", "feat"), device=device)
    for overlap in OVERLAPS:
        for dtype in LOCAL_DTYPES:
            yield plan(g, mesh=mesh2, overlap=overlap, dtype=dtype), {}


def run_matrix(device: str = "cuda", verbose: bool = False):
    """Lint every matrix cell and the shipped source tree; returns the
    merged ``AnalysisReport`` and the number of plan cells."""
    from repro_torch.analysis.ast_lint import lint_tree
    from repro_torch.analysis.trace_lint import lint_plan, plan_label

    report = AnalysisReport()
    cells = 0
    for plan, kwargs in build_matrix(device):
        cells += 1
        if verbose:
            print(f"  lint {plan_label(plan)} "
                  f"{sorted(k for k, v in kwargs.items() if v is True)}")
        report.merge(lint_plan(plan, **kwargs))
    lint_tree(PACKAGE, report)
    return report, cells
