"""Seeded-violation self-test: prove every rule still catches its plant
(the counterpart of ``repro/analysis/selftest.py``).

``python -m repro_torch.analysis --selftest`` (and
``tests/test_torch_analysis.py``) run one KNOWN violation per rule through
the real detection path -- :func:`~repro_torch.analysis.trace_lint.trace`
and its rules for the traced rules,
:func:`~repro_torch.analysis.ast_lint.lint_source` and
:func:`~repro_torch.analysis.ast_lint.lint_cuda_source` for the source
rules -- and fail if any rule misses.  A linter whose rules silently rot
is worse than no linter: this is the gate that keeps the gate honest.

Each ``plant_*`` function returns the :class:`AnalysisReport` its seeded
violation produced; :func:`run_selftest` maps rule id -> detected and
also checks the suppression pragma path (a planted violation carrying
``# analysis: allow(...)`` must NOT fire).  Every plant runs on the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.analysis.ast_lint import lint_cuda_source, lint_source
from repro_torch.analysis.report import AnalysisReport
from repro_torch.analysis.trace_lint import (TensorSpec,
                                             check_collective_bytes,
                                             check_dedup_fold,
                                             check_donation,
                                             check_dynamic_consts,
                                             lint_callable, trace)

# -- traced plants ----------------------------------------------------------


def plant_no_callbacks() -> AnalysisReport:
    """A ``.item()`` host sync inside a traced function."""
    return lint_callable(lambda x: x * x.sum().item(), TensorSpec((4,)),
                         where="plant:no-callbacks")


def plant_no_f64() -> AnalysisReport:
    """An f64 upcast inside a traced function."""
    return lint_callable(lambda x: x.double() + 1.0, TensorSpec((4,)),
                         where="plant:no-f64")


def plant_bf16_accum() -> AnalysisReport:
    """A bf16 product WITHOUT the f32 accumulator (``a @ b`` gives
    bf16)."""
    a = TensorSpec((4, 4), torch.bfloat16)
    return lint_callable(lambda p, q: p @ q, a, a,
                         where="plant:bf16-f32-accum")


def plant_donation() -> AnalysisReport:
    """A donate=True claim over replays that returned fresh storage."""
    report = AnalysisReport()
    out = torch.zeros((8, 8))
    check_donation(out, out.clone(), True, "plant:donation", report)
    return report


def plant_collective_bytes() -> AnalysisReport:
    """A traced ring hop whose bytes contradict the claimed schedule: one
    hop of a (4, 8) f32 slab on a two-shard mesh moves 128 bytes a shard,
    and the claim is two hops."""
    from repro_torch.core.distributed import LocalMesh
    mesh = LocalMesh((2,), ("data",), device="cpu")
    slab = TensorSpec((4, 8))
    tr = trace(lambda a, b: mesh.ppermute([a, b], "data"), slab, slab,
               mesh=mesh)
    report = AnalysisReport()
    check_collective_bytes(tr.collectives, {"ppermute": 2 * 4 * 8 * 4},
                           "plant:collective-bytes", report)
    return report


def plant_dynamic_edge_free() -> AnalysisReport:
    """A 'dynamic' trace that closes over the template graph's edges."""
    src = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    dst = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    baked = src.clone()          # the violation: template edges as consts

    def fn(x, src_arg, dst_arg):
        return x + x[baked.long()].sum()

    tr = trace(fn, TensorSpec((4,)), TensorSpec((4,), torch.int32),
               TensorSpec((4,), torch.int32))
    report = AnalysisReport()
    check_dynamic_consts(tr, {"src": src, "dst": dst},
                         "plant:dynamic-edge-free", report)
    return report


def plant_dedup_accounting() -> AnalysisReport:
    """A dedup='pairs' pricing claim whose trace still runs the NAIVE
    fold: the layout prices the shortened (num_pairs=1, num_edges2=4)
    two-level aggregation, but the traced program index_adds all 6
    original edges -- the priced FLOP saving is bookkeeping, not work."""
    from repro_torch.graph.dedup import build_dedup_layout
    src = np.array([3, 4, 4, 3, 2, 3], np.int32)
    dst = np.array([0, 0, 1, 1, 2, 2], np.int32)
    lay = build_dedup_layout(src, dst, 6, device="cpu")
    assert lay.num_pairs == 1 and lay.num_edges2 == 4
    s, d = torch.from_numpy(src).long(), torch.from_numpy(dst).long()

    def fn(x):
        return torch.zeros_like(x).index_add_(0, d, x[s])

    tr = trace(fn, TensorSpec((6, 8)))
    report = AnalysisReport()
    check_dedup_fold(tr, lay, "plant:dedup-accounting", report)
    return report


# -- source plants ----------------------------------------------------------

_SRC_PLANTS = {
    "host-in-trace": (
        "def f(x):\n"
        "    y = torch.sum(x)\n"
        "    return float(torch.max(y))\n"),
    "tracer-branch": (
        "def f(x):\n"
        "    s = torch.sum(x)\n"
        "    if s > 0:\n"
        "        return s\n"
        "    return -s\n"),
    "broadcast-div": (
        "def f(h, deg):\n"
        "    return h / deg[:, None]\n"),
    "grid-arity": (
        "def launch(x, out):\n"
        "    fn = _build.load('plant').plant_entry\n"
        "    fn.argtypes = [ctypes.c_void_p] * 2\n"
        "    return fn(x.data_ptr(), out.data_ptr())\n"),
}
#: the CUDA source the grid-arity plant loads: three parameters
_PLANT_CSRC = {"plant": 'extern "C" int plant_entry(const float* x, '
                        'float* out, int n) { return 0; }\n'}
#: a fold that accumulates in bf16
_CUDA_PLANT = (
    "__global__ void fold(const float* x, __nv_bfloat16* out, int n) {\n"
    "  __nv_bfloat16 acc = 0;\n"
    "  for (int i = 0; i < n; ++i) acc += __float2bfloat16(x[i]);\n"
    "  out[0] = acc;\n"
    "}\n")


def _plant_source(rule: str) -> Callable[[], AnalysisReport]:
    def run() -> AnalysisReport:
        return lint_source(_SRC_PLANTS[rule], filename=f"plant:{rule}",
                           csrc=_PLANT_CSRC)
    run.__doc__ = f"Throwaway source seeding one {rule} violation."
    return run


def plant_acc_dtype() -> AnalysisReport:
    """A CUDA fold whose accumulator is a bf16 register."""
    return lint_cuda_source(_CUDA_PLANT, filename="plant:acc-dtype")


#: rule id -> plant callable; every registered rule must appear here
PLANTS: Dict[str, Callable[[], AnalysisReport]] = {
    "no-callbacks": plant_no_callbacks,
    "no-f64": plant_no_f64,
    "bf16-f32-accum": plant_bf16_accum,
    "donation": plant_donation,
    "collective-bytes": plant_collective_bytes,
    "dynamic-edge-free": plant_dynamic_edge_free,
    "dedup-accounting": plant_dedup_accounting,
    "acc-dtype": plant_acc_dtype,
    **{rule: _plant_source(rule) for rule in _SRC_PLANTS},
}


def check_suppression() -> bool:
    """The pragma path: an allowed plant must NOT fire, in Python and in
    CUDA source."""
    src = ("def f(h, deg):\n"
           "    return h / deg[:, None]  # analysis: allow(broadcast-div)\n")
    cu = _CUDA_PLANT.replace("  __nv_bfloat16 acc = 0;\n",
                             "  // analysis: allow(acc-dtype)\n"
                             "  __nv_bfloat16 acc = 0;\n")
    return not lint_source(src, filename="plant:suppressed").findings and \
        not lint_cuda_source(cu, filename="plant:suppressed").findings


def run_selftest() -> Tuple[Dict[str, bool], AnalysisReport]:
    """Run every plant; returns (rule -> detected, merged report).

    Detected means the plant produced at least one finding FOR ITS OWN
    rule.  The merged report also carries a synthetic
    ``selftest-suppression`` error if the pragma path stopped working.
    """
    merged = AnalysisReport()
    detected: Dict[str, bool] = {}
    for rule, plant in sorted(PLANTS.items()):
        rep = plant()
        detected[rule] = any(f.rule == rule for f in rep.findings)
        merged.merge(rep)
    if not check_suppression():
        merged.add("selftest-suppression", "error", "plant:suppressed",
                   "suppression pragma no longer suppresses findings")
        detected["selftest-suppression"] = False
    return detected, merged
