"""InstrumentedPlan / WorkloadReport: one forward -> the Table-3/4 breakdown
(``repro/profile/instrument.py``).

``plan.instrument(machine=H100)`` wraps a ``GraphExecutionPlan`` so that
one ``run_model`` call records, per layer and per *executed* phase, what
the paper's Tables 3-5 tabulate: phase name, tier, ordering, analytic
FLOPs / bytes / arithmetic intensity, and measured wall time -- into a
typed ``WorkloadReport`` with ``to_json()`` and ``to_markdown()``.

The records come from a probe threaded through the dispatch the plan runs
in production (``core.plan._execute_layer`` via ``_phase``), so
``WorkloadReport.mismatches(plan)`` checks what ``plan.describe()`` claims
against what ran: the phase order, whether the fused phase ran, the tier of
the aggregation, the dtype, and whether compiled times contradict
``compiled=False``.

On a card the probe synchronizes before and after each phase, so a phase's
wall time is its device work plus its launches.  ``run_model(...,
compiled=True)`` also times ``plan.compile()`` (whole forward and each
layer) with ``profile.bench.timeit``.  The port's plans are local and f32,
so the collective, overlap, dedup and quantization fields of every record
are 0; they stay in the schema shared with the reference
(``tests/golden/workload_report.schema.json``).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.profile.machine import Machine

_DTYPE_BYTES = 4  # the framework's f32 feature convention

#: every phase name a record may carry (schema-validated)
PHASES = ("aggregate", "combine", "fused_agg_combine", "distributed")

SCHEMA = "repro.profile/workload-report"
SCHEMA_VERSION = 1


class WorkloadReportError(ValueError):
    """A WorkloadReport violated its schema (empty/ill-typed records)."""


@dataclass(frozen=True)
class PhaseRecord:
    """One executed phase of one layer, with analytic costs + wall time
    (``PhaseRecord``, :53).

    ``feature_len`` is the feature length the phase moved (for aggregation
    the paper's Table-4 variable: dout under combine-first, din under
    aggregate-first).  ``bound`` classifies the arithmetic intensity
    against the report's Machine balance.  ``backend`` is ``torch`` or
    ``cuda`` (the reference's ``xla`` and ``pallas-*``); a combine is a
    plain matmul, so always ``torch``.
    """

    layer: int
    phase: str              # one of PHASES
    order: str
    backend: str
    fused: bool
    feature_len: int
    flops: float
    bytes: float
    collective_bytes: float
    wall_time_s: float
    bound: str              # "memory" | "compute" vs the report's Machine
    exposed_collective_time: float = 0.0
    overlapped_collective_time: float = 0.0
    dtype: str = "f32"
    quant_error: float = 0.0
    wire_collective_bytes: float = 0.0
    dedup_pairs: int = 0
    dedup_flops_saved: float = 0.0

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1.0, self.bytes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "layer": self.layer, "phase": self.phase, "order": self.order,
            "backend": self.backend, "fused": self.fused,
            "feature_len": self.feature_len, "flops": self.flops,
            "bytes": self.bytes,
            "arithmetic_intensity": self.arithmetic_intensity,
            "collective_bytes": self.collective_bytes,
            "exposed_collective_time": self.exposed_collective_time,
            "overlapped_collective_time": self.overlapped_collective_time,
            "wall_time_s": self.wall_time_s, "bound": self.bound,
            "dtype": self.dtype, "quant_error": self.quant_error,
            "wire_collective_bytes": self.wire_collective_bytes,
            "dedup_pairs": self.dedup_pairs,
            "dedup_flops_saved": self.dedup_flops_saved,
        }


class _Probe:
    """Threaded through ``core.plan._execute_layer`` to observe dispatch.

    ``run(name, thunk, lp=..., **meta)`` runs the phase between two
    synchronizations of the card (none on the CPU), prices it from the
    graph and the layer plan, and appends a PhaseRecord.  Record order IS
    execution order (the ordering check depends on that).
    """

    def __init__(self, plan, machine: Machine):
        self.plan = plan
        self.machine = machine
        self.records: List[PhaseRecord] = []

    def _sync(self) -> None:
        if self.plan.device.type == "cuda":
            torch.cuda.synchronize(self.plan.device)

    def run(self, name: str, thunk, *, lp, **meta):
        from repro_torch.core.backend import resolve_backend
        self._sync()
        t0 = time.perf_counter()
        out = thunk()
        self._sync()
        dt = time.perf_counter() - t0
        flops, byt, flen = self._cost(name, lp, meta)
        self.records.append(PhaseRecord(
            layer=lp.index, phase=name, order=lp.order,
            # the tier as dispatch resolves it at call time, not lp.backend
            # verbatim, so an unresolved alias shows up in mismatches()
            backend=resolve_backend(lp.backend, self.plan.device)
            if name != "combine" else "torch",
            fused=(name == "fused_agg_combine"),
            feature_len=int(flen), flops=float(flops), bytes=float(byt),
            collective_bytes=0.0, wall_time_s=float(dt),
            bound=self.machine.classify(flops / max(1.0, byt))))
        return out

    def _cost(self, name, lp, meta):
        """(flops, bytes, feature_len) of one phase, from the models the
        scheduler prices (``_cost``, :220)."""
        from repro_torch.core.phases import aggregate_cost, combine_cost
        g = self.plan.g
        v = g.num_vertices
        if name == "aggregate":
            flen = meta["feature_len"]
            c = aggregate_cost(g, flen, include_self=lp.include_self)
            return c["flops"], c["bytes"], flen
        if name == "combine":
            dims = meta["dims"]
            c = combine_cost(v, dims)
            return c["flops"], c["bytes"], dims[-1]
        if name == "fused_agg_combine":
            # aggregate + first matmul in one tile: the (V, din)
            # intermediate never round-trips memory, so its write + read
            # bytes are subtracted
            din, dout = meta["dims"]
            agg = aggregate_cost(g, din, include_self=lp.include_self)
            comb = combine_cost(v, (din, dout))
            saved = 2 * v * din * _DTYPE_BYTES
            byt = max(agg["bytes"] + comb["bytes"] - saved, 1)
            return agg["flops"] + comb["flops"], byt, din
        raise ValueError(f"unknown phase {name!r}")


# ---------------------------------------------------------------------------
# WorkloadReport
# ---------------------------------------------------------------------------


_FIELD_TYPES = {
    "layer": int, "phase": str, "order": str, "backend": str, "fused": bool,
    "feature_len": int, "flops": (int, float), "bytes": (int, float),
    "arithmetic_intensity": (int, float), "collective_bytes": (int, float),
    "exposed_collective_time": (int, float),
    "overlapped_collective_time": (int, float),
    "wall_time_s": (int, float), "bound": str,
    "dtype": str, "quant_error": (int, float),
    "wire_collective_bytes": (int, float),
    "dedup_pairs": int, "dedup_flops_saved": (int, float),
}


def validate_report_dict(d: Dict[str, Any]) -> List[str]:
    """Structural validation of a report in dict form; returns problems
    (``validate_report_dict``, :333, the same rules).

    Works on fresh ``to_dict()`` output and on deserialized ``to_json()``
    artifacts (for those the totals-vs-phases cross-check matters).
    """
    problems: List[str] = []
    if d.get("schema") != SCHEMA or d.get("version") != SCHEMA_VERSION:
        problems.append("schema header mismatch")
    phases_list = d.get("phases", [])
    if not phases_list:
        problems.append("empty phase records")
    for i, rec in enumerate(phases_list):
        for k, t in _FIELD_TYPES.items():
            if k not in rec:
                problems.append(f"phases[{i}]: missing field {k!r}")
            elif not isinstance(rec[k], t) or isinstance(rec[k], bool) \
                    and t is not bool:
                problems.append(
                    f"phases[{i}].{k}: bad type {type(rec[k]).__name__}")
        if rec.get("phase") not in PHASES:
            problems.append(f"phases[{i}]: unknown phase "
                            f"{rec.get('phase')!r}")
        if rec.get("bound") not in ("memory", "compute"):
            problems.append(f"phases[{i}]: bad bound {rec.get('bound')!r}")
        if rec.get("dtype") not in ("f32", "bf16", "int8-agg"):
            problems.append(f"phases[{i}]: bad dtype {rec.get('dtype')!r}")
        for k in ("flops", "bytes", "collective_bytes", "wall_time_s",
                  "exposed_collective_time", "overlapped_collective_time",
                  "quant_error", "wire_collective_bytes"):
            if isinstance(rec.get(k), (int, float)) and rec[k] < 0:
                problems.append(f"phases[{i}].{k}: negative")
        if rec.get("dtype") == "f32" and \
                isinstance(rec.get("quant_error"), (int, float)) and \
                rec["quant_error"] != 0:
            problems.append(
                f"phases[{i}].quant_error: nonzero on an f32 record "
                "(the bitwise-golden contract forbids rounding)")
        if rec.get("phase") != "distributed":
            for k in ("exposed_collective_time",
                      "overlapped_collective_time",
                      "wire_collective_bytes"):
                if isinstance(rec.get(k), (int, float)) and rec[k] != 0:
                    problems.append(
                        f"phases[{i}].{k}: nonzero on non-distributed phase")
        if rec.get("phase") not in ("aggregate", "fused_agg_combine"):
            for k in ("dedup_pairs", "dedup_flops_saved"):
                if isinstance(rec.get(k), (int, float)) and rec[k] != 0:
                    problems.append(
                        f"phases[{i}].{k}: nonzero on non-aggregation phase")
    # a plan that resolved to dedup="pairs" proved matchable pairs exist,
    # so aggregation records that all carry dedup_pairs == 0 mean the
    # two-level dispatch did not run
    layer_descr = (d.get("plan") or {}).get("layers", [])
    if any(ld.get("dedup") == "pairs" for ld in layer_descr
           if isinstance(ld, dict)):
        agg_recs = [rec for rec in phases_list
                    if rec.get("phase") in ("aggregate",
                                            "fused_agg_combine")]
        if agg_recs and not any(
                isinstance(rec.get("dedup_pairs"), int)
                and rec["dedup_pairs"] > 0 for rec in agg_recs):
            problems.append(
                "dedup='pairs' plan with dedup_pairs == 0 on every "
                "aggregation record (matching was possible -- the plan "
                "resolved to 'pairs' -- but the two-level path did not "
                "dispatch)")
    reduced = [rec for rec in phases_list
               if rec.get("dtype") in ("bf16", "int8-agg")]
    if reduced and not any(
            isinstance(rec.get("quant_error"), (int, float))
            and rec["quant_error"] > 0 for rec in reduced):
        problems.append(
            "reduced-dtype report with quant_error == 0 everywhere "
            "(rounding must be observed somewhere, or the reduced path "
            "silently did not run)")
    tot = d.get("totals", {})
    for k in ("flops", "bytes", "collective_bytes"):
        if k not in tot:
            problems.append(f"totals.{k}: missing")
            continue
        s = sum(r[k] for r in phases_list
                if isinstance(r.get(k), (int, float)))
        if abs(s - tot[k]) > 1e-6 * max(1.0, abs(s)):
            problems.append(f"totals.{k} != sum of phases")
    comp = d.get("compiled")
    if comp is not None:            # optional: compiled-timing reports only
        if not isinstance(comp.get("model_s"), (int, float)) \
                or comp["model_s"] < 0:
            problems.append("compiled.model_s: missing/negative")
        layers_s = comp.get("layers_s", [])
        if not isinstance(layers_s, list) or any(
                not isinstance(t, (int, float)) or t < 0 for t in layers_s):
            problems.append("compiled.layers_s: ill-typed")
    serving = d.get("serving")
    if serving is not None:         # optional: serving-session reports only
        problems += _validate_serving(serving)
    return problems


def _validate_serving(s: Dict[str, Any]) -> List[str]:
    """Schema checks for a report's ``serving`` section
    (``_validate_serving``, :436): counters present and non-negative,
    percentiles monotone."""
    problems: List[str] = []
    for k in ("requests", "bucket_misses", "retraces"):
        v = s.get(k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            problems.append(f"serving.{k}: missing/negative")
    for k in ("p50_ms", "p95_ms", "p99_ms", "throughput_rps"):
        v = s.get(k)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            problems.append(f"serving.{k}: missing/negative")
    pcts = [s.get(k) for k in ("p50_ms", "p95_ms", "p99_ms")]
    if all(isinstance(p, (int, float)) for p in pcts) and \
            not (pcts[0] <= pcts[1] <= pcts[2]):
        problems.append("serving percentiles not monotone "
                        "(p50 <= p95 <= p99)")
    buckets = s.get("buckets")
    if not isinstance(buckets, list):
        problems.append("serving.buckets: missing")
    else:
        for i, b in enumerate(buckets):
            for k in ("num_seeds", "num_inputs", "num_edges", "hits"):
                v = b.get(k) if isinstance(b, dict) else None
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    problems.append(
                        f"serving.buckets[{i}].{k}: missing/negative")
    return problems


@dataclass
class WorkloadReport:
    """Typed per-phase characterization of one instrumented forward.

    ``records`` are in execution order.  ``output`` carries the forward's
    result, left out of ``to_dict``/``to_json``.  The reference's
    ``serving`` section belongs to its graph serving engine, not ported
    yet; ``validate_report_dict`` checks one in a dict all the same.
    """

    machine: Machine
    plan_summary: Dict[str, Any]
    records: List[PhaseRecord]
    output: Any = None
    #: {"model_s": float, "layers_s": [float per layer]} when the run also
    #: timed ``plan.compile()`` (None otherwise)
    compiled_times: Optional[Dict[str, Any]] = None

    def totals(self) -> Dict[str, float]:
        """Summed FLOPs / bytes / collective bytes / wall time over phases."""
        return {
            "flops": sum(r.flops for r in self.records),
            "bytes": sum(r.bytes for r in self.records),
            "collective_bytes": sum(r.collective_bytes
                                    for r in self.records),
            "wall_time_s": sum(r.wall_time_s for r in self.records),
        }

    def layer_records(self, layer: int) -> List[PhaseRecord]:
        return [r for r in self.records if r.layer == layer]

    def eager_layer_time(self, layer: int) -> float:
        """Summed eager wall time of one layer's recorded phases."""
        return sum(r.wall_time_s for r in self.layer_records(layer))

    def compiled_speedup(self) -> Optional[Dict[str, Any]]:
        """``{"model": eager_total / compiled_model, "layers": [per
        layer]}`` when compiled times were measured, else None."""
        ct = self.compiled_times
        if not ct:
            return None
        eager_total = sum(r.wall_time_s for r in self.records)
        layers = [self.eager_layer_time(i) / max(ls, 1e-12)
                  for i, ls in enumerate(ct.get("layers_s", []))]
        return {"model": eager_total / max(ct["model_s"], 1e-12),
                "layers": layers}

    def to_dict(self) -> Dict[str, Any]:
        m = self.machine
        out = {
            "schema": SCHEMA,
            "version": SCHEMA_VERSION,
            "machine": {"name": m.name, "kind": m.kind,
                        "peak_flops": m.peak_flops, "hbm_bw": m.hbm_bw,
                        "balance": m.balance},
            "plan": dict(self.plan_summary),
            "phases": [r.to_dict() for r in self.records],
            "totals": self.totals(),
        }
        if self.compiled_times is not None:
            out["compiled"] = {**self.compiled_times,
                               "speedup": self.compiled_speedup()}
        return out

    def to_json(self, indent: int = 2) -> str:
        """Stable JSON rendering (sorted keys) of ``to_dict``."""
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def to_markdown(self) -> str:
        """Paper-style per-phase breakdown table (Tables 3/4 in one view)."""
        m = self.machine
        tot = self.totals()
        t_all = max(tot["wall_time_s"], 1e-12)
        lines = [
            f"## Workload report — {m.name}",
            "",
            f"Machine: {m.name} ({m.kind}): peak "
            f"{m.peak_flops / 1e12:.1f} TFLOP/s, HBM "
            f"{m.hbm_bw / 1e9:.0f} GB/s, balance {m.balance:.1f} FLOP/B",
            f"Plan: {self.plan_summary.get('num_layers', '?')} layer(s), "
            f"partition={self.plan_summary.get('partition', 'none')}, "
            f"interpret={self.plan_summary.get('interpret')}",
            "",
            "| layer | phase | order | backend | FLOPs | bytes | AI (F/B) "
            "| bound | collective B | time (us) | time % |",
            "|---|---|---|---|---|---|---|---|---|---|---|",
        ]
        for r in self.records:
            lines.append(
                f"| {r.layer} | {r.phase} | {r.order} | {r.backend} | "
                f"{r.flops:.3e} | {r.bytes:.3e} | "
                f"{r.arithmetic_intensity:.2f} | {r.bound} | "
                f"{r.collective_bytes:.3g} | {r.wall_time_s * 1e6:.1f} | "
                f"{100 * r.wall_time_s / t_all:.1f} |")
        lines.append(
            f"| total |  |  |  | {tot['flops']:.3e} | {tot['bytes']:.3e} | "
            f"{tot['flops'] / max(1.0, tot['bytes']):.2f} |  | "
            f"{tot['collective_bytes']:.3g} | "
            f"{tot['wall_time_s'] * 1e6:.1f} | 100.0 |")
        sp = self.compiled_speedup()
        if sp is not None:
            ct = self.compiled_times
            per_layer = ", ".join(
                f"layer {i}: {s:.2f}x" for i, s in enumerate(sp["layers"]))
            lines += [
                "",
                f"Compiled (plan.compile): {ct['model_s'] * 1e6:.1f} us vs "
                f"eager {t_all * 1e6:.1f} us — {sp['model']:.2f}x"
                + (f" ({per_layer})" if per_layer else ""),
            ]
        return "\n".join(lines)

    def validate(self) -> "WorkloadReport":
        """Raise ``WorkloadReportError`` on schema violations
        (``validate_report_dict``); returns self for chaining."""
        problems = validate_report_dict(self.to_dict())
        if problems:
            raise WorkloadReportError(
                "WorkloadReport schema violations: " + "; ".join(problems))
        return self

    def mismatches(self, plan) -> List[str]:
        """Cross-check ``plan.describe()`` against the dispatched phases
        (``mismatches``, :651): whether the fused phase ran, the dtype of
        every record, the tier each aggregation resolved to, the executed
        phase order, and compiled times against ``compiled=False``.  The
        reference's reorder, dedup and overlap checks have nothing to
        observe on the port's local f32 plans.  Empty list == describe()
        is truthful."""
        out: List[str] = []
        for d in plan.describe():
            if self.compiled_times is not None and \
                    d.get("compiled") is False:
                out.append(f"layer {d['layer']}: describe compiled=False "
                           "but a compiled run was measured")
            recs = self.layer_records(d["layer"])
            if not recs:
                continue
            seq = [r.phase for r in recs]
            fused_ran = "fused_agg_combine" in seq
            if bool(d["fused"]) != fused_ran:
                out.append(f"layer {d['layer']}: describe fused={d['fused']} "
                           f"but executed phases {seq}")
            for r in recs:
                if r.dtype != d["dtype"]:
                    out.append(f"layer {d['layer']}: describe dtype="
                               f"{d['dtype']} but {r.phase} record carries "
                               f"{r.dtype}")
                if r.phase != "combine" and r.backend != d["backend"]:
                    out.append(f"layer {d['layer']}: describe backend="
                               f"{d['backend']} but {r.phase} used "
                               f"{r.backend}")
            if not fused_ran and "aggregate" in seq and "combine" in seq:
                observed = ("combine_first"
                            if seq.index("combine") < seq.index("aggregate")
                            else "aggregate_first")
                if observed != d["order"]:
                    out.append(f"layer {d['layer']}: describe order="
                               f"{d['order']} but executed {seq}")
        return out


# ---------------------------------------------------------------------------
# InstrumentedPlan
# ---------------------------------------------------------------------------


class InstrumentedPlan:
    """A ``GraphExecutionPlan`` whose runs yield ``WorkloadReport``s.

    Built by ``plan.instrument(machine=...)``; ``machine`` defaults to the
    plan's own (``H100`` for plans built with the default).  Each ``run_*``
    executes the plan's own dispatch eagerly (per-phase times need phase
    boundaries) and returns a fresh report whose ``.output`` is the
    forward's result.
    """

    def __init__(self, plan, machine: Optional[Machine] = None,
                 warmup: int = 0):
        self.plan = plan
        self.machine = machine or plan.machine
        self.warmup = warmup

    def _summary(self) -> Dict[str, Any]:
        return {"num_layers": self.plan.num_layers, "partition": "none",
                "interpret": False, "layers": self.plan.describe()}

    def _report(self, probe: _Probe, out) -> WorkloadReport:
        return WorkloadReport(machine=self.machine,
                              plan_summary=self._summary(),
                              records=probe.records, output=out)

    @staticmethod
    def _time(fn, *args) -> float:
        """Median wall seconds of ``fn(*args)`` through the shared harness
        (``profile.bench.timeit``; its warm-up absorbs the capture)."""
        from repro_torch.profile.bench import timeit
        return timeit(fn, *args, warmup=1, iters=3) / 1e6

    def _compiled_times(self, params, x) -> Dict[str, Any]:
        """Wall times of ``plan.compile()`` -- the whole forward and each
        planned layer compiled on its own (``plan.compile(layer=i)``),
        walking the layer/ReLU sequence ``run_model`` executes."""
        plan = self.plan
        model_s = self._time(plan.compile(), params, x)
        layers_s = []
        h = x
        for i in range(plan.num_layers):
            sub = params[f"conv{i}"]
            fl = plan.compile(layer=i)
            layers_s.append(self._time(fl, sub, h))
            h = fl(sub, h)
            if i < plan.num_layers - 1:
                h = torch.relu(h)
        return {"model_s": model_s, "layers_s": layers_s}

    def run_model(self, params, x, *, compiled: bool = False
                  ) -> WorkloadReport:
        """Instrumented full forward; the result rides along as
        ``report.output``.  ``compiled=True`` also times the
        ``plan.compile()`` path (whole model and per layer) into
        ``report.compiled_times``; the eager per-phase records are the
        same either way."""
        with torch.no_grad():
            for _ in range(self.warmup):
                self.plan.run_model(params, x)
            probe = _Probe(self.plan, self.machine)
            out = self.plan.run_model(params, x, _probe=probe)
        report = self._report(probe, out)
        if compiled:
            report.compiled_times = self._compiled_times(params, x)
        return report

    def run_layer(self, params, x, *, layer: int = 0) -> WorkloadReport:
        """Instrumented single layer (conv param subtree)."""
        probe = _Probe(self.plan, self.machine)
        with torch.no_grad():
            out = self.plan.run_layer(params, x, layer=layer, _probe=probe)
        return self._report(probe, out)

    def run_phases(self, x, weights, **kw) -> WorkloadReport:
        """Instrumented raw weight-list layer (``plan.run_phases``)."""
        probe = _Probe(self.plan, self.machine)
        with torch.no_grad():
            out = self.plan.run_phases(x, weights, _probe=probe, **kw)
        return self._report(probe, out)
