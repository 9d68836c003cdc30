"""Declarative benchmark specs and the one harness that runs them
(``repro/profile/bench.py``, :46-240).

A benchmark is a ``BenchSpec`` -- one (graph x machine x sweep axis)
declaration plus a ``measure`` callback that only computes and emits -- and
``run_specs`` runs any list of them:

  * scaled-graph construction, cached per (dataset, size, device),
  * warm-up and timing (``ctx.time``; 0.0 without running under
    ``dry=True``),
  * row collection, the stdout echo, and the CSV artifact (``write_csv``:
    header row, stable column order),
  * dry-run participation (``BenchSpec.dry``): "run" specs validate their
    scenarios without timing, "skip" specs are reported and skipped.

``timeit`` synchronizes the card when a result lies on one, so a time is
the device's work and not its enqueue.  A time taken on the CPU is the CPU
kernels' time and says nothing about the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.profile.machine import H100, Machine

# ---------------------------------------------------------------------------
# Timing + rows + CSV
# ---------------------------------------------------------------------------


def _devices(out) -> set:
    """CUDA devices of the tensors in a (nested) result."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if isinstance(out, (list, tuple)):
        return set().union(*(_devices(o) for o in out)) if out else set()
    if isinstance(out, dict):
        return _devices(list(out.values()))
    return set()


def _block(out) -> None:
    """Wait until the card has computed ``out`` (a no-op on the CPU)."""
    for dev in _devices(out):
        torch.cuda.synchronize(dev)


def timeit(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall time (us) of ``fn(*args)``, each call waited for: with
    ``torch.cuda.synchronize()`` when its result is on a card."""
    for _ in range(warmup):
        _block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e6)


def latency_percentiles(samples_s: List[float]) -> Dict[str, float]:
    """Serving-latency percentiles from per-request wall seconds.

    Returns ``{"p50_ms", "p95_ms", "p99_ms"}`` (milliseconds; zeros for an
    empty sample set so callers can always emit the columns), with numpy's
    linear interpolation, so p50 <= p95 <= p99 always holds.
    """
    if not samples_s:
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
    arr = np.asarray(samples_s, dtype=np.float64) * 1e3
    p50, p95, p99 = np.percentile(arr, [50.0, 95.0, 99.0])
    return {"p50_ms": float(p50), "p95_ms": float(p95), "p99_ms": float(p99)}


def make_row(name: str, us_per_call: float, **derived) -> Dict[str, Any]:
    row = {"name": name, "us_per_call": round(us_per_call, 2)}
    row.update(derived)
    return row


def format_row(row: Dict[str, Any]) -> str:
    """The harness's stdout echo: ``name,us,k=v,...``."""
    extras = ",".join(f"{k}={v}" for k, v in row.items()
                      if k not in ("name", "us_per_call"))
    return f"{row['name']},{row['us_per_call']},{extras}"


def csv_columns(rows: List[Dict[str, Any]]) -> List[str]:
    """Stable column order: name, us_per_call, then sorted derived keys."""
    keys = sorted({k for r in rows for k in r} - {"name", "us_per_call"})
    return ["name", "us_per_call"] + keys


def write_csv(rows: List[Dict[str, Any]], path) -> Optional[Path]:
    """Write rows as a CSV artifact: header row, stable column order,
    empty cells for missing keys.  Returns the path (None if no rows)."""
    if not rows:
        return None
    import csv

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=csv_columns(rows), restval="",
                           extrasaction="raise")
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return path


# ---------------------------------------------------------------------------
# Scaled datasets (cached across specs within a process)
# ---------------------------------------------------------------------------

_GRAPH_CACHE: Dict[Tuple[str, int, int, str], Tuple[Any, Any, Any]] = {}


def bench_graph(name: str, max_vertices: int = 8192,
                max_feature: int = 100000):
    """Scaled dataset spec preserving |E|/|V| and feature length (capped)."""
    from repro_torch.config import GRAPHS, reduced_graph
    return reduced_graph(GRAPHS[name], max_vertices, max_feature)


def _graph_for(name: str, max_vertices: int, max_feature: int,
               device="cuda"):
    key = (name, max_vertices, max_feature, str(device))
    hit = _GRAPH_CACHE.get(key)
    if hit is None:
        from repro_torch.graph.datasets import (make_features,
                                                make_synthetic_graph)
        spec = bench_graph(name, max_vertices, max_feature)
        hit = _GRAPH_CACHE[key] = (
            spec, make_synthetic_graph(spec, device=device),
            make_features(spec, device=device))
    return hit


# ---------------------------------------------------------------------------
# BenchSpec + BenchContext + run_specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BenchSpec:
    """One declarative benchmark: graph x machine x sweep axis.

    ``measure(ctx, point)`` runs once per sweep point with a
    ``BenchContext`` and calls ``ctx.emit`` / ``ctx.time``.
    ``setup(ctx)`` (optional) runs once per spec; its result is
    ``ctx.state``.  ``dry`` is the dry-run behaviour: "run" executes
    ``measure`` with timing off, "skip" reports and skips.
    ``dry_max_vertices`` shrinks the graph under a dry run.  ``device``
    is where the graph and features are made (default the card).
    """

    name: str
    measure: Callable[["BenchContext", Any], None]
    graph: Optional[str] = None
    max_vertices: int = 8192
    max_feature: int = 100000
    machine: Machine = H100
    sweep: Tuple = (None,)
    dry: str = "skip"                       # "run" | "skip"
    dry_max_vertices: Optional[int] = None
    setup: Optional[Callable[["BenchContext"], Any]] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.dry not in ("run", "skip"):
            raise ValueError(f"dry must be 'run' or 'skip', got {self.dry!r}")


@dataclass
class BenchContext:
    """What a ``measure`` callback sees: data, machine, emit, time."""

    bench: BenchSpec
    machine: Machine
    dry: bool
    rows: List[Dict[str, Any]] = field(default_factory=list)
    spec: Any = None          # GraphSpec (None for graph-less specs)
    g: Any = None             # Graph
    x: Any = None             # features
    state: Any = None         # BenchSpec.setup result

    def emit(self, name: str, us_per_call: float, **derived
             ) -> Dict[str, Any]:
        """Record one result row (echoed to stdout, lands in the CSV)."""
        row = make_row(name, us_per_call, **derived)
        self.rows.append(row)
        print(format_row(row))
        return row

    def time(self, fn: Callable, *args, warmup: int = 2,
             iters: int = 5) -> float:
        """Median wall time (us); 0.0 without running under a dry run."""
        if self.dry:
            return 0.0
        return timeit(fn, *args, warmup=warmup, iters=iters)


def _context(spec: BenchSpec, dry: bool) -> BenchContext:
    ctx = BenchContext(bench=spec, machine=spec.machine, dry=dry)
    if spec.graph is not None:
        mv = spec.max_vertices
        if dry and spec.dry_max_vertices:
            mv = min(mv, spec.dry_max_vertices)
        ctx.spec, ctx.g, ctx.x = _graph_for(spec.graph, mv, spec.max_feature,
                                            spec.device)
    return ctx


def run_specs(specs: List[BenchSpec], dry: bool = False,
              csv=None) -> List[Dict[str, Any]]:
    """Run specs through the shared harness; returns every emitted row.

    Under ``dry=True`` only specs declaring ``dry="run"`` execute (with
    ``ctx.time`` off); the rest are reported as skipped.  ``csv`` names
    the artifact ``write_csv`` makes from the collected rows.
    """
    all_rows: List[Dict[str, Any]] = []
    for spec in specs:
        if dry and spec.dry == "skip":
            print(f"# skipped: {spec.name} (timing-only spec under dry-run)")
            continue
        ctx = _context(spec, dry)
        if spec.setup is not None:
            ctx.state = spec.setup(ctx)
        for point in spec.sweep:
            spec.measure(ctx, point)
        all_rows.extend(ctx.rows)
    if csv is not None:
        p = write_csv(all_rows, csv)
        if p is not None:
            print(f"# csv artifact: {p}")
    return all_rows
