"""Serving-latency percentiles: ``latency_percentiles``, the port's copy of
``repro/profile/bench.py:60``.  The rest of the reference's benchmark
helpers time JAX calls and are not ported."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


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
