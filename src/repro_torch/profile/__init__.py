"""repro_torch.profile: the characterization API (``repro/profile``).

  * ``Machine`` (machine.py): hardware presets (``H100``, the port's
    default; ``A100``; the paper's ``V100``; the TPU presets the
    reference prices against).
  * ``InstrumentedPlan`` / ``WorkloadReport`` (instrument.py): wrap a
    ``GraphExecutionPlan`` (``plan.instrument(machine=...)``) so one
    forward records per-layer, per-phase FLOPs / bytes / wall time into a
    typed report with ``to_json()`` / ``to_markdown()``.
  * ``BenchSpec`` / ``run_specs`` (bench.py): declarative benchmark specs
    run by one harness that owns warm-up, timing, CSV artifacts and
    dry-run validation.

One call end to end::

    report = build_plan(g, cfg, in_dim, classes).instrument().run_model(
        params, x)
    print(report.to_markdown())        # paper-style per-phase breakdown

The submodules import nothing of ``repro_torch.core`` at module scope, so
the core may import the presets from here without a cycle.
"""

from repro_torch.profile.bench import (BenchContext, BenchSpec, bench_graph,
                                       latency_percentiles, run_specs, timeit,
                                       write_csv)
from repro_torch.profile.instrument import (InstrumentedPlan, PhaseRecord,
                                            WorkloadReport,
                                            WorkloadReportError,
                                            validate_report_dict)
from repro_torch.profile.machine import (A100, H100, MACHINES, TPU_V5E,
                                         TPU_V5P, V100, Machine, get_machine)

__all__ = [
    "Machine", "TPU_V5E", "TPU_V5P", "A100", "H100", "V100", "MACHINES",
    "get_machine",
    "InstrumentedPlan", "WorkloadReport", "PhaseRecord",
    "WorkloadReportError", "validate_report_dict",
    "BenchSpec", "BenchContext", "run_specs", "timeit", "write_csv",
    "bench_graph", "latency_percentiles",
]
