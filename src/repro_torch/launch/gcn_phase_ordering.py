"""Paper Table 4 launcher: ``python -m repro_torch.launch.gcn_phase_ordering``.

Port of ``examples/gcn_phase_ordering.py``: phase ordering on synthetic
Reddit, 602 -> 128, driven by the ``GraphExecutionPlan``, in the paper's
four views:

  1. the analytic bytes and operations of both orderings (the paper's
     accounting, ``reduction_ratios``);
  2. the planner's own decision for this graph and layer (F2 as code);
  3. combine-first and aggregate-first timed as planner scenarios (CUDA
     events on a card, the host clock on the CPU);
  4. the fused aggregate->combine plan (guideline 5.1-3; K2 on a card)
     with its error against the unfused plan.

It runs on the card by default at the example's 8,192-vertex cut;
``--vertices 0`` takes the whole graph (V = 232,965, E = 11,606,919),
``--device cpu`` runs the torch tier on the CPU, and ``--vertices`` and
``--iters`` cut the run short:

  PYTHONPATH=src python -m repro_torch.launch.gcn_phase_ordering \\
      --device cpu --vertices 1024 --iters 1
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.config import REDDIT, reduced_graph
from repro_torch.core.backend import resolve_device
from repro_torch.core.plan import plan_for_phases
from repro_torch.core.scheduler import reduction_ratios
from repro_torch.graph.datasets import make_features, make_synthetic_graph

IN_LEN, OUT_LEN = 602, 128
#: the paper's Table 4 on Reddit: data-access and computation reductions
#: (analytic) and the measured speedup of combine-first
PAPER = {"data": 4.75, "ops": 4.72, "speedup": 4.76}


def bench_ms(fn, x, iters: int = 5) -> float:
    """Milliseconds a call of ``fn(x)``, over ``iters`` calls after one
    warm-up: CUDA events on a card, the host clock on the CPU."""
    fn(x)
    if x.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    return (time.perf_counter() - t0) / iters * 1e3


def phase_ordering(g, x: torch.Tensor, iters: int = 5) -> Dict:
    """The four views over graph ``g`` and features ``x`` (602 columns);
    prints them and returns their numbers."""
    w = torch.randn((IN_LEN, OUT_LEN), generator=torch.Generator()
                    .manual_seed(0)).to(x.device) * 0.05
    weights = [(w, None)]
    print(f"graph: |V|={g.num_vertices:,} |E|={g.num_edges:,} "
          f"features {IN_LEN} -> {OUT_LEN}")

    r = reduction_ratios(g, IN_LEN, OUT_LEN)
    print("\n1. analytic (paper Table 4 accounting)")
    print(f"   aggregation bytes  Agg->Com: "
          f"{r['aggregate_first'].agg_bytes:,}")
    print(f"   aggregation bytes  Com->Agg: "
          f"{r['combine_first'].agg_bytes:,}")
    print(f"   reduction: {r['data_access_reduction']:.2f}x data, "
          f"{r['computation_reduction']:.2f}x ops "
          f"(paper: {PAPER['data']}x, {PAPER['ops']}x)")

    auto = plan_for_phases(g, weights, order=None, agg_op="mean")
    d = auto.describe()[0]
    print(f"\n2. planner decision: order={d['order']} backend={d['backend']} "
          f"interpret={d['interpret']}")

    plans = {o: plan_for_phases(g, weights, order=o, agg_op="mean")
             for o in ("combine_first", "aggregate_first")}

    def run(plan):
        return lambda xx: plan.run_phases(xx, weights, activation="none")
    with torch.no_grad():
        cf, af = run(plans["combine_first"]), run(plans["aggregate_first"])
        t_cf, t_af = bench_ms(cf, x, iters), bench_ms(af, x, iters)
        print(f"\n3. measured: Com->Agg {t_cf:.3f} ms | Agg->Com "
              f"{t_af:.3f} ms | speedup {t_af / t_cf:.2f}x (paper: "
              f"{PAPER['speedup']}x)")
        fused_plan = plan_for_phases(g, weights, order="combine_first",
                                     agg_op="mean", fused=True)
        fused = run(fused_plan)
        t_fused = bench_ms(fused, x, iters)
        unfused = cf(x)
        got = fused(x)
        err = float((got - unfused).abs().max())
        scale = float(unfused.abs().max())
    print(f"\n4. fused inter-phase dataflow "
          f"(tile_m={fused_plan.layers[0].tile_m}): {t_fused:.3f} ms "
          f"(err vs unfused {err:.1e})")
    return {"ratios": r, "decision": d, "combine_first_ms": t_cf,
            "aggregate_first_ms": t_af, "speedup": t_af / t_cf,
            "fused_ms": t_fused, "fused_err": err, "unfused_scale": scale,
            "fused_backend": fused_plan.layers[0].backend}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=8192,
                    help="vertices of the reduced graph (0: all of Reddit)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed calls of each plan")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = REDDIT if args.vertices <= 0 else reduced_graph(
        REDDIT, max_vertices=args.vertices, max_feature=IN_LEN)
    g = make_synthetic_graph(spec, device=dev)
    x = make_features(spec, device=dev)
    return phase_ordering(g, x, args.iters)


if __name__ == "__main__":
    main()
