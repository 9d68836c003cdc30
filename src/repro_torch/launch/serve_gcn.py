"""GCN serving launcher: ``python -m repro_torch.launch.serve_gcn [...]``.

Port of ``examples/serve_gcn.py``: builds a ``GraphServeEngine`` over a
reduced synthetic Reddit graph (seeded random weights), captures the
bucket ladder (one CUDA graph per bucket on a card), submits a wave of
node-prediction requests with mixed seed-batch sizes, drains it with
continuous batching and prints the serving stats: latency percentiles,
throughput, per-bucket hits, the zero-retrace check and the host split of
a request.  It runs on the card by default; ``--device cpu`` runs the
torch tier on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve_gcn --device cpu \\
      --requests 50 --max-batch 8
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.config import GRAPHS, reduced_graph
from repro_torch.core.backend import resolve_device
from repro_torch.graph.datasets import make_features, make_synthetic_graph
from repro_torch.models.gcn import PAPER_MODELS
from repro_torch.serve.graph_engine import GraphRequest, GraphServeEngine


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--vertices", type=int, default=512)
    ap.add_argument("--max-seeds", type=int, default=16)
    ap.add_argument("--report", action="store_true",
                    help="print the full WorkloadReport markdown")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = reduced_graph(GRAPHS["reddit"], args.vertices, 64)
    g = make_synthetic_graph(spec, device="cpu")     # sampled on the host
    x = make_features(spec, device=dev)

    engine = GraphServeEngine(g, PAPER_MODELS["gcn"], None, x,
                              spec.num_classes, fanouts=(5, 5),
                              max_batch=args.max_batch, device=dev)
    engine.params = engine.init_params(torch.Generator().manual_seed(0))
    traces = engine.warmup()
    print(f"warmup: {len(engine.buckets)} bucket(s) captured on {dev}: "
          f"{traces}")

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        seeds = rng.choice(g.num_vertices,
                           size=int(rng.integers(1, args.max_seeds + 1)),
                           replace=False)
        engine.submit(GraphRequest(rid=i, seeds=seeds))
    done = engine.run()

    s = engine.stats()
    print(f"served {s['served']} requests in {s['steps']} step(s) — "
          f"{s['throughput_rps']:.1f} req/s, p50 {s['p50_ms']:.1f} ms, "
          f"p95 {s['p95_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms")
    print(f"buckets: hits={s['bucket_hits']} misses={s['bucket_misses']} "
          f"retraces={s['retraces']} plan_cache={s['plan_cache']['size']}")
    print("host ms a request: " + ", ".join(
        f"{k} {v:.2f}" for k, v in s["host_ms"].items()))
    for b in s["buckets"]:
        print(f"  bucket s{b['num_seeds']}/v{b['num_inputs']}/"
              f"e{b['num_edges']}: {b['hits']} hit(s)")
    for r in done[:5]:
        lat = (r.finish_t - r.enqueue_t) * 1e3
        print(f"  req {r.rid}: {len(r.seeds):2d} seeds -> frontier "
              f"{r.frontier_size:3d}/{r.edge_count:3d} edges, "
              f"bucket s{r.bucket.num_seeds if r.bucket else '-'}, "
              f"latency {lat:.1f} ms")
    if args.report:
        print()
        print(engine.workload_report().to_markdown())


if __name__ == "__main__":
    main()
