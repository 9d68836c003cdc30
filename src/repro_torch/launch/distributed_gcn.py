"""Distributed GCN inference launcher:
``python -m repro_torch.launch.distributed_gcn [...]``.

The forward half of ``examples/distributed_gcn.py``: builds a GCN plan
over a ``LocalMesh`` -- every shard held by this process on one device --
with the 1-D vertex partition (``--mesh 8``) or the 2-D node x feature
partition (``--mesh 4x2``), prints each layer's phase order, halo bytes
(the cut-edge model, ``core.distributed.halo_bytes``) and wire bytes (the
schedule, ``schedule_wire_bytes``, beside what the mesh counted), then the
logits' largest difference from the local plan's.  Seeded random weights
on a reduced synthetic Cora (``--dataset``, ``--vertices``,
``--features``).  It runs on the card by default; ``--device cpu`` runs
the torch tier on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --device cpu \\
      --mesh 4x2 --strategy ring --overlap pipelined
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.config import GRAPHS, reduced_graph
from repro_torch.core.backend import resolve_device
from repro_torch.core.distributed import (LocalMesh, halo_bytes,
                                          halo_bytes_2d, schedule_wire_bytes)
from repro_torch.graph.datasets import make_features, make_synthetic_graph
from repro_torch.models.gcn import PAPER_MODELS, GCNModel


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora", choices=sorted(GRAPHS))
    ap.add_argument("--vertices", type=int, default=512)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--mesh", default="8",
                    help="P (1-D, axis 'data') or PxQ (2-D, 'node' x 'feat')")
    ap.add_argument("--strategy", default="ring",
                    choices=["ring", "allgather"])
    ap.add_argument("--overlap", default="none",
                    choices=["none", "pipelined", "auto"])
    ap.add_argument("--dtype", default="f32",
                    choices=["f32", "bf16", "int8-agg"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = reduced_graph(GRAPHS[args.dataset], args.vertices, args.features)
    g = make_synthetic_graph(spec, device=dev)
    x = make_features(spec, device=dev)
    shape = tuple(int(n) for n in args.mesh.split("x"))
    names = ("data",) if len(shape) == 1 else ("node", "feat")
    mesh = LocalMesh(shape, names, device=dev)

    cfg = dataclasses.replace(PAPER_MODELS["gcn"],
                              hidden_dims=(args.hidden,))
    model = GCNModel(cfg, spec.feature_len, spec.num_classes, device=dev,
                     generator=torch.Generator().manual_seed(0))
    plan = model.plan_for(g, mesh=mesh, strategy=args.strategy,
                          overlap=args.overlap, dtype=args.dtype)
    two_d = plan.partition_kind == "2d"
    pg = plan.partition.nodes if two_d else plan.partition
    print(f"mesh {mesh}: {plan.partition_kind} partition, "
          f"{pg.num_shards} node shards x {pg.block_size} vertices, "
          f"strategy {plan.strategy}, overlap {plan.overlap}, dtype "
          f"{plan.dtype}, tier {plan.layers[0].backend}")
    for lp in plan.layers:
        width = lp.din if lp.order == "aggregate_first" else lp.dout
        hb = (halo_bytes_2d(plan.partition, width) if two_d
              else halo_bytes(pg, width))["min_halo_bytes"]
        wire = schedule_wire_bytes(
            plan.partition, width, strategy=plan.strategy,
            overlap=plan.overlap, dtype=plan.dtype,
            combine_out_len=lp.dout if two_d else None)["total_bytes"]
        cols = plan.partition.feature_block(width) if two_d else width
        print(f"  layer{lp.index}: {lp.din}->{lp.dout} order={lp.order}: "
              f"halo {hb:,} B (cut edges x {cols} f32), wire {wire:,} B "
              f"a shard")

    mesh.reset_counts()
    with torch.no_grad():
        out = model(g, x, plan=plan)
        counted = mesh.collective_bytes()
        local = model(g, x, plan=model.plan_for(g, dtype=args.dtype))
    moved = ", ".join(f"{k} {v:,}" for k, v in counted.items()
                      if k not in ("total", "counts") and v)
    print(f"collectives counted a shard: {counted['total']:,} B ({moved})")
    print(f"logits {tuple(out.shape)}; largest difference from the local "
          f"plan: {(out.float() - local.float()).abs().max().item():.3e}")


if __name__ == "__main__":
    main()
