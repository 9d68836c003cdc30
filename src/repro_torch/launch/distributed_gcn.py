"""Distributed GCN launcher:
``python -m repro_torch.launch.distributed_gcn [...]``.

Inference (the default): builds a GCN plan over a ``LocalMesh`` -- every
shard held by this process on one device -- with the 1-D vertex partition
(``--mesh 8``) or the 2-D node x feature partition (``--mesh 4x2``),
prints each layer's phase order, halo bytes (the cut-edge model,
``core.distributed.halo_bytes``) and wire bytes (the schedule,
``schedule_wire_bytes``, beside what the mesh counted), then the logits'
largest difference from the local plan's.  Seeded random weights on a
reduced synthetic Cora (``--dataset``, ``--vertices``, ``--features``).

``--train`` is ``examples/distributed_gcn.py``: cora cut to 512
vertices and 64 features, x boosted by 4 one-hot(label), GCN 64 -> 16 ->
7 over 8 ring shards, ``STEPS`` (30) SGD steps at ``LR`` (0.25) on the
mean NLL, the gradients through ``make_compressed_allreduce`` (int8
error feedback), the loss every 5 steps and the final accuracy; then the
trained params' forward on a 2-D (4, 2) mesh beside the 1-D logits.  As
the reference jits ``value_and_grad`` of the loss, the logits come from
``plan.compile()`` under autograd: on a card the forward and the
backward are CUDA graphs, the loss's ``log_softmax`` and NLL, the int8
all-reduce and the update run eagerly.

It runs on the card by default; ``--device cpu`` runs the torch tier on
the CPU:

  PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --device cpu \\
      --mesh 4x2 --strategy ring --overlap pipelined
  PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --device cpu \\
      --train
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.config import CORA, GRAPHS, reduced_graph
from repro_torch.core.backend import resolve_device
from repro_torch.core.distributed import (LocalMesh, halo_bytes,
                                          halo_bytes_2d, schedule_wire_bytes)
from repro_torch.graph.datasets import (make_features, make_labels,
                                        make_synthetic_graph)
from repro_torch.models.gcn import PAPER_MODELS, GCNModel
from repro_torch.optim.compression import (compression_wire_bytes,
                                           init_residuals,
                                           make_compressed_allreduce)
from repro_torch.optim.optimizer import tree_map

#: the example's SGD steps and learning rate
STEPS = 30
LR = 0.25


def example_data(device, vertices: int = 512, features: int = 64):
    """The example's data: (spec, graph, x, labels), cora reduced to
    ``vertices`` and ``features``, x boosted by 4 one-hot(label) in its
    first ``num_classes`` columns."""
    spec = reduced_graph(CORA, vertices, features)
    g = make_synthetic_graph(spec, device=device)
    x = make_features(spec, device=device)
    y = make_labels(spec, device=device)
    x[:, :spec.num_classes] += 4.0 * torch.nn.functional.one_hot(
        y, spec.num_classes).to(x.dtype)
    return spec, g, x, y


def train(model: GCNModel, plan, g, x, y, *, steps: int, lr: float,
          allreduce, every: int = 5) -> list:
    """``steps`` SGD steps of ``model`` through ``plan.compile()`` on the
    mean NLL, each gradient tree through ``allreduce`` (``fn(grads,
    residuals) -> (grads, residuals)``, the residuals kept here); updates
    the model in place, prints the loss every ``every`` steps and returns
    every step's loss (before its update)."""
    params = model.tree()
    leaves = [t for sub in params.values() for leaf in sub.values()
              for t in leaf.values()]
    residuals = init_residuals(params)
    losses = []
    for step in range(steps):
        logits = plan.run_model(params, x, compiled=True)
        loss = -torch.log_softmax(logits, dim=-1).gather(
            -1, y.long()[:, None])[:, 0].mean()
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        grads = tree_map(lambda t: grads[id(t)], params)
        grads, residuals = allreduce(grads, residuals)
        with torch.no_grad():
            tree_map(lambda p, gr: p.sub_(lr * gr), params, grads)
        losses.append(float(loss.detach()))
        if step % every == 0:
            print(f" step {step:2d}  loss {losses[-1]:.4f}")
    return losses


def run_train(args, dev) -> None:
    """The example's training run (``--train``)."""
    spec, g, x, y = example_data(dev, args.vertices, args.features)
    shape = tuple(int(n) for n in args.mesh.split("x"))
    if len(shape) != 1:
        raise SystemExit("--train runs on a 1-D mesh (--mesh P)")
    mesh = LocalMesh(shape, ("data",), device=dev)
    cfg = dataclasses.replace(PAPER_MODELS["gcn"],
                              hidden_dims=(args.hidden,))
    model = GCNModel(cfg, spec.feature_len, spec.num_classes, device=dev,
                     generator=torch.Generator().manual_seed(0))
    plan = model.plan_for(g, mesh=mesh, strategy=args.strategy,
                          overlap=args.overlap, dtype=args.dtype)
    pg = plan.partition
    hb_in = halo_bytes(pg, spec.feature_len)["min_halo_bytes"]
    hb_out = halo_bytes(pg, args.hidden)["min_halo_bytes"]
    print(f"partition: {pg.num_shards} shards x {pg.block_size} vertices, "
          f"halo {hb_in:,} B (agg-first) vs {hb_out:,} B (combine-first) "
          f"-> {hb_in / max(hb_out, 1):.1f}x collective saving")
    for d in plan.describe():
        print(f"  layer{d['layer']}: {d['din']}->{d['dout']} "
              f"order={d['order']} (planned)")
    wire = compression_wire_bytes(
        sum(p.numel() for p in model.parameters()), dp=pg.num_shards)
    print(f"grad wire bytes/step: fp32 {wire['fp32_bytes']:,.0f} -> "
          f"int8+EF {wire['int8_ef_bytes']:,.0f} "
          f"({wire['reduction_vs_fp32']:.0f}x)")
    train(model, plan, g, x, y, steps=STEPS, lr=LR,
          allreduce=make_compressed_allreduce(mesh, "data"))
    with torch.no_grad():
        logits = model(g, x, plan=plan)
        acc = float((logits.argmax(-1) == y).float().mean())
        print(f"final accuracy {acc:.3f} (chance "
              f"{1 / spec.num_classes:.3f})")
        mesh2 = LocalMesh((4, 2), ("node", "feat"), device=dev)
        plan2 = model.plan_for(g, mesh=mesh2, strategy=args.strategy,
                               dtype=args.dtype)
        logits2 = model(g, x, plan=plan2)
    hb1 = halo_bytes(pg, args.hidden)["min_halo_bytes"]
    hb2 = halo_bytes_2d(plan2.partition, args.hidden)["min_halo_bytes"]
    print(f"2-D partition {plan2.partition_kind}: 4 node x 2 feat shards, "
          f"per-device halo {hb2:,} B vs {hb1:,} B 1-D (columns ride "
          f"{plan2.partition.feature_block(args.hidden)} wide)")
    drift = (logits2.float() - logits.float()).abs().max().item()
    print(f"2-D forward matches 1-D-trained logits (max |diff| "
          f"{drift:.2e})")


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
    ap.add_argument("--train", action="store_true",
                    help="the example's int8 error-feedback training run")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.train:
        run_train(args, dev)
        return
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
