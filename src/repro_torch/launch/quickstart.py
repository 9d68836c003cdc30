"""Quickstart launcher: ``python -m repro_torch.launch.quickstart [...]``.

Port of ``examples/quickstart.py``, the paper's workload end to end on a
reduced synthetic Cora: a 2-layer GCN under the phase-ordering scheduler
in ``auto`` mode, the per-phase characterization of its first layer
(paper Tables 3/4: ``layer_costs`` and ``reduction_ratios``), the
instrumented ``WorkloadReport`` priced on the paper's V100, the compiled
forward held bit for bit against the report's output, 120 SGD steps --
each loss's forward and gradients through ``plan.compile()`` under
autograd (on a card a forward and a backward CUDA graph) -- and the final
accuracy.  It runs on the card by default; ``--device cpu`` runs the
torch tier on the CPU, and ``--steps`` cuts the training short:

  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu \\
      --steps 20
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.config import CORA, reduced_graph
from repro_torch.core.backend import resolve_device
from repro_torch.core.plan import _leaves, build_plan
from repro_torch.core.scheduler import reduction_ratios
from repro_torch.graph.datasets import (make_features, make_labels,
                                        make_synthetic_graph)
from repro_torch.models.gcn import make_paper_model
from repro_torch.profile import V100

#: the example's training run: SGD steps and rate, and the steps between
#: printed losses
STEPS, LR, EVERY = 120, 0.2, 20


def quickstart(device="cuda", steps: int = STEPS) -> Dict:
    """The example's run on ``device``; prints as it goes and returns the
    characterization, the report, the compiled-forward check, the losses
    and the accuracy."""
    dev = resolve_device(device)
    spec = reduced_graph(CORA, max_vertices=1024, max_feature=256)
    g = make_synthetic_graph(spec, device=dev)
    x = make_features(spec, device=dev)
    y = make_labels(spec, device=dev)
    # plant a learnable signal (synthetic labels are otherwise random)
    x[:, :spec.num_classes] += 4.0 * torch.nn.functional.one_hot(
        y, spec.num_classes).to(x.dtype)

    model = make_paper_model("gcn", spec, device=dev,
                             generator=torch.Generator().manual_seed(0))

    print("== phase characterization (first conv layer) ==")
    costs = model.layer_costs(g)
    print(f" chosen ordering : {costs['order']}")
    print(f" aggregation     : {costs['aggregation']['bytes']:,} bytes, "
          f"AI={costs['aggregation']['arithmetic_intensity']:.3f}")
    print(f" combination     : {costs['combination']['bytes']:,} bytes, "
          f"AI={costs['combination']['arithmetic_intensity']:.1f}")
    r = reduction_ratios(g, spec.feature_len, 128)
    print(f" ordering wins   : {r['data_access_reduction']:.2f}x fewer "
          f"aggregation bytes (paper Table 4: 4.75x on Reddit)")

    print("\n== instrumented workload report (paper's V100) ==")
    plan = build_plan(g, model.cfg, spec.feature_len, spec.num_classes,
                      device=dev)
    report = plan.instrument(machine=V100).run_model(model.tree(), x,
                                                     compiled=True)
    print(report.to_markdown())

    # the production path: ONE compiled callable, bit for bit eager
    fwd = plan.compile()
    with torch.no_grad():
        same = torch.equal(fwd(model.tree(), x), report.output)
    # the example's one check, after the forward, outside any capture
    # analysis: allow(tracer-branch)
    if not same:
        raise RuntimeError("plan.compile()'s forward differs from the "
                           "report's eager output")

    print("\n== training ==")
    leaves = [t for _, t in _leaves(model.tree())]
    losses = []
    for step in range(steps):
        logits = fwd(model.tree(), x)
        loss = -torch.log_softmax(logits, dim=-1).gather(
            -1, y[:, None])[:, 0].mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, gr in zip(leaves, grads):
                p.copy_(p - LR * gr)
        losses.append(float(loss.detach()))
        if step % EVERY == 0:
            print(f" step {step:3d}  loss {losses[-1]:.4f}")

    with torch.no_grad():
        logits = model(g, x)
    acc = float((logits.argmax(-1) == y).float().mean())
    print(f"\nfinal accuracy: {acc:.3f} "
          f"(chance {1 / spec.num_classes:.3f})")
    return {"spec": spec, "costs": costs, "ratios": r, "report": report,
            "compiled_equal": same, "losses": losses, "accuracy": acc,
            "traces": fwd.num_traces}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="SGD steps (the example's 120)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return quickstart(args.device, args.steps)


if __name__ == "__main__":
    main()
