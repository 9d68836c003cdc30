"""Graph-convolution layers of paper Table 1 as ``nn.Module``s
(``repro/core/gcn_layers.py``).

  * GCNConv  -- mean({N(v)} ∪ {v}) ∘ Linear(|h|->d)      [combine-first legal]
  * SAGEConv -- same propagation rule as GCN (paper §2)   [combine-first legal]
  * GINConv  -- MLP(sum({N(v)} ∪ {v})), MLP = |h|->d->d   [aggregate-first only]

Parameters keep the reference's pytree names: ``lin.{w,b}`` for GCN/SAGE,
``mlp1.{w,b}`` and ``mlp2.{w,b}`` for GIN.  Execution dispatches through a
``GraphExecutionPlan`` (core/plan.py), which takes the parameters as the
nested dict ``tree()`` returns.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core.backend import AUTO, resolve_device
from repro_torch.core.scheduler import (AGGREGATE_FIRST, COMBINE_FIRST,
                                        choose_ordering)
from repro_torch.graph.structure import Graph
from repro_torch.profile.machine import get_machine


class Dense(nn.Module):
    """One affine layer, ``x @ w + b`` (the reference's ``_dense_init``
    leaf): ``w`` ~ N(0, 2/din) drawn from ``generator`` on the CPU, ``b``
    zeros."""

    def __init__(self, din: int, dout: int, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        scale = (2.0 / din) ** 0.5
        w = torch.randn((din, dout), generator=generator) * scale
        self.w = nn.Parameter(w.to(device))
        self.b = nn.Parameter(torch.zeros((dout,), device=device))

    def tree(self) -> Dict[str, torch.Tensor]:
        return {"w": self.w, "b": self.b}


class _Conv(nn.Module):
    """Shared plumbing: the param tree and plan dispatch."""

    def tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Parameters as the plan takes them (the reference's pytree)."""
        return {name: child.tree() for name, child in self.named_children()}

    def forward(self, g: Graph, x: torch.Tensor, *, plan=None):
        if plan is None:
            from repro_torch.core.plan import plan_for_conv
            plan = plan_for_conv(self, g)
        return plan.run_layer(self.tree(), x)


class GCNConv(_Conv):
    """Paper Eq. 1 with mean aggregation over {N(v)} ∪ {v}."""

    def __init__(self, din: int, dout: int, ordering: str = "auto",
                 backend: str = AUTO, fused: bool = False, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.din, self.dout = din, dout
        self.ordering = ordering
        self.backend = backend
        self.fused = fused
        self.lin = Dense(din, dout, device=resolve_device(device),
                         generator=generator)

    def resolve_order(self, g: Graph, machine=None) -> str:
        if self.ordering in (COMBINE_FIRST, AGGREGATE_FIRST):
            return self.ordering
        return choose_ordering(g, self.din, self.dout, agg_op="mean",
                               n_mlp_layers=1, semantic_order=COMBINE_FIRST,
                               machine=get_machine(machine))


class SAGEConv(GCNConv):
    """GraphSAGE-mean: identical per-layer rule (paper §2)."""


class GINConv(_Conv):
    """GIN-0 (paper Eq. 2): MLP(sum over {N(v)} ∪ {v}); the MLP's interior
    ReLU pins the ordering to aggregate_first.  Fusion covers the
    aggregation and the FIRST matmul."""

    def __init__(self, din: int, dout: int, hidden: Optional[int] = None,
                 backend: str = AUTO, fused: bool = False, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.din, self.dout = din, dout
        self.hidden = hidden or dout
        self.backend = backend
        self.fused = fused
        self.ordering = AGGREGATE_FIRST
        dev = resolve_device(device)
        self.mlp1 = Dense(din, self.hidden, device=dev, generator=generator)
        self.mlp2 = Dense(self.hidden, dout, device=dev, generator=generator)

    def resolve_order(self, g: Graph, machine=None) -> str:
        return AGGREGATE_FIRST


CONVS = {"gcn": GCNConv, "sage": SAGEConv, "gin": GINConv}
