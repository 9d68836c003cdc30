"""GCN / GIN / GraphSAGE models of paper Table 1 (``repro/models/gcn.py``).

``GCNModel`` is an ``nn.Module`` of ``num_layers`` convolutions whose
execution a ``GraphExecutionPlan`` owns: ``forward(g, x)`` is
``plan.run_model``.  Parameter names follow the reference's pytree
(``conv{i}.lin.{w,b}``, ``conv{i}.mlp{j}.{w,b}``), and
``params_from_reference`` loads that pytree, as nested numpy arrays, so the
port and the reference compute with the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.config import GCNModelConfig, GraphSpec
from repro_torch.core.backend import AUTO, resolve_device
from repro_torch.core.gcn_layers import CONVS
from repro_torch.core.plan import GraphExecutionPlan, build_plan
from repro_torch.graph.structure import Graph

# Paper Table 1 model configs: |h|->128 single layer (GCN/SAG);
# |h|->128->128 MLP (GIN); two convolutions each.
PAPER_MODELS: Dict[str, GCNModelConfig] = {
    "gcn": GCNModelConfig("gcn", conv="gcn", aggregator="mean",
                          hidden_dims=(128,), ordering="auto"),
    "sage": GCNModelConfig("sage", conv="sage", aggregator="mean",
                           hidden_dims=(128,), ordering="auto"),
    "gin": GCNModelConfig("gin", conv="gin", aggregator="sum",
                          hidden_dims=(128, 128), ordering="aggregate_first"),
}


class GCNModel(nn.Module):
    """``num_layers`` stacked convolutions, plan-dispatched.

    ``device`` (default ``"cuda"``, which raises without a card) is where
    the parameters live and the plans run; ``generator`` is the CPU
    ``torch.Generator`` the initial weights are drawn from.
    """

    def __init__(self, cfg: GCNModelConfig, in_dim: int, num_classes: int,
                 backend: str = AUTO, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.in_dim = in_dim
        self.num_classes = num_classes
        self.backend = backend
        self.device = resolve_device(device)
        hid = cfg.hidden_dims[0]
        conv_cls = CONVS[cfg.conv]
        d = in_dim
        for i in range(cfg.num_layers):
            dout = hid if i < cfg.num_layers - 1 else num_classes
            if cfg.conv == "gin":
                conv = conv_cls(d, dout, hidden=cfg.hidden_dims[-1],
                                backend=backend, fused=cfg.fused,
                                device=self.device, generator=generator)
            else:
                conv = conv_cls(d, dout, ordering=cfg.ordering,
                                backend=backend, fused=cfg.fused,
                                device=self.device, generator=generator)
            self.add_module(f"conv{i}", conv)
            d = dout

    def tree(self) -> Dict:
        """Parameters as the plan takes them: {"conv<i>": {...}}."""
        return {name: conv.tree() for name, conv in self.named_children()}

    def params_from_reference(self, tree: Dict) -> "GCNModel":
        """Load the reference's params pytree -- ``{"conv0": {"lin": {"w":
        ..., "b": ...}}, ...}`` with numpy leaves -- into this module, in
        place.  Raises on a missing or extra leaf or a shape mismatch."""
        mine = {name: p for name, p in self.named_parameters()}
        flat = {f"{c}.{d}.{k}": v for c, sub in tree.items()
                for d, leaf in sub.items() for k, v in leaf.items()}
        if set(flat) != set(mine):
            raise ValueError(f"parameter names differ: reference has "
                             f"{sorted(flat)}, model has {sorted(mine)}")
        with torch.no_grad():
            for name, value in flat.items():
                value = torch.from_numpy(np.array(value, np.float32))
                if tuple(value.shape) != tuple(mine[name].shape):
                    raise ValueError(f"{name}: reference shape "
                                     f"{tuple(value.shape)} != "
                                     f"{tuple(mine[name].shape)}")
                mine[name].copy_(value)
        return self

    def plan_for(self, g: Graph, **overrides) -> GraphExecutionPlan:
        """The model's execution plan over ``g`` (cached in core/plan.py)."""
        return build_plan(g, self.cfg, self.in_dim, self.num_classes,
                          backend=overrides.pop("backend", self.backend),
                          device=self.device, **overrides)

    def forward(self, g: Graph, x: torch.Tensor,
                plan: Optional[GraphExecutionPlan] = None) -> torch.Tensor:
        plan = plan or self.plan_for(g)
        return plan.run_model(self.tree(), x)

    def loss_fn(self, g: Graph, x: torch.Tensor, labels: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                plan: Optional[GraphExecutionPlan] = None) -> torch.Tensor:
        """Mean negative log-likelihood of ``labels`` (masked mean when
        ``mask`` is given)."""
        logits = self(g, x, plan=plan)
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, labels.long()[:, None])[:, 0]
        if mask is not None:
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return nll.mean()

    def layer_costs(self, g: Graph, layer: int = 0) -> Dict:
        """Analytic per-phase costs of one planned layer over ``g`` (paper
        Tables 3/4; ``layer_costs``, :86)."""
        return self.plan_for(g).layer_costs(layer)


def make_paper_model(name: str, spec: GraphSpec, backend: str = AUTO, *,
                     device="cuda", generator: Optional[torch.Generator] = None,
                     **overrides) -> GCNModel:
    """A ``PAPER_MODELS`` model sized for ``spec``; ``overrides`` replace
    config fields (e.g. ``fused=True``)."""
    cfg = PAPER_MODELS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return GCNModel(cfg, in_dim=spec.feature_len,
                    num_classes=spec.num_classes, backend=backend,
                    device=device, generator=generator)
