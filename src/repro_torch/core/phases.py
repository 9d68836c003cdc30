"""Aggregation and Combination as composable phases (``repro/core/phases.py``).

  * **Aggregation** (``aggregate``, :71) -- per-vertex reduce over
    in-neighbour rows of a destination-sorted ``Graph``: sum, mean or max.
    On the ``cuda`` tier, sum and mean go through the plan-owned blocked
    layout to the ``seg_agg`` kernel (``kernels.ops.seg_agg_planned``); the
    ``torch`` tier gathers and ``index_add_``s edge chunk by edge chunk.
    Max has no kernel and runs plain PyTorch on either tier, as the
    reference runs ``segment_max`` on every tier.
  * **Combination** (``combine``, :208) -- the dense per-vertex MLP.
  * ``phase_ordered_layer`` (:247) -- one layer in an explicit or planned
    phase order, through the plan.

Only f32 is ported: ``_mm`` is the plain ``@``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.backend import CUDA, TORCH
from repro_torch.graph.structure import Graph

AGGREGATORS = ("sum", "mean", "max")

#: bytes of gathered rows one torch-tier aggregation step may hold
EDGE_CHUNK_BYTES = 1 << 28


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The combination matmul (``phases._mm``, :35), f32 only."""
    return a @ b


def _edge_chunks(num_edges: int, width: int):
    step = max(1, EDGE_CHUNK_BYTES // max(1, width * 4))
    for e0 in range(0, num_edges, step):
        yield slice(e0, min(num_edges, e0 + step))


def aggregate(g: Graph, x: torch.Tensor, op: str = "mean",
              edge_weight: Optional[torch.Tensor] = None,
              edge_mask: Optional[torch.Tensor] = None,
              include_self: bool = True,
              backend: Optional[str] = None,
              layout=None, dedup=None) -> torch.Tensor:
    """h_v = reduce_{u in N(v) (+ v)} x_u          (paper Eq. 1/2 inner term)

    Args:
      g: destination-sorted graph.
      x: (V, F) vertex features.
      op: "sum" | "mean" | "max".  mean divides by |N(v)|+1 (with
        ``include_self``), as a (V, 1) reciprocal multiply.
      edge_weight: optional (E,) per-edge scalar.
      edge_mask: optional (E,) 1/0 mask for padded edge lists.
      include_self: add the vertex's own row to the reduction.
      backend: "torch" (None means torch) or "cuda".  The ``cuda`` tier
        needs ``layout``, the plan-owned ``core.dataflow.BlockedGraph``.
      layout: see ``backend``.
      dedup: not ported; anything but None raises.
    """
    if op not in AGGREGATORS:
        raise ValueError(f"unknown aggregation {op!r}; expected {AGGREGATORS}")
    if backend not in (None, TORCH, CUDA):
        raise ValueError(f"backend must be resolved to 'torch' or 'cuda'; "
                         f"got {backend!r}")
    if dedup is not None:
        raise NotImplementedError("dedup= (two-level redundancy-eliminated "
                                  "aggregation) is not ported yet")
    v, f = x.shape
    w = edge_weight
    if edge_mask is not None:
        w = edge_mask if w is None else w * edge_mask

    if op == "max":
        out = torch.full_like(x, -torch.inf)
        for sl in _edge_chunks(g.num_edges, f):
            rows = x[g.src[sl].long()]
            if w is not None:
                rows = torch.where((w[sl] > 0)[:, None], rows, -torch.inf)
            out.index_reduce_(0, g.dst[sl].long(), rows, "amax")
        self_term = x if include_self else torch.full_like(x, -torch.inf)
        out = torch.maximum(out, self_term)
        return torch.where(torch.isfinite(out), out, 0.0)

    if backend == CUDA:
        if layout is None:
            raise ValueError("the cuda tier aggregates over a plan-owned "
                             "blocked layout; pass layout= (plans built by "
                             "build_plan / plan_for_conv / plan_for_phases "
                             "carry one in LayerPlan.agg_layout)")
        from repro_torch.kernels import ops as kops
        summed = kops.seg_agg_planned(layout, x, w, backend=CUDA)
    else:
        summed = torch.zeros_like(x)
        for sl in _edge_chunks(g.num_edges, f):
            rows = x[g.src[sl].long()]
            if w is not None:
                rows = rows * w[sl][:, None].to(rows.dtype)
            summed.index_add_(0, g.dst[sl].long(), rows)

    if include_self:
        summed = summed + x
    if op == "mean":
        denom = g.in_deg.to(summed.dtype) + (1.0 if include_self else 0.0)
        summed = summed * (1.0 / torch.clamp(denom, min=1.0))[:, None]
    return summed


def aggregate_cost(g: Graph, feature_len: int, dtype_bytes: int = 4,
                   include_self: bool = True) -> dict:
    """Analytic bytes/ops of the Aggregation phase (``aggregate_cost``,
    :184; paper Table 4): one row read per edge (+ self), one row written
    per vertex, 8 bytes of indices per edge, one add per element per edge."""
    e, v = g.num_edges, g.num_vertices
    reads = (e + (v if include_self else 0)) * feature_len * dtype_bytes
    writes = v * feature_len * dtype_bytes
    index_reads = e * 8
    flops = (e + (v if include_self else 0)) * feature_len
    return {"bytes": reads + writes + index_reads, "flops": flops,
            "gathered_rows": e, "arithmetic_intensity":
            flops / max(1, reads + writes + index_reads)}


def combine(x: torch.Tensor, weights, activation: Optional[str] = "relu",
            final_activation: bool = False) -> torch.Tensor:
    """Dense per-vertex MLP (``combine``, :208).  ``weights`` is a list of
    (W, b) tuples: one for GCN/SAGE, two for GIN (paper Table 1)."""
    h = x
    n = len(weights)
    for i, (wmat, b) in enumerate(weights):
        h = _mm(h, wmat)
        if b is not None:
            h = h + b
        if activation and (i < n - 1 or final_activation):
            h = _act(activation)(h)
    return h


def _act(name: str):
    """Activation by name (``_act``, :226)."""
    return {"relu": torch.relu,
            "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
            "tanh": torch.tanh, "none": lambda t: t}[name]


def combine_cost(num_vertices: int, dims, dtype_bytes: int = 4) -> dict:
    """Analytic GEMM cost (``combine_cost``, :231): 2*V*in*out FLOPs per
    matmul; bytes for X, W, Y."""
    flops = 0
    byt = 0
    for din, dout in zip(dims[:-1], dims[1:]):
        flops += 2 * num_vertices * din * dout
        byt += (num_vertices * din + din * dout + num_vertices * dout) \
            * dtype_bytes
    return {"bytes": byt, "flops": flops,
            "arithmetic_intensity": flops / max(1, byt)}


def phase_ordered_layer(g: Graph, x: torch.Tensor, weights, *,
                        order: Optional[str] = None, agg_op: str = "mean",
                        edge_weight=None, activation: str = "relu",
                        plan=None) -> torch.Tensor:
    """One graph-conv layer with explicit (or planned) phase ordering
    (``phase_ordered_layer``, :247; paper F2).

    ``order`` is "combine_first" (GCN/SAGE; shrinks the feature length the
    aggregation moves), "aggregate_first" (GIN semantics) or None, which
    lets the plan's cost model choose.  Dispatches through a
    ``GraphExecutionPlan`` (``plan_for_phases``, built and cached per
    graph, dims, order and aggregation when ``plan`` is not given).
    """
    if order not in ("combine_first", "aggregate_first", None):
        raise ValueError(f"unknown order {order!r}")
    if plan is None:
        from repro_torch.core.plan import plan_for_phases
        plan = plan_for_phases(g, weights, order=order, agg_op=agg_op)
    return plan.run_phases(x, weights, edge_weight=edge_weight,
                           activation=activation)
