"""Aggregation and Combination as composable phases (``repro/core/phases.py``).

  * **Aggregation** (``aggregate``, :71) -- per-vertex reduce over
    in-neighbour rows of a destination-sorted ``Graph``: sum, mean or max.
    On the ``cuda`` tier, sum and mean go through the plan-owned blocked
    layout to the ``seg_agg`` kernel (``kernels.ops.seg_agg_planned``), or,
    on a graph no plan laid out, through the slow host-regrouping
    ``kernels.ops.seg_agg``; the ``torch`` tier gathers and
    ``index_add_``s edge chunk by edge chunk.  Max has no kernel and runs
    plain PyTorch on either tier, as the reference runs ``segment_max`` on
    every tier.  With a ``graph.dedup.DedupLayout`` sum and mean run
    two-level (pair partials, then the shortened edge list).  Both tiers
    are differentiable in ``x``: the cuda tier's sums run through K1's
    autograd Function (``kernels.seg_agg.SegAgg``, whose backward is K1
    over the transposed layout), the torch tier's through
    ``index_add_``; the mean's reciprocal stays outside the kernel
    (``_finish``), so autograd scales it.
  * **Combination** (``combine``, :208) -- the dense per-vertex MLP.
  * ``phase_ordered_layer`` (:247) -- one layer in an explicit or planned
    phase order, through the plan.

Reduced precision: bf16 operands are stored in bf16 and accumulated in
f32 -- ``_mm`` returns the f32 accumulator, the torch tier's aggregation
upcasts the gathered rows, the ``seg_agg`` kernel folds in f32 and rounds
once.  ``quantize_int8`` is the int8-agg plans' fake quantization.  Every
cast is guarded, so f32 operands take the f32 path unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.backend import CUDA, TORCH
from repro_torch.graph.structure import Graph

AGGREGATORS = ("sum", "mean", "max")

#: bytes of gathered rows one torch-tier aggregation step may hold
EDGE_CHUNK_BYTES = 1 << 28


class _MmF32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)`` of two bf16 operands with a
    backward, which that call lacks: each operand's gradient is the f32
    product of the f32 output gradient with the other operand upcast
    (exact), rounded once to bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] \
            else None
        gb = (a.float().t() @ g).to(b.dtype) if ctx.needs_input_grad[1] \
            else None
        return ga, gb


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The combination matmul (``phases._mm``, :35).  f32 x f32 is the
    plain ``@``; any reduced operand gives the f32 accumulator: on a card
    a bf16 x bf16 product runs ``torch.mm(..., out_dtype=float32)``
    (through ``_MmF32`` when a gradient is wanted), elsewhere (and for a
    mixed pair) both operands are upcast, which is exact -- a bf16 x bf16
    product fits an f32 mantissa."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MmF32.apply(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int8 fake quantization of an aggregation operand
    (``quantize_int8``, :48): each row scaled by ``max|row| / 127`` (a zero
    row by 1), rounded half to even onto the int8 grid, and returned
    dequantized in f32."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
    return q * scale


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
      backend: "torch" (None means torch) or "cuda".
      layout: the plan-owned ``core.dataflow.BlockedGraph`` the ``cuda``
        tier aggregates over; without one the cuda tier regroups the edges
        on the host on every call (``kernels.ops.seg_agg``, the slow path
        for graphs no plan laid out).
      dedup: a plan-owned ``graph.dedup.DedupLayout``.  For sum and mean
        without edge weights, aggregation runs two-level: the pair
        partials once (in f32), then the shortened edge list over
        ``[x ; partials]``, through the ``seg_agg`` kernel on the cuda
        tier (over ``dedup.blocked``, or regrouped on the host per call
        when the layout has no blocking attached).  In f32 the result equals the naive fold bit for bit wherever the
        fold runs in edge order.
    """
    if op not in AGGREGATORS:
        raise ValueError(f"unknown aggregation {op!r}; expected {AGGREGATORS}")
    if backend not in (None, TORCH, CUDA):
        raise ValueError(f"backend must be resolved to 'torch' or 'cuda'; "
                         f"got {backend!r}")
    if dedup is not None and not hasattr(dedup, "pair_left"):
        raise TypeError(f"dedup must be a graph.dedup.DedupLayout or None; "
                        f"got {type(dedup).__name__}")
    v, f = x.shape
    w = edge_weight
    if edge_mask is not None:
        w = edge_mask if w is None else w * edge_mask

    if dedup is not None and dedup.num_pairs > 0 and op in ("sum", "mean") \
            and w is None:
        return _finish(g, _dedup_sum(dedup, x, backend), x, op, include_self)

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
        from repro_torch.kernels import ops as kops
        if layout is not None:
            summed = kops.seg_agg_planned(layout, x, w, backend=CUDA)
        else:
            rows = x[g.src.long()]
            if w is not None:
                rows = rows * w[:, None].to(rows.dtype)
            summed = kops.seg_agg(rows, g.dst, v, backend=CUDA)
    else:
        summed = _segment_sum(x, g.src, g.dst, v, w)
    return _finish(g, summed, x, op, include_self)


def _segment_sum(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 v: int, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum_e w_e x[src_e]`` into row ``dst_e``, gathered and
    ``index_add_``ed edge chunk by edge chunk.  Reduced rows are upcast
    after the gather (and after the weight, applied in x's dtype, as XLA's
    branch does): the sum is f32 (``aggregate``, :151-160)."""
    f = x.shape[1]
    summed = torch.zeros((v, f), dtype=torch.float32, device=x.device)
    for sl in _edge_chunks(int(src.shape[0]), f):
        rows = x[src[sl].long()]
        if w is not None:
            rows = rows * w[sl][:, None].to(rows.dtype)
        if rows.dtype != torch.float32:
            rows = rows.float()
        summed.index_add_(0, dst[sl].long(), rows)
    return summed


def _dedup_sum(dedup, x: torch.Tensor, backend) -> torch.Tensor:
    """The two-level sum (``aggregate``, :118-136): x cast to f32 first
    (exact), each matched pair's partial added once, then the level-2
    edges over ``[x ; partials]`` -- on the cuda tier the ``seg_agg``
    kernel, over ``dedup.blocked`` or, for a layout no plan blocked,
    through the host-regrouping ``kernels.ops.seg_agg``; ``_segment_sum``
    on the torch tier."""
    xf = x if x.dtype == torch.float32 else x.float()
    partials = xf[dedup.pair_left.long()] + xf[dedup.pair_right.long()]
    xp = torch.cat([xf, partials], dim=0)
    if backend == CUDA:
        from repro_torch.kernels import ops as kops
        if dedup.blocked is not None:
            return kops.seg_agg_planned(dedup.blocked, xp, None,
                                        backend=CUDA)
        return kops.seg_agg(xp[dedup.src2.long()], dedup.dst2, x.shape[0],
                            backend=CUDA)
    return _segment_sum(xp, dedup.src2, dedup.dst2, x.shape[0])


def _finish(g: Graph, summed: torch.Tensor, x: torch.Tensor, op: str,
            include_self: bool) -> torch.Tensor:
    """The self term and the mean's (V, 1) reciprocal multiply, in the
    dtype the sum and x promote to."""
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
