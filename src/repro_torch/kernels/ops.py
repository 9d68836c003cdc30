"""Blocked-layout glue and the tier switch (``repro/kernels/ops.py``).

``seg_agg_planned`` (:115) and ``fused_agg_combine`` (:167) take a
plan-owned ``core.dataflow.BlockedGraph``; ``flash_attention`` (:217) takes
(B, H, S, D) heads.  All dispatch by tier: ``torch`` runs the kernels'
plain versions on any device, ``cuda`` launches the CUDA kernels and
raises for tensors that are not on a CUDA device.  The planned entries
gather no edge rows here: both kernels gather ``x`` themselves, and they
walk any ``emax``, so the reference's ``tile_e`` padding has no
counterpart.

``seg_agg`` (:58) and ``seg_agg_pregrouped`` (:103) take rows already
gathered: the slow path for one-off calls on graphs no plan laid out.
They hand the rows to the ``seg_agg`` kernel as its ``x`` with the slots'
sources ``arange``: ``seg_agg`` regroups the edges into blocks on the host
on every call, ``seg_agg_pregrouped`` takes them blocked.

On the ``cuda`` tier every entry reaches K1 through its autograd Function
(``kernels.seg_agg.SegAgg``), so a gradient flows through the kernel: its
backward is K1 over the layout's transposed twin (over a capped one, K1
over the pieces and, when a row was cut, over the fold-back).  The
``torch`` tier's plain versions are differentiable as they stand.
``seg_agg_transposed`` runs that backward fold alone, for callers that
drive their own backward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.backend import CUDA, TORCH, require_device
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import fused_agg_combine as k2
from repro_torch.kernels import seg_agg as k1


def _check_tier(backend: str, x: torch.Tensor) -> None:
    if backend not in (TORCH, CUDA):
        raise ValueError(f"kernel tier must be resolved to 'torch' or "
                         f"'cuda'; got {backend!r}")
    require_device(backend, x.device)


#: ONE remediation text shared by the ``seg_agg`` ValueError under a trace
#: or a capture and the ``host-in-trace`` source rule
#: (``repro_torch.analysis.ast_lint``), so the error a user hits and the
#: finding a reviewer reads agree verbatim on the fix: route through the
#: capture-safe planned entry points (``SEG_AGG_REMEDIATION``, :38).
SEG_AGG_REMEDIATION = (
    "seg_agg regroups edges on the host and cannot run inside a fake-tensor "
    "trace or a CUDA-graph capture; dispatch the capture-safe "
    "seg_agg_planned instead -- via a plan from build_plan, plan_for_conv, "
    "or plan_for_phases (each owns a blocked layout), or call "
    "seg_agg_planned directly with a core.dataflow.block_graph layout")


def _tracing(*tensors) -> bool:
    """True under a fake-tensor trace (a fake tensor argument or an active
    ``FakeTensorMode``) or while the current CUDA stream is capturing."""
    from torch._guards import detect_fake_mode
    if detect_fake_mode(tensors) is not None:
        return True
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def launch_counts() -> dict:
    """Launches so far of each kernel wrapper, by kernel name.  The counts
    are Python-side: a CUDA graph's replay moves none of them.
    ``seg_agg`` and ``fused_agg_combine`` count every launch; the bf16
    entries count those with a bf16 output among them,
    ``seg_agg_bf16_f32`` K1's launches over bf16 x with an f32 output (a
    distributed layer's halo partials), ``seg_agg_bwd``
    K1's backward launches (``SegAgg.backward``) among them (for
    ``fused_agg_combine_bf16`` the f32-rows, bf16-W pair too, which
    ``fused_agg_combine_mixed`` counts on its own)."""
    return {"seg_agg": k1.seg_agg.launches,
            "seg_agg_bf16": k1.seg_agg.launches_bf16,
            "seg_agg_bf16_f32": k1.seg_agg.launches_bf16_f32,
            "seg_agg_bwd": k1.seg_agg.launches_bwd,
            "fused_agg_combine": k2.fused_agg_combine.launches,
            "fused_agg_combine_bf16": k2.fused_agg_combine.launches_bf16,
            "fused_agg_combine_mixed": k2.fused_agg_combine.launches_mixed,
            "flash_attention": k5.flash_attention.launches,
            "flash_attention_bwd": k5.flash_attention_bwd.launches}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    k1.seg_agg.launches = k1.seg_agg.launches_bf16 = 0
    k1.seg_agg.launches_bf16_f32 = 0
    k1.seg_agg.launches_bwd = 0
    k2.fused_agg_combine.launches = k2.fused_agg_combine.launches_bf16 = 0
    k2.fused_agg_combine.launches_mixed = 0
    k5.flash_attention.launches = 0
    k5.flash_attention_bwd.launches = 0


def seg_agg(rows: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
            tile_m: int = 128, *, backend: str) -> torch.Tensor:
    """``segment_sum(rows, seg_ids)`` over pre-gathered rows -- the SLOW
    path for one-off calls (``seg_agg``, :58).  ``seg_ids`` must be sorted
    (destination-sorted edges).  Regroups the edges into blocks of
    ``tile_m`` rows on the host on every call (a device-to-host copy of
    ``seg_ids``), so it cannot run under a CUDA-graph capture; plans
    regroup once and call ``seg_agg_planned``.  Returns
    ``(num_segments, F)`` in ``rows.dtype``.  Under a fake-tensor trace or
    a CUDA-graph capture it raises ``ValueError(SEG_AGG_REMEDIATION)``
    before it touches the host (:82)."""
    from repro_torch.core.dataflow import block_graph_arrays
    _check_tier(backend, rows)
    if _tracing(rows, seg_ids):
        raise ValueError(SEG_AGG_REMEDIATION)
    # the documented host path -- the guard above is the contract
    seg = seg_ids.cpu().numpy()  # analysis: allow(host-in-trace)
    if len(seg) and not (np.diff(seg) >= 0).all():
        raise ValueError("seg_agg: seg_ids must be sorted (regroup the "
                         "edges by destination first)")
    bg = block_graph_arrays(np.arange(len(seg), dtype=np.int64), seg,
                            num_segments, tile_m, device=rows.device)
    fn = k1.seg_agg_plain if backend == TORCH else k1.seg_agg
    return fn(rows, bg.src, bg.dstl, bg.mask, None,
              tile_m=tile_m)[:num_segments]


def seg_agg_pregrouped(rows_blocked: torch.Tensor, seg_local: torch.Tensor,
                       mask: torch.Tensor, tile_m: int, *,
                       backend: str) -> torch.Tensor:
    """The kernel's entry for rows already grouped by destination block
    (``seg_agg_pregrouped``, :103): rows (nblocks, emax, F), seg_local and
    mask (nblocks, emax).  Each block's valid slots are moved first and
    sorted by row on the device (stable, so each row keeps its slot
    order), the order the kernel folds in.  Returns
    ``(nblocks * tile_m, F)`` in ``rows_blocked.dtype``."""
    _check_tier(backend, rows_blocked)
    nblocks, emax, f = rows_blocked.shape
    dev = rows_blocked.device
    mask = mask.to(torch.float32)
    seg_local = seg_local.to(torch.int32)
    key = torch.where(mask != 0, seg_local, tile_m)
    order = torch.sort(key, dim=1, stable=True).indices
    src = (torch.arange(nblocks, device=dev)[:, None] * emax
           + order).to(torch.int32)
    dstl = torch.gather(seg_local, 1, order).contiguous()
    mask = torch.gather(mask, 1, order).contiguous()
    fn = k1.seg_agg_plain if backend == TORCH else k1.seg_agg
    return fn(rows_blocked.reshape(nblocks * emax, f).contiguous(),
              src.contiguous(), dstl, mask, None, tile_m=tile_m)


def seg_agg_planned(bg, x: torch.Tensor,
                    edge_weight: Optional[torch.Tensor] = None, *,
                    backend: str,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Segmented sum over a plan-owned blocked layout.

    x: (R, F), where R is V or, for a dedup plan's level-2 layout, the
    V + P rows of ``[x ; partials]``; ``edge_weight``: optional (E,)
    per-edge scalar, regrouped into the blocked layout through ``bg.eidx``
    (one gather).  Returns (V, F) in x's dtype: ``sum_{(u,v) in E} w_uv *
    x_u`` per destination v; ``out_dtype`` (default x's) may be f32 for
    bf16 x (the f32 sums unrounded).  On the cuda tier the backward runs
    over ``bg.transposed`` (built from ``bg`` in the backward when None).
    """
    _check_tier(backend, x)
    weight = None
    if edge_weight is not None:
        if bg.eidx is None:
            raise ValueError("BlockedGraph built without eidx cannot "
                             "regroup edge weights; rebuild via block_graph")
        weight = edge_weight.to(torch.float32)[bg.eidx.long()]
    if backend == TORCH:
        out = k1.seg_agg_plain(x, bg.src, bg.dstl, bg.mask, weight,
                               tile_m=bg.tile_m, out_dtype=out_dtype)
    else:
        out = k1.seg_agg(x, bg.src, bg.dstl, bg.mask, weight,
                         tile_m=bg.tile_m, transposed=bg.transposed,
                         out_dtype=out_dtype)
    return out[:bg.num_vertices]


def seg_agg_transposed(t, g: torch.Tensor, *, backend: str) -> torch.Tensor:
    """K1's backward fold over a transposed layout ``t`` on its own:
    ``(rows, F)``, the sums ``sum_{slots e of row u} g[src[e]]`` of the
    rows ``t`` lays out.  A capped layout stores its uncut rows in place
    and folds its cut rows back from their pieces (one launch, or two
    when a row was cut, on the cuda tier: ``kernels.seg_agg.
    fold_transposed``; the same folds and row maps in plain PyTorch on the
    torch tier), so the result is f32; an uncapped one gives g's dtype.
    The distributed halos' backward (``core.distributed``) folds each
    transposed shard sub-layout through here."""
    _check_tier(backend, g)
    out = k1.fold_transposed(g, t, plain=backend == TORCH)
    return out[:t.num_vertices]


def fused_agg_combine(src: torch.Tensor, dst_local: torch.Tensor,
                      mask: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
                      tile_m: int, backend: str) -> torch.Tensor:
    """Fused segmented sum + ``@ w`` per destination block.

    src/dst_local/mask: (nblocks, emax) BlockedGraph layout; x: (V, F_in)
    (``src`` may index past V: a dedup plan gathers from ``[x ;
    partials]``); w: (F_in, F_out).  Returns (nblocks * tile_m, F_out) in
    ``w.dtype``.
    """
    _check_tier(backend, x)
    fn = k2.fused_agg_combine_plain if backend == TORCH \
        else k2.fused_agg_combine
    return fn(x, src, dst_local, mask, w, tile_m=tile_m)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, backend: str) -> torch.Tensor:
    """Online-softmax attention, q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D).
    Returns (B, Hq, Sq, D) in q's dtype.  The ``cuda`` tier is K5's op,
    differentiable through K5's backward kernels; the ``torch`` tier's
    plain version is differentiable as it stands."""
    _check_tier(backend, q)
    if backend == TORCH:
        return k5.flash_attention_plain(q, k, v, kv_len, causal=causal,
                                        window=window, softcap=softcap)
    return k5.flash_attention(q, k, v, kv_len, causal=causal, window=window,
                              softcap=softcap)
