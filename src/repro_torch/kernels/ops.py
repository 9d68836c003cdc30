"""Blocked-layout glue and the tier switch (``repro/kernels/ops.py``).

``seg_agg_planned`` (:115) and ``fused_agg_combine`` (:167) take a
plan-owned ``core.dataflow.BlockedGraph``; ``flash_attention`` (:217) takes
(B, H, S, D) heads.  All three dispatch by tier: ``torch``
runs the kernels' plain versions on any device, ``cuda`` launches the CUDA
kernels and raises for tensors that are not on a CUDA device.  No edge rows
are gathered here: both kernels gather ``x`` themselves, and they walk any
``emax``, so the reference's ``tile_e`` padding has no counterpart.
"""

from __future__ import annotations

from typing import Optional

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


def launch_counts() -> dict:
    """Launches so far of each kernel wrapper, by kernel name.  The counts
    are Python-side: a CUDA graph's replay moves none of them."""
    return {"seg_agg": k1.seg_agg.launches,
            "fused_agg_combine": k2.fused_agg_combine.launches,
            "flash_attention": k5.flash_attention.launches}


def seg_agg_planned(bg, x: torch.Tensor,
                    edge_weight: Optional[torch.Tensor] = None, *,
                    backend: str) -> torch.Tensor:
    """Segmented sum over a plan-owned blocked layout.

    x: (V, F); ``edge_weight``: optional (E,) per-edge scalar, regrouped
    into the blocked layout through ``bg.eidx`` (one gather).  Returns
    (V, F): ``sum_{(u,v) in E} w_uv * x_u`` per destination v.
    """
    _check_tier(backend, x)
    weight = None
    if edge_weight is not None:
        if bg.eidx is None:
            raise ValueError("BlockedGraph built without eidx cannot "
                             "regroup edge weights; rebuild via block_graph")
        weight = edge_weight.to(torch.float32)[bg.eidx.long()]
    fn = k1.seg_agg_plain if backend == TORCH else k1.seg_agg
    out = fn(x, bg.src, bg.dstl, bg.mask, weight, tile_m=bg.tile_m)
    return out[:bg.num_vertices]


def fused_agg_combine(src: torch.Tensor, dst_local: torch.Tensor,
                      mask: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
                      tile_m: int, backend: str) -> torch.Tensor:
    """Fused segmented sum + ``@ w`` per destination block.

    src/dst_local/mask: (nblocks, emax) BlockedGraph layout; x: (V, F_in);
    w: (F_in, F_out).  Returns (nblocks * tile_m, F_out).
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
    Returns (B, Hq, Sq, D) in q's dtype."""
    _check_tier(backend, q)
    fn = k5.flash_attention_plain if backend == TORCH else k5.flash_attention
    return fn(q, k, v, kv_len, causal=causal, window=window, softcap=softcap)
