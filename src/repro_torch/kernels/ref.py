"""Plain-torch oracles for the kernels (``repro/kernels/ref.py``, :16, :26,
:34).

Each function is the mathematical definition, unblocked and untiled: the
kernels' plain versions and the CUDA kernels are held against these.
"""

from __future__ import annotations

from typing import Optional

import torch


def seg_agg_ref(rows: torch.Tensor, seg_ids: torch.Tensor, mask: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segmented row sum: out[s] = sum_{e: seg_ids[e]==s} rows[e] * mask[e].

    rows: (E, F); seg_ids: (E,) int in [0, num_segments); mask: (E,).
    """
    w = rows * mask[:, None].to(rows.dtype)
    out = torch.zeros((num_segments, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, seg_ids.long(), w)


def fused_agg_combine_ref(rows: torch.Tensor, seg_ids: torch.Tensor,
                          mask: torch.Tensor, w: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """out[s] = (sum_{e in seg s} rows[e]) @ w -- aggregation fused into GEMM."""
    return seg_agg_ref(rows, seg_ids, mask, num_segments).to(w.dtype) @ w


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, sliding_window: int = 0,
            logit_softcap: float = 0.0, scale: Optional[float] = None,
            kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0 (GQA).
    ``kv_len``: optional (B,) valid KV length (decode with padded cache).
    Positions: query i sits at absolute position kv_len - Sq + i
    (decode-style right alignment), matching the serving cache layout.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kq = k.repeat_interleave(group, dim=1)
    vq = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float()) * scale
    if logit_softcap > 0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    kv_len = kv_len.to(q.device).long()
    qpos = torch.arange(sq, device=q.device)[None, :] + (kv_len[:, None] - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[:, None, :] <= qpos[:, :, None]
    if sliding_window > 0:
        mask &= kpos[:, None, :] > qpos[:, :, None] - sliding_window
    mask &= (kpos < kv_len[:, None])[:, None, :]
    logits = torch.where(mask[:, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vq.float())
    return out.to(q.dtype)
