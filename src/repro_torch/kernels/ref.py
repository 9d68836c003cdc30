"""Plain-torch oracles for the kernels (``repro/kernels/ref.py``, :16, :26).

Each function is the mathematical definition, unblocked and untiled: the
kernels' plain versions and the CUDA kernels are held against these.
"""

from __future__ import annotations

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
