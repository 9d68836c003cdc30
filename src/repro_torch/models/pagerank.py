"""PageRank, the paper's classic graph-processing baseline
(``repro/models/pagerank.py``).

Feature length 1 (one scalar rank per vertex): the contrast case for every
aggregation-phase observation of the paper.  Power iteration over the same
destination-sorted edge list the GCN aggregation uses, in plain PyTorch (a
gather and an ``index_add_`` per iteration), as the reference's is plain
XLA; on a card ``index_add_`` adds with float atomics, so two runs agree
within the f32 band, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.phases import aggregate_cost
from repro_torch.graph.structure import Graph


def pagerank(g: Graph, damping: float = 0.85, iters: int = 20
             ) -> torch.Tensor:
    """Power iteration: r = (1-d)/V + d * (A^T (r / outdeg) + dangling/V)
    (``pagerank``, :22).  Returns (V,) f32 on the graph's device."""
    v = g.num_vertices
    out_deg = torch.clamp(g.out_deg.float(), min=1.0)
    dangling = g.out_deg == 0
    src, dst = g.src.long(), g.dst.long()
    r = torch.full((v,), 1.0 / v, dtype=torch.float32, device=g.device)
    for _ in range(iters):
        gathered = (r / out_deg)[src]                  # feature_len == 1
        summed = torch.zeros_like(r).index_add_(0, dst, gathered)
        lost = torch.where(dangling, r, 0.0).sum()
        r = (1.0 - damping) / v + damping * (summed + lost / v)
    return r


def pagerank_cost(g: Graph, iters: int = 1) -> dict:
    """Per-iteration byte/flop accounting -- the PGR column of Fig. 2 and
    Table 3 (``pagerank_cost``, :42)."""
    c = aggregate_cost(g, feature_len=1, include_self=False)
    return {k: (v * iters if isinstance(v, (int, float)) else v)
            for k, v in c.items()}


def pagerank_reference(g: Graph, damping: float = 0.85, iters: int = 20
                       ) -> torch.Tensor:
    """Dense-matrix oracle for tests (O(V^2); small graphs only)."""
    v = g.num_vertices
    a = np.zeros((v, v), np.float64)
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    np.add.at(a, (dst, src), 1.0)
    deg = g.out_deg.cpu().numpy()
    out_deg = np.maximum(deg.astype(np.float64), 1.0)
    r = np.full(v, 1.0 / v)
    for _ in range(iters):
        contrib = r / out_deg
        dangling = r[deg == 0].sum()
        r = (1 - damping) / v + damping * (a @ contrib + dangling / v)
    return torch.from_numpy(r.astype(np.float32))
