"""Degree-aware access scheduling as a vertex renumbering
(``repro/graph/reorder.py``; paper §5.1 guideline 1, F4).

Aggregation's cache hit ratio collapses because feature rows are long, so
the cache holds few of them and reuse distance explodes.  The guideline:
touch the highly reused (high-degree) vertices close together.  Here that
is a renumbering applied once, on the host:

  1. ``degree_reorder`` -- renumber vertices by descending degree, so the
     hottest source rows cluster at the front of the feature matrix.
  2. Edges stay destination-sorted (the kernels' fold order), and within a
     destination sources keep their stable order.

``reuse_distance_stats`` measures the effect as LRU hit ratios of the
gather stream; ``choose_reorder`` prices it against a ``Machine``'s
on-chip rows (``build_plan(reorder="auto")``).  Host numpy throughout; the
renumbered ``Graph`` lands on the input graph's device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.graph.structure import Graph, graph_from_coo


def degree_reorder(g: Graph) -> Tuple[Graph, np.ndarray]:
    """Renumber vertices by descending ``out_deg + in_deg``
    (``degree_reorder``, :34).

    Returns (reordered graph, perm) with ``perm[old_id] = new_id``:
    ``x_new[perm] = x_old``, i.e. ``x_new = x_old[inv]``.
    """
    deg = g.out_deg.cpu().numpy().astype(np.int64) + \
        g.in_deg.cpu().numpy().astype(np.int64)
    order = np.argsort(-deg, kind="stable")  # old ids in new order
    perm = np.empty_like(order)
    perm[order] = np.arange(len(order))
    src = perm[g.src.cpu().numpy()]
    dst = perm[g.dst.cpu().numpy()]
    return graph_from_coo(src, dst, g.num_vertices, device=g.device), perm


def apply_vertex_perm(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Permute rows so row old-i lands at new position ``perm[i]``."""
    out = np.empty_like(x)
    out[perm] = x
    return out


def reuse_distance_stats(access_stream: np.ndarray,
                         budgets: Tuple[int, ...] = (64, 256, 1024, 4096),
                         ) -> Dict[str, float]:
    """LRU stack-distance analysis of a vertex access stream
    (``reuse_distance_stats``, :57).

    For each budget B (feature rows a cache level holds), the hit ratio of
    a fully associative LRU cache of B rows over ``access_stream`` (the
    gather's source ids in edge order), with the cold-miss fraction and the
    mean reuse distance.  O(N log N): Bennett-Kruskal over a Fenwick tree.
    """
    stream = np.asarray(access_stream, dtype=np.int64)
    n = len(stream)
    last_pos: Dict[int, int] = {}
    bit = np.zeros(n + 2, dtype=np.int64)  # Fenwick tree over positions

    def bit_add(i: int, v: int):
        i += 1
        while i < len(bit):
            bit[i] += v
            i += i & (-i)

    def bit_sum(i: int) -> int:  # prefix sum over [0, i]
        i += 1
        s = 0
        while i > 0:
            s += bit[i]
            i -= i & (-i)
        return int(s)

    distances = np.empty(n, dtype=np.int64)
    for t, v in enumerate(stream):
        v = int(v)
        if v in last_pos:
            p = last_pos[v]
            # distinct elements touched in (p, t) = stack distance
            distances[t] = bit_sum(t - 1) - bit_sum(p)
            bit_add(p, -1)
        else:
            distances[t] = -1  # cold miss
        bit_add(t, 1)
        last_pos[v] = t

    out: Dict[str, float] = {}
    reuses = distances >= 0
    out["cold_miss_frac"] = float((~reuses).mean()) if n else 0.0
    out["mean_reuse_distance"] = (
        float(distances[reuses].mean()) if reuses.any() else float("inf"))
    for b in budgets:
        hits = (distances >= 0) & (distances < b)
        out[f"hit_ratio@{b}"] = float(hits.mean()) if n else 0.0
    return out


def choose_reorder(g: Graph, g_reordered: Graph, perm: np.ndarray,
                   feature_len: int, machine, threshold: float = 0.02,
                   max_stream: int = 20000) -> str:
    """"degree" or "none" from reuse-distance stats (``choose_reorder``,
    :115).

    The budget is the rows of ``feature_len`` floats that
    ``machine.on_chip_bytes`` holds; "degree" wins when it raises the LRU
    hit ratio of the gather stream by more than ``threshold``.  Both
    orderings are measured on the same edges: the whole stream up to
    ``max_stream`` edges, beyond that one seeded uniform sample of
    ``max_stream`` edges, each traversed in its graph's own (dst-sorted)
    order.
    """
    rows = max(1, int(machine.on_chip_bytes) // max(4 * feature_len, 4))
    src = g.src.cpu().numpy()
    e = len(src)
    if e <= max_stream:
        base_stream = src
        re_stream = g_reordered.src.cpu().numpy()
    else:
        perm = np.asarray(perm)
        sel = np.zeros(e, bool)
        sel[np.random.default_rng(0).choice(e, max_stream,
                                            replace=False)] = True
        base_stream = src[sel]
        # the same edges at their positions in the reordered execution
        # order (edges re-sort by new destination id, stably)
        order2 = np.argsort(perm[g.dst.cpu().numpy()], kind="stable")
        re_stream = perm[src][order2][sel[order2]]
    base = reuse_distance_stats(base_stream, budgets=(rows,))
    re = reuse_distance_stats(re_stream, budgets=(rows,))
    gain = re[f"hit_ratio@{rows}"] - base[f"hit_ratio@{rows}"]
    return "degree" if gain > threshold else "none"


def atomic_collision_model(dst: np.ndarray, feature_len: int,
                           warp: int = 32) -> Dict[str, float]:
    """Paper Fig. 2(f): atomic transactions per request under a warp model
    (``atomic_collision_model``).  With F >= warp, lanes update different
    elements of one row and never collide; with short rows the lanes of a
    warp cover ``warp / F`` destinations and collide where they repeat.
    The kernels here fold sorted segments and use no atomics."""
    dst = np.asarray(dst)
    if feature_len >= warp:
        row_collisions = 1.0
    else:
        per_warp = max(1, warp // max(1, feature_len))
        n = (len(dst) // per_warp) * per_warp
        groups = dst[:n].reshape(-1, per_warp)
        txn = []
        for gr in groups[: min(len(groups), 4096)]:
            _, counts = np.unique(gr, return_counts=True)
            txn.append(counts.mean())
        row_collisions = float(np.mean(txn)) if txn else 1.0
    return {"atomic_txn_per_request": row_collisions}
