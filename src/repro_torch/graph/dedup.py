"""GraphACT-style pair-redundancy elimination (``repro/graph/dedup.py``).

Many destinations share the same pair of in-neighbours, so ``x[a] + x[b]``
is added once per sharing destination.  ``build_dedup_layout`` finds those
pairs on the host and emits a two-level aggregation layout:

  * **Level 1**: each matched pair's partial sum, once:
    ``partials = x[pair_left] + x[pair_right]`` (P rows).
  * **Level 2**: a shortened edge list over ``[x ; partials]`` (V + P
    rows): each matched destination's two pair edges become ONE edge to
    its partial; the other edges pass through.

Only a destination's LEADING pair (its first two edges in dst-sorted
order) is a candidate, and a pair is kept when at least ``min_frequency``
destinations share it.  Every fold of this package adds a destination's
edges in order from 0, so the naive ``((0 + a) + b) + rest`` and the dedup
``(0 + (a + b)) + rest`` are the same IEEE operations (``0 + x == x``,
and addition commutes, so the canonical ``(min, max)`` key is safe): an
f32 dedup plan equals the naive plan bit for bit wherever the fold is in
order: the CPU's ``index_add_``, and the cuda tier's kernels on rows of at
most T slots (``kernels.seg_agg.split_threshold(emax)``, at least 256).  K1
folds a longer row as chunks whose sums it adds in order, cut where its
fold units start, and a dedup layout shortens the row by one slot, which
moves the cuts, so no split rule keeps the contract there; every forward
row of the paper's graphs is shorter.

The layout is built once at plan time (O(E) numpy); its arrays are int32
tensors on the plan's device.  ``attach_blocked`` blocks the level-2 list
for the kernels, and ``pad_dedup_arrays`` pads a block's arrays to a
bucket's static shapes with sink no-ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backend import resolve_device

DEDUP_MODES = ("none", "pairs", "auto")


class DedupLayout(NamedTuple):
    """Two-level aggregation layout over a destination-sorted edge list
    (``DedupLayout``, :54).

    ``src2`` values in ``[0, num_vertices)`` are feature rows, values in
    ``[num_vertices, num_vertices + num_pairs)`` pair partials; ``dst2``
    is non-decreasing, and within a matched destination the pair edge
    comes first.  ``blocked`` is the level-2 ``BlockedGraph`` for the
    kernels (``attach_blocked``), None until attached.
    """

    pair_left: torch.Tensor     # (P,) int32 first member of each pair
    pair_right: torch.Tensor    # (P,) int32 second member (left <= right)
    src2: torch.Tensor          # (E2,) int32 into [x ; partials]
    dst2: torch.Tensor          # (E2,) int32 destination, non-decreasing
    num_pairs: int
    num_edges2: int
    matched_edges: int          # original edges covered by matched pairs
    naive_edges: int            # original |E|
    num_vertices: int
    blocked: Optional[object] = None   # core.dataflow.BlockedGraph

    @property
    def edges_removed(self) -> int:
        """Edges the level-2 list no longer carries (= matched dsts)."""
        return self.naive_edges - self.num_edges2

    def flops_saved(self, feature_len: int) -> float:
        """Adds eliminated per call: removed edge-adds minus the P
        pair-partial adds of level 1, times the feature length."""
        return float((self.edges_removed - self.num_pairs) * feature_len)


def _i32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def build_dedup_layout(src, dst, num_vertices: int, *,
                       min_frequency: int = 2,
                       device="cuda") -> DedupLayout:
    """Greedy leading-pair matching over a dst-sorted edge list, on the
    host (``build_dedup_layout``, :91).  ``src``/``dst`` are numpy arrays
    or tensors; the layout's arrays land on ``device``.  A list with no
    shared pair gives ``num_pairs == 0``."""
    dev = resolve_device(device)
    s = np.asarray(src.cpu() if isinstance(src, torch.Tensor) else src,
                   np.int64)
    d = np.asarray(dst.cpu() if isinstance(dst, torch.Tensor) else dst,
                   np.int64)
    if s.shape != d.shape or s.ndim != 1:
        raise ValueError(f"src and dst must be 1-D of one length; got "
                         f"{s.shape} and {d.shape}")
    e = len(s)
    if e and not (np.diff(d) >= 0).all():
        raise ValueError("the edge list must be sorted by destination")
    deg = np.bincount(d, minlength=num_vertices)
    starts = np.zeros(num_vertices, np.int64)
    np.cumsum(deg[:-1], out=starts[1:])

    cand = np.where(deg >= 2)[0]                 # dsts owning a leading pair
    if len(cand) == 0:
        empty = _i32(np.zeros(0), dev)
        return DedupLayout(
            pair_left=empty, pair_right=empty.clone(), src2=_i32(s, dev),
            dst2=_i32(d, dev), num_pairs=0, num_edges2=e, matched_edges=0,
            naive_edges=e, num_vertices=int(num_vertices))
    a = s[starts[cand]]
    b = s[starts[cand] + 1]
    keys = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)
    uniq, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                                  return_counts=True)
    inv = inv.reshape(-1)
    kept = counts >= min_frequency
    num_pairs = int(kept.sum())
    pid_of_uniq = np.full(len(uniq), -1, np.int64)
    pid_of_uniq[kept] = np.arange(num_pairs)
    pid = pid_of_uniq[inv]                       # per candidate; -1 unmatched
    matched = pid >= 0
    matched_dsts = cand[matched]

    # the first edge of a matched dst becomes its pair edge (the prefix
    # slot that keeps the in-order fold exact), the second is dropped
    s2 = s.copy()
    s2[starts[matched_dsts]] = num_vertices + pid[matched]
    drop = np.zeros(e, bool)
    drop[starts[matched_dsts] + 1] = True
    src2, dst2 = s2[~drop], d[~drop]
    return DedupLayout(
        pair_left=_i32(uniq[kept, 0], dev),
        pair_right=_i32(uniq[kept, 1], dev),
        src2=_i32(src2, dev), dst2=_i32(dst2, dev),
        num_pairs=num_pairs, num_edges2=int(len(src2)),
        matched_edges=int(2 * len(matched_dsts)), naive_edges=e,
        num_vertices=int(num_vertices), blocked=None)


def dedup_layout_for_graph(g, *, min_frequency: int = 2) -> DedupLayout:
    """``build_dedup_layout`` over a ``Graph``'s edge arrays, on its
    device."""
    return build_dedup_layout(g.src, g.dst, g.num_vertices,
                              min_frequency=min_frequency, device=g.device)


def attach_blocked(layout: DedupLayout, tile_m: int) -> DedupLayout:
    """Block the level-2 edge list for the kernels, at plan time
    (``attach_blocked``, :157).  Its sources index the (V + P)-row
    ``[x ; partials]``; its output rows stay the V destinations."""
    from repro_torch.core.dataflow import block_graph_arrays
    bg = block_graph_arrays(layout.src2.cpu().numpy(),
                            layout.dst2.cpu().numpy(), layout.num_vertices,
                            tile_m, device=layout.src2.device)
    return layout._replace(blocked=bg)


def dedup_cost(layout: DedupLayout, feature_len: int, dtype_bytes: int = 4,
               include_self: bool = True) -> dict:
    """Analytic cost of the two-level aggregation (``dedup_cost``, :172),
    the twin of ``phases.aggregate_cost``: P pair adds + E2 level-2 adds
    (+ V self adds); one row gathered per level-2 edge and per pair member,
    P partials and V outputs written, both levels' indices read."""
    p, e2, v = layout.num_pairs, layout.num_edges2, layout.num_vertices
    v_self = v if include_self else 0
    flops = (p + e2 + v_self) * feature_len
    reads = (e2 + 2 * p + v_self) * feature_len * dtype_bytes
    writes = (v + p) * feature_len * dtype_bytes
    index_reads = e2 * 8 + 2 * p * 4
    byt = reads + writes + index_reads
    return {"bytes": byt, "flops": flops, "gathered_rows": e2 + 2 * p,
            "pairs": p, "flops_saved": layout.flops_saved(feature_len),
            "arithmetic_intensity": flops / max(1, byt)}


def pad_dedup_arrays(layout: DedupLayout, num_pairs: int, num_edges2: int,
                     sink: int) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]:
    """Pad a block's dedup arrays to a bucket's static shapes, on the host
    (``pad_dedup_arrays``, :196).  Pad pairs are ``(sink, sink)`` and pad
    level-2 edges sink self-loops after the real ones, so with an all-zero
    sink row every real destination sees its real fold.  Returns numpy
    ``(pair_left, pair_right, src2, dst2)``."""
    if layout.num_pairs > num_pairs or layout.num_edges2 > num_edges2:
        raise ValueError(f"bucket of {num_pairs} pairs / {num_edges2} edges "
                         f"is too small for {layout.num_pairs} / "
                         f"{layout.num_edges2}")
    pad_p = num_pairs - layout.num_pairs
    pad_e = num_edges2 - layout.num_edges2

    def cat(t, n):
        return np.concatenate([t.cpu().numpy().astype(np.int32),
                               np.full(n, sink, np.int32)])
    return (cat(layout.pair_left, pad_p), cat(layout.pair_right, pad_p),
            cat(layout.src2, pad_e), cat(layout.dst2, pad_e))
