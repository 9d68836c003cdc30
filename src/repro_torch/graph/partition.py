"""1-D and 2-D graph partitions for distributed aggregation
(``repro/graph/partition.py``).

**1-D (node)**: each shard owns a contiguous block of destination vertices
(all edges whose dst falls in the block).  ``partition_1d(...,
edge_balanced=True)`` picks the boundaries so every shard carries about
|E|/P edges (the analytic load model); ``edge_balanced=False`` gives the
uniform blocks the distributed layers execute over
(``core.distributed._require_uniform``).

**2-D (node x feature)**: a P-way uniform node partition crossed with a
Q-way split of the feature columns (``partition_2d``): shard (p, q) owns
node block p's rows restricted to feature block q, so the halo along the
node axis moves rows F/Q wide.

The partition is built with numpy on the host and its arrays are placed on
an explicit device, padded to one static shape ``(P, emax)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.graph.structure import Graph


class PartitionedGraph(NamedTuple):
    """Stacked per-shard edge lists, padded (``PartitionedGraph``, :33).

    src:        (P, emax) int32 global source ids.
    dst_local:  (P, emax) int32 destination id LOCAL to the shard's block.
    mask:       (P, emax) f32, 1 for a real edge, 0 for padding.
    vtx_start:  (P,) int32 first global vertex id of each shard's block.
    block_size: vertices per shard (padded), a Python int.
    num_vertices: the real global vertex count.
    """

    src: torch.Tensor
    dst_local: torch.Tensor
    mask: torch.Tensor
    vtx_start: torch.Tensor
    block_size: int
    num_vertices: int

    @property
    def num_shards(self) -> int:
        return int(self.src.shape[0])

    def shard_edges(self, p: int) -> tuple[np.ndarray, np.ndarray]:
        """Shard ``p``'s real edges as host arrays ``(src, dst_local)``,
        sorted by ``dst_local`` (the global destination order)."""
        n = int(self.mask[p].sum().item())
        return (self.src[p, :n].cpu().numpy().astype(np.int64),
                self.dst_local[p, :n].cpu().numpy().astype(np.int64))


def partition_1d(g: Graph, num_shards: int, edge_balanced: bool = True, *,
                 device=None) -> PartitionedGraph:
    """1-D destination-vertex partition of ``g`` into ``num_shards`` blocks
    (``partition_1d``, :56), on ``device`` (default the graph's).

    ``edge_balanced=True`` picks block boundaries equalizing edge counts,
    each range within the shard's ``block`` capacity; ``False`` gives the
    uniform layout (``bounds[p] = p * block``).  ``emax`` is the largest
    shard's edge count (at least 1) rounded up to 8, as in the reference.
    """
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()  # already sorted by dst
    v = g.num_vertices
    block = -(-v // num_shards)  # every shard owns `block` vertex slots

    if edge_balanced:
        row_ptr = g.row_ptr.cpu().numpy() if g.row_ptr is not None else \
            np.concatenate([[0], np.cumsum(g.in_deg.cpu().numpy())])
        target = len(src) / num_shards
        bounds = [0]
        for p in range(1, num_shards):
            ideal = int(np.searchsorted(row_ptr, target * p))
            lo = bounds[-1] + 1
            hi = min(v, bounds[-1] + block)
            bounds.append(int(np.clip(ideal, lo, hi)))
        bounds.append(v)
    else:
        bounds = [min(v, p * block) for p in range(num_shards)] + [v]

    # dst is sorted, so each shard's edges are one contiguous range
    cuts = np.searchsorted(dst, bounds)
    per = [(cuts[p], cuts[p + 1]) for p in range(num_shards)]
    emax = max(1, max(b - a for a, b in per))
    emax = -(-emax // 8) * 8

    ps = np.zeros((num_shards, emax), np.int32)
    pd = np.zeros((num_shards, emax), np.int32)
    pm = np.zeros((num_shards, emax), np.float32)
    for p, (a, b) in enumerate(per):
        ps[p, :b - a] = src[a:b]
        pd[p, :b - a] = dst[a:b] - bounds[p]
        pm[p, :b - a] = 1.0
    starts = np.array(bounds[:num_shards], np.int32)
    dev = g.device if device is None else torch.device(device)
    return PartitionedGraph(
        src=torch.from_numpy(ps).to(dev),
        dst_local=torch.from_numpy(pd).to(dev),
        mask=torch.from_numpy(pm).to(dev),
        vtx_start=torch.from_numpy(starts).to(dev), block_size=block,
        num_vertices=v)


def edge_balance(pg: PartitionedGraph) -> float:
    """max/mean edge load across shards (1.0 = perfect; ``edge_balance``,
    :109)."""
    loads = pg.mask.cpu().numpy().sum(axis=1)
    return float(loads.max() / max(loads.mean(), 1e-9))


class Partition2D(NamedTuple):
    """2-D (node x feature) partition: P node shards x Q feature shards
    (``Partition2D``, :115).  The graph is partitioned along the node axis
    only (``nodes``, a uniform ``PartitionedGraph``); the feature axis is a
    columnwise split whose block depends on each layer's feature length
    (``feature_block``)."""

    nodes: PartitionedGraph
    feat_shards: int

    @property
    def node_shards(self) -> int:
        return self.nodes.num_shards

    @property
    def block_size(self) -> int:
        """Vertex rows per node shard (padded)."""
        return self.nodes.block_size

    @property
    def num_vertices(self) -> int:
        return self.nodes.num_vertices

    def feature_block(self, feature_len: int) -> int:
        """Columns per feature shard for one layer's feature length
        (ceil-divided; callers zero-pad to ``feat_shards * feature_block``)."""
        return -(-int(feature_len) // self.feat_shards)


def partition_2d(g: Graph, node_shards: int, feat_shards: int, *,
                 device: Optional[torch.device] = None) -> Partition2D:
    """Partition ``g`` for a (node_shards x feat_shards) mesh
    (``partition_2d``, :146): the uniform 1-D partition along the node axis;
    the feature axis needs no host structure beyond its cardinality."""
    if node_shards < 1 or feat_shards < 1:
        raise ValueError(f"need positive shard counts, got "
                         f"{node_shards}x{feat_shards}")
    return Partition2D(nodes=partition_1d(g, node_shards,
                                          edge_balanced=False, device=device),
                       feat_shards=feat_shards)
