"""Shape buckets and the union block of GCN node-prediction serving
(``repro/serve/graph_engine.py``, :62-170): ``Bucket``,
``default_buckets``, ``_index_of`` and ``union_two_hop``, which the
minibatch trainer (``models/sage_minibatch.py``) pads its blocks with.
``GraphServeEngine`` itself is not ported yet (ROADMAP item 10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graph.sampling import SampledBlock
from repro_torch.graph.structure import Graph, graph_from_coo


class Bucket(NamedTuple):
    """One shape bucket; every field is a static dimension (``Bucket``,
    :62): seeds per request, padded frontier rows, padded union edges."""

    num_seeds: int
    num_inputs: int
    num_edges: int

    def fits(self, seeds: int, inputs: int, edges: int) -> bool:
        """True iff a block of these real sizes pads into this bucket.
        Pad edges are sink self-loops on the last row, so when any edge
        padding is needed the frontier must leave that row free."""
        if seeds > self.num_seeds or edges > self.num_edges:
            return False
        limit = self.num_inputs if edges == self.num_edges \
            else self.num_inputs - 1
        return inputs <= limit


def default_buckets(fanouts: Tuple[int, int],
                    seed_levels: Sequence[int] = (4, 16, 64),
                    max_inputs: Optional[int] = None) -> Tuple[Bucket, ...]:
    """The worst-case bucket ladder of ``two_hop_batch`` sampling
    (``default_buckets``, :89): per seed level s, hop-1 inputs
    ``s (1 + f1)``, union frontier ``s (1 + f1)(1 + f2)`` (capped at
    ``max_inputs``) plus one sink row, union edges
    ``s f1 + s (1 + f1) f2``."""
    f1, f2 = int(fanouts[0]), int(fanouts[1])
    out = []
    for s in sorted(int(v) for v in seed_levels):
        n1 = s * (1 + f1)
        frontier = n1 * (1 + f2)
        if max_inputs is not None:
            frontier = min(frontier, int(max_inputs))
        out.append(Bucket(num_seeds=s, num_inputs=frontier + 1,
                          num_edges=s * f1 + n1 * f2))
    return tuple(out)


def _index_of(haystack: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """Positions of ``needles`` inside the sorted unique ``haystack``
    (``_index_of``, :140); raises when one is missing."""
    haystack = np.asarray(haystack)
    needles = np.asarray(needles)
    pos = np.searchsorted(haystack, needles)
    if not (pos < len(haystack)).all() or \
            not (haystack[np.minimum(pos, len(haystack) - 1)]
                 == needles).all():
        raise ValueError("the frontier must cover the needles")
    return pos.astype(np.int32)


def union_two_hop(hop2: SampledBlock, hop1: SampledBlock,
                  seeds: np.ndarray, *, device="cuda"
                  ) -> Tuple[np.ndarray, Graph, np.ndarray]:
    """Merge a (hop2, hop1) sampled pair into one union block
    (``union_two_hop``, :148): both hops' edges renumbered into the hop-2
    input frontier and concatenated into one destination-sorted
    multigraph over ``len(frontier)`` vertices, on ``device``.  A 2-layer
    forward over it gives the seed logits at ``seed_pos``.  Returns
    (frontier, graph, seed_pos)."""
    frontier = np.asarray(hop2.input_ids)
    pos_h1 = _index_of(frontier, hop1.input_ids)
    seed_pos = _index_of(frontier, seeds)
    src = np.concatenate([hop2.graph.src.cpu().numpy(),
                          pos_h1[hop1.graph.src.cpu().numpy()]])
    dst = np.concatenate([pos_h1[hop2.graph.dst.cpu().numpy()],
                          seed_pos[hop1.graph.dst.cpu().numpy()]])
    g = graph_from_coo(src, dst, len(frontier), device=device)
    return frontier, g, seed_pos
