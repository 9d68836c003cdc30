"""GraphSAGE minibatch neighbour sampling (``repro/graph/sampling.py``;
paper §2: SAGE updates a batch of vertices along with their 2-hop
neighbours per iteration).

Static-shape, padded sampling on the host (numpy): for each seed vertex
up to ``fanout`` in-neighbours are drawn per hop without replacement, and
the draw is padded with the seed itself.  The draws are the reference's,
call for call on the same ``np.random.Generator``, so both packages sample
the same blocks from one seed.  The sampled block's graph lands on
``device``; the graph sampled from is read on the host (pass a graph on
the CPU to avoid a copy per call: ``data.pipeline.GraphPipeline`` does).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.graph.structure import Graph, graph_from_coo


class SampledBlock(NamedTuple):
    """One bipartite sampling layer: edges from sampled sources to the
    seed destinations (``SampledBlock``, :21)."""

    graph: Graph            # destination-sorted subgraph over compacted ids
    real_edges: int
    seed_ids: np.ndarray    # global ids of the layer's destination vertices
    input_ids: np.ndarray   # global ids of required input (source) vertices


def _host_csr(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """(row_ptr, src) of ``g`` as numpy arrays (int32): views for a graph
    on the CPU, one copy otherwise."""
    src = g.src.cpu().numpy()
    if g.row_ptr is not None:
        return g.row_ptr.cpu().numpy(), src
    row_ptr = np.zeros(g.num_vertices + 1, np.int32)
    np.cumsum(g.in_deg.cpu().numpy(), out=row_ptr[1:])
    return row_ptr, src


def sample_neighbors(g: Graph, seeds: np.ndarray, fanout: int,
                     rng: np.random.Generator, *,
                     device="cuda") -> SampledBlock:
    """One hop (``sample_neighbors``, :30): ``fanout`` in-neighbours per
    seed, drawn without replacement (every neighbour when the degree is at
    most ``fanout``), padded with the seed; an isolated seed samples only
    itself.  The sources are compacted into ``input_ids`` (sorted unique
    global ids, the seeds among them)."""
    row_ptr, src_all = _host_csr(g)
    seeds = np.asarray(seeds, dtype=np.int32)
    n = len(seeds)
    samp_src = np.empty((n, fanout), dtype=np.int32)
    samp_msk = np.zeros((n, fanout), dtype=bool)
    for i, v in enumerate(seeds):
        lo, hi = row_ptr[v], row_ptr[v + 1]
        deg = hi - lo
        if deg == 0:
            samp_src[i] = v
            continue
        take = min(fanout, deg)
        idx = rng.choice(deg, size=take, replace=False) if take < deg \
            else np.arange(deg)
        samp_src[i, :take] = src_all[lo + idx]
        samp_src[i, take:] = v
        samp_msk[i, :take] = True

    flat_src = samp_src.reshape(-1)
    flat_dst = np.repeat(np.arange(n, dtype=np.int32), fanout)
    input_ids, inv = np.unique(np.concatenate([seeds, flat_src]),
                               return_inverse=True)
    local_src = inv[n:].astype(np.int32)
    sub = graph_from_coo(local_src, flat_dst, max(len(input_ids), n),
                         device=device)
    return SampledBlock(graph=sub, real_edges=int(samp_msk.sum()),
                        seed_ids=seeds, input_ids=input_ids)


def two_hop_batch(g: Graph, batch: np.ndarray, fanouts: Tuple[int, int],
                  seed: int = 0,
                  rng: Optional[np.random.Generator] = None, *,
                  device="cuda") -> Tuple[SampledBlock, SampledBlock]:
    """A batch of vertices and their sampled 2-hop frontier
    (``two_hop_batch``, :64), returned in execution order (hop 2 first).
    ``rng`` takes precedence over ``seed``: a streaming caller passes one
    long-lived generator and gets fresh, reproducible draws per call."""
    if rng is None:
        rng = np.random.default_rng(seed)
    hop1 = sample_neighbors(g, batch, fanouts[0], rng, device=device)
    hop2 = sample_neighbors(g, hop1.input_ids, fanouts[1], rng,
                            device=device)
    return hop2, hop1
