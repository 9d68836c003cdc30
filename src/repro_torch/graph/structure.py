"""Destination-sorted graph container (``repro/graph/structure.py``).

The canonical form is a destination-sorted edge list: ``src``/``dst``
stable-sorted by ``dst`` so each destination's incoming rows form one
contiguous stretch -- the layout both CUDA kernels fold in order.  Index
arrays are int32 because the kernels read int32; plain PyTorch indexing
casts to int64 where it needs to.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.backend import resolve_device


class Graph(NamedTuple):
    """Destination-sorted COO graph (``repro.graph.structure.Graph``, :22).

    Attributes:
      src:      (E,) int32 source vertex of each edge, sorted by dst.
      dst:      (E,) int32 destination vertex of each edge (non-decreasing).
      in_deg:   (V,) int32 in-degree.
      out_deg:  (V,) int32 out-degree.
      num_vertices: python int.
      row_ptr:  (V+1,) int32 CSR offsets into src/dst.
    """

    src: torch.Tensor
    dst: torch.Tensor
    in_deg: torch.Tensor
    out_deg: torch.Tensor
    num_vertices: int
    row_ptr: Optional[torch.Tensor] = None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        """The same graph with every array on ``device``."""
        dev = resolve_device(device)
        return self._replace(
            src=self.src.to(dev), dst=self.dst.to(dev),
            in_deg=self.in_deg.to(dev), out_deg=self.out_deg.to(dev),
            row_ptr=None if self.row_ptr is None else self.row_ptr.to(dev))

    def mean_norm(self) -> torch.Tensor:
        """1 / (in_deg + 1) -- mean over {N(v)} ∪ {v} (paper Eq. 1)."""
        return 1.0 / (self.in_deg.float() + 1.0)

    def sym_norm_edge(self) -> torch.Tensor:
        """Kipf symmetric normalization per edge: 1/sqrt((d_u+1)(d_v+1))."""
        r = torch.sqrt(1.0 / (self.in_deg.float() + 1.0))
        return r[self.src.long()] * r[self.dst.long()]


def graph_from_coo(src, dst, num_vertices: int, sort: bool = True,
                   build_row_ptr: bool = True, *, device="cuda") -> Graph:
    """Build a destination-sorted Graph from COO arrays (``graph_from_coo``,
    :57): stable argsort by ``dst`` on the host, then one copy to
    ``device``."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src and dst must be 1-D of one length; got "
                         f"{src.shape} and {dst.shape}")
    if sort:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    in_deg = np.bincount(dst, minlength=num_vertices).astype(np.int32)
    out_deg = np.bincount(src, minlength=num_vertices).astype(np.int32)
    row_ptr = None
    if build_row_ptr:
        row_ptr = np.zeros(num_vertices + 1, dtype=np.int32)
        np.cumsum(in_deg, out=row_ptr[1:])
    return Graph(
        src=torch.from_numpy(src).to(dev), dst=torch.from_numpy(dst).to(dev),
        in_deg=torch.from_numpy(in_deg).to(dev),
        out_deg=torch.from_numpy(out_deg).to(dev),
        num_vertices=int(num_vertices),
        row_ptr=None if row_ptr is None else torch.from_numpy(row_ptr).to(dev))


def to_dense_adj(g: Graph, norm: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Dense (V, V) adjacency -- test oracle only (O(V^2) memory)."""
    v = g.num_vertices
    vals = torch.ones(g.num_edges, dtype=torch.float32, device=g.device) \
        if norm is None else norm.float()
    a = torch.zeros(v * v, dtype=torch.float32, device=g.device)
    a.index_put_((g.dst.long() * v + g.src.long(),), vals, accumulate=True)
    return a.view(v, v)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def add_self_loops(g: Graph) -> Graph:
    """A new graph with v->v edges appended (and re-sorted)."""
    v = np.arange(g.num_vertices, dtype=np.int32)
    src = np.concatenate([_host(g.src), v])
    dst = np.concatenate([_host(g.dst), v])
    return graph_from_coo(src, dst, g.num_vertices, device=g.device)


def pad_edges(g: Graph, target_edges: int, pad_vertex: Optional[int] = None
              ) -> Graph:
    """Pad the edge list to ``target_edges`` with self-edges on a sink vertex
    (default V-1); degrees stay those of the real graph, and downstream
    aggregation masks the pad edges out (``edge_mask``)."""
    e = g.num_edges
    if target_edges < e:
        raise ValueError(f"target_edges={target_edges} < num_edges={e}")
    pv = g.num_vertices - 1 if pad_vertex is None else pad_vertex
    pad = target_edges - e
    src = np.concatenate([_host(g.src), np.full(pad, pv, np.int32)])
    dst = np.concatenate([_host(g.dst), np.full(pad, pv, np.int32)])
    out = graph_from_coo(src, dst, g.num_vertices, device=g.device)
    return out._replace(in_deg=g.in_deg, out_deg=g.out_deg)


def edge_mask(real_edges: int, total_edges: int, *, device="cuda"
              ) -> torch.Tensor:
    """(total_edges,) f32: 1 for the first ``real_edges`` edges, 0 after."""
    dev = resolve_device(device)
    return (torch.arange(total_edges, device=dev) < real_edges).float()
