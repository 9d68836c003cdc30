"""Synthetic Table-2 datasets (``repro/graph/datasets.py``, :36-70).

The generator is the reference's numpy code, draw for draw, so both
packages build identical edges and features from one seed: a power-law
source marginal (hubs shared by many destinations), uniform destinations, a
random vertex permutation.  Features are drawn in float64 numpy and cast to
f32, as the reference does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.config import GRAPHS, GraphSpec
from repro_torch.core.backend import resolve_device
from repro_torch.graph.structure import Graph, graph_from_coo


def _powerlaw_targets(rng: np.random.Generator, num_edges: int,
                      num_vertices: int, alpha: float = 1.05) -> np.ndarray:
    """Sample edge endpoints with a Zipf-like marginal (heavy-tailed reuse)."""
    ranks = np.arange(1, num_vertices + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = rng.random(num_edges)
    return np.searchsorted(cdf, u).astype(np.int64)


def make_synthetic_graph(spec: GraphSpec, seed: int | None = None, *,
                         device="cuda") -> Graph:
    """A graph with the spec's |V|, |E| and power-law degrees."""
    rng = np.random.default_rng(spec.seed if seed is None else seed)
    v, e = spec.num_vertices, spec.num_edges
    src = _powerlaw_targets(rng, e, v)
    dst = rng.integers(0, v, size=e)
    coll = src == dst
    src[coll] = (src[coll] + 1) % v
    perm = rng.permutation(v)
    return graph_from_coo(perm[src], perm[dst], v, device=device)


def make_features(spec: GraphSpec, seed: int | None = None, *,
                  device="cuda") -> torch.Tensor:
    """(V, F) f32 features, N(0, 1/F), drawn in float64 numpy."""
    dev = resolve_device(device)
    rng = np.random.default_rng((spec.seed if seed is None else seed) + 1)
    x = rng.standard_normal((spec.num_vertices, spec.feature_len)) / np.sqrt(
        spec.feature_len)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def make_labels(spec: GraphSpec, seed: int | None = None, *,
                device="cuda") -> torch.Tensor:
    """(V,) int64 class labels."""
    dev = resolve_device(device)
    rng = np.random.default_rng((spec.seed if seed is None else seed) + 2)
    return torch.from_numpy(
        rng.integers(0, spec.num_classes, spec.num_vertices)).to(dev)


def load_dataset(name: str, seed: int | None = None, *, device="cuda"
                 ) -> Tuple[Graph, torch.Tensor, torch.Tensor, GraphSpec]:
    """(graph, features, labels, spec) for a paper dataset by name."""
    resolve_device(device)
    spec = GRAPHS[name]
    g = make_synthetic_graph(spec, seed, device=device)
    return (g, make_features(spec, seed, device=device),
            make_labels(spec, seed, device=device), spec)
