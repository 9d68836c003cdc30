"""GCN model configs and the paper's Table-2 graph specs.

A copy of the GCN part of ``repro/config.py`` (``GCNModelConfig``,
``GraphSpec``, the Table-2 specs and ``reduced_graph``), kept here so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class GCNModelConfig:
    """Paper Table 1 layer configs (``repro.config.GCNModelConfig``)."""

    name: str
    conv: str  # "gcn" | "gin" | "sage"
    aggregator: str  # "mean" | "sum"
    hidden_dims: Tuple[int, ...]  # MLP dims after the input feature length
    # Paper's F2: which phase runs first. "combine" | "aggregate" | "auto".
    ordering: str = "auto"
    fused: bool = False  # use the fused aggregate->combine kernel (F5)
    num_layers: int = 2
    dropout: float = 0.0


@dataclass(frozen=True)
class GraphSpec:
    """Synthetic dataset spec matched to paper Table 2 statistics."""

    name: str
    num_vertices: int
    feature_len: int
    num_edges: int
    num_classes: int = 16
    seed: int = 0


# Paper Table 2. (LiveJournal feature_len=1 -- classic graph processing.)
CORA = GraphSpec("cora", 2708, 1433, 5429, num_classes=7)
CITESEER = GraphSpec("citeseer", 3327, 3703, 4732, num_classes=6)
PUBMED = GraphSpec("pubmed", 19717, 500, 44338, num_classes=3)
REDDIT = GraphSpec("reddit", 232965, 602, 11606919, num_classes=41)
LIVEJOURNAL = GraphSpec("livejournal", 4847571, 1, 68993773, num_classes=2)

GRAPHS: Dict[str, GraphSpec] = {
    g.name: g for g in (CORA, CITESEER, PUBMED, REDDIT, LIVEJOURNAL)
}


def reduced_graph(spec: GraphSpec, max_vertices: int = 512,
                  max_feature: int = 64) -> GraphSpec:
    """Scale a graph spec down for CPU tests, preserving density."""
    scale = min(1.0, max_vertices / spec.num_vertices)
    nv = max(8, int(spec.num_vertices * scale))
    ne = max(nv, int(spec.num_edges * scale))
    return dataclasses.replace(
        spec, name=spec.name + "_small", num_vertices=nv, num_edges=ne,
        feature_len=min(spec.feature_len, max_feature))
