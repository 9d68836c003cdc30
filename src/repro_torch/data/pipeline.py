"""Deterministic, resumable data pipelines (``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step), so any batch can be made
again from those two numbers and checkpoint-resume is exact: the pipeline
state IS the step counter.  ``TokenPipeline`` synthesizes LM token streams
with a Zipf unigram marginal; ``GraphPipeline`` yields GraphSAGE sampled
minibatches.  Both draw exactly what the reference draws.  ``shard_batch``
places a host batch on a mesh by its shardings (DTensors).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np

from repro_torch.config import GraphSpec, LMConfig, ShapeSpec
from repro_torch.graph.sampling import two_hop_batch
from repro_torch.graph.structure import Graph


class TokenPipeline:
    """Synthetic token batches with a Zipf unigram distribution
    (``TokenPipeline``, :27).  Batches are numpy arrays."""

    def __init__(self, cfg: LMConfig, shape: ShapeSpec, seed: int = 0,
                 frontend_tokens: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.step = 0
        self.frontend_tokens = frontend_tokens
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = ranks ** -1.1
        self._cdf = np.cumsum(w) / w.sum()

    def _tokens(self, rng: np.random.Generator, n: Tuple[int, ...]):
        u = rng.random(n)
        return np.searchsorted(self._cdf, u).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b = self.shape.global_batch
        s = self.shape.seq_len - self.frontend_tokens
        toks = self._tokens(rng, (b, s))
        batch: Dict[str, np.ndarray] = {
            "tokens": toks,
            # next-token labels, pre-shifted; the last position masked
            "labels": np.concatenate(
                [toks[:, 1:], np.full((b, 1), -100, np.int32)], axis=1),
        }
        if self.frontend_tokens:
            d = self.cfg.d_model
            batch["embeds"] = rng.standard_normal(
                (b, self.frontend_tokens, d)).astype(np.float32) * 0.02
        if self.cfg.family == "audio":
            d = self.cfg.d_model
            batch["frames"] = rng.standard_normal(
                (b, min(self.shape.seq_len, 4096), d)
            ).astype(np.float32) * 0.02
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            out = self.batch_at(self.step)
            self.step += 1
            yield out

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])


class GraphPipeline:
    """GraphSAGE minibatches: seed vertices and their sampled 2-hop blocks
    (``GraphPipeline``, :88).  Samples from a host copy of ``graph``, made
    once here; the blocks' graphs land on ``device``."""

    def __init__(self, graph: Graph, spec: GraphSpec, batch_size: int,
                 fanouts: Tuple[int, int] = (10, 25), seed: int = 0, *,
                 device="cuda"):
        self.graph = graph
        self.spec = spec
        self.batch_size = batch_size
        self.fanouts = fanouts
        self.seed = seed
        self.step = 0
        self.device = device
        self._host_graph = graph if graph.device.type == "cpu" \
            else graph.to("cpu")

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        seeds = rng.choice(self.spec.num_vertices,
                           size=min(self.batch_size,
                                    self.spec.num_vertices),
                           replace=False).astype(np.int32)
        hop2, hop1 = two_hop_batch(self._host_graph, seeds, self.fanouts,
                                   seed=int(rng.integers(2 ** 31)),
                                   device=self.device)
        return {"seeds": seeds, "hop1": hop1, "hop2": hop2}

    def __iter__(self):
        while True:
            out = self.batch_at(self.step)
            self.step += 1
            yield out

    def state_dict(self):
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st):
        self.step = int(st["step"])
        self.seed = int(st["seed"])


def shard_batch(batch: Dict[str, Any], shardings: Dict[str, Any]
                ) -> Dict[str, Any]:
    """A host batch as DTensors on the mesh, each entry by its sharding
    (``launch/sharding.py::NamedSharding``; ``shard_batch``, :124);
    entries without one stay as they are.  Every rank makes the whole
    batch from (seed, step), so each takes its own shard and nothing is
    sent."""
    return {k: shardings[k].place(v) if k in shardings else v
            for k, v in batch.items()}
