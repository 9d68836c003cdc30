"""LM serving engine: continuous-batching decode over a static KV cache.

Port of ``repro/serve/engine.py``.  The queue/slot/stats loop is
``serve.core.SlotServeCore``; this class supplies the LM step bodies:

  * admission is prefill-into-slot: one sequence's ``lm_prefill`` (K5 on
    every attention layer on a card) written into the batch cache at its
    slot -- an attention layer's K and V rows, an SSM layer's state and
    conv tail --, with per-slot cache lengths, so a slot's RoPE positions
    restart at 0 whatever the other slots hold;
  * the step is one batched ``lm_decode_step`` over every slot; on a card
    it is captured once as a CUDA graph and replayed (``_decode``);
  * greedy or temperature sampling on the host from a seeded numpy rng;
  * a request stops on EOS, on ``max_tokens`` or when its cache is full.

The forward runs under ``torch.inference_mode()``.  The cache is allocated
once at ``cache_size`` on the model's device (an SSM layer's state and
conv tail whatever ``cache_size``), and the decode step writes its new
rows, states and tails into it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import LMConfig
from repro_torch.models.transformer import (TransformerLM, init_caches,
                                            lm_decode_step, lm_prefill)
from repro_torch.serve.core import SlotServeCore


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (len,) int32
    max_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    enqueue_t: float = 0.0
    finish_t: float = 0.0


class ServeEngine(SlotServeCore):
    """Continuous-batching LM decode engine on the shared serving core.

    ``attn_impl`` is the prefill's attention path (``nn.attention.
    attention_block(impl=)``): ``"auto"`` runs K5 on a card; ``"torch"``
    runs the plain PyTorch tier on the same device.

    ``decode_graph`` (default True) captures the decode step, on a CUDA
    model, as one ``torch.cuda.CUDAGraph`` for the engine's (max_batch,
    cache_size) -- the counterpart of the reference's jitted step -- and
    replays it every step after.  The first decode step runs eagerly and
    is the warm-up; the second is captured and replayed.  The graph reads
    the tokens from a static buffer and the caches and per-slot lengths
    from the engine's own tensors, which prefill updates in place, and it
    binds the model's parameters by address: replacing a parameter tensor
    (rather than copying into it) after the capture is not seen.  Prefill
    stays eager: its length varies.  ``decode_graph=False``, or a model on
    the CPU, runs every step eagerly.  A capture or replay that fails
    raises.  ``decode_captures`` / ``decode_replays`` count both.
    """

    def __init__(self, cfg: LMConfig, model: TransformerLM, *,
                 max_batch: int = 8, cache_size: int = 512, seed: int = 0,
                 attn_impl: str = "auto", decode_graph: bool = True):
        super().__init__(max_batch)
        self.cfg = cfg
        self.model = model
        self.cache_size = cache_size
        self.attn_impl = attn_impl
        self.rng = np.random.default_rng(seed)
        self.decode_graph = decode_graph and model.device.type == "cuda"
        self.decode_captures = 0
        self.decode_replays = 0
        self._caches = None
        self._length = None
        self._tokens = None              # (max_batch, 1) static, on device
        self._graph = None               # (CUDAGraph, its static logits)
        self._last_tokens = np.zeros((max_batch, 1), np.int64)

    # ------------------------------------------------------------- internal
    def _admit_into_slot(self, slot: int, req: Request) -> bool:
        """Prefill the request into ``slot``; True if the prefill's first
        sampled token already finished it (EOS / max_tokens=1)."""
        self._prefill_into_slot(slot, req)
        tok = req.output[-1]
        return (req.eos_id is not None and tok == req.eos_id) or \
            len(req.output) >= req.max_tokens

    def _ensure_caches(self):
        if self._caches is None:
            self._caches = init_caches(self.cfg, self.max_batch,
                                       self.cache_size, self.model.device)
            # per-slot lengths: slots are fully independent sequences
            self._length = torch.zeros((self.max_batch,), dtype=torch.int32,
                                       device=self.model.device)
            self._tokens = torch.zeros((self.max_batch, 1),
                                       dtype=torch.int64,
                                       device=self.model.device)

    @torch.inference_mode()
    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Single-sequence prefill written into the batch cache at `slot`:
        the new sequence's rows fill positions [0, cache_size) of ITS slot
        (zeros past the prompt), an SSM layer's state and conv tail are
        its own, and its length is the prompt's.  Each field is written
        whole: a prefill cache of another shape than the slot's raises
        (a copy would broadcast it)."""
        self._ensure_caches()
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                 device=self.model.device)      # (1, L)
        logits, caches1, _ = lm_prefill(self.model, prompt, self.cache_size,
                                        attn_impl=self.attn_impl)
        for batch_fields, fields in zip(self._caches, caches1):
            for whole, one in zip(batch_fields, fields):
                dst = whole[slot:slot + 1]
                if dst.shape != one.shape:
                    raise ValueError(f"prefill cache {tuple(one.shape)} "
                                     f"does not fill the slot's "
                                     f"{tuple(dst.shape)}")
                dst.copy_(one)
        self._length[slot] = prompt.shape[1]
        tok = self._sample(logits[:, -1].cpu().numpy(), req)
        req.output.append(int(tok))
        self._last_tokens[slot, 0] = tok

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        logits = np.asarray(logits, np.float64).reshape(-1)
        if req.temperature <= 0:
            return int(logits.argmax())
        p = np.exp(logits / req.temperature - np.max(logits /
                                                     req.temperature))
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def _decode_body(self) -> torch.Tensor:
        """One batched decode step over the static token buffer: the new
        rows land in the caches in place and ``length + 1`` is copied into
        ``_length``, so every tensor the step touches keeps its storage."""
        logits, _, length = lm_decode_step(
            self.model, self._tokens, self._caches, self._length,
            attn_impl=self.attn_impl)
        self._length.copy_(length)
        return logits

    def _decode(self) -> torch.Tensor:
        """Logits (max_batch, 1, V) of one decode step: eager for the first
        step (the warm-up) and without ``decode_graph``, captured on the
        second, replayed after."""
        self._tokens.copy_(torch.from_numpy(self._last_tokens))
        if self._graph is None and self.decode_graph and self._steps > 0:
            from repro_torch.core.plan import capture_graph
            graph = torch.cuda.CUDAGraph()
            with capture_graph(graph):
                logits = self._decode_body()
            self._graph = (graph, logits)
            self.decode_captures += 1
        if self._graph is None:
            return self._decode_body()
        self._graph[0].replay()
        self.decode_replays += 1
        return self._graph[1]

    @torch.inference_mode()
    def _step(self) -> List[Request]:
        if not self._active:
            return []
        logits = self._decode()
        self._steps += 1
        logits_np = logits[:, 0].cpu().numpy()
        lengths = self._length.tolist()
        finished = []
        for slot, req in list(self._active.items()):
            tok = self._sample(logits_np[slot], req)
            req.output.append(tok)
            self._last_tokens[slot, 0] = tok
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.output) >= req.max_tokens or \
                    lengths[slot] >= self.cache_size - 1:
                finished.append(self._complete(slot))
        return finished

    # ------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, Any]:
        """Core serving stats plus the LM engine's cache view; the legacy
        ``decode_steps`` key aliases the core's step counter."""
        out = super().stats()
        out["decode_steps"] = self._steps
        out["cache_len"] = (self._length.tolist()
                            if self._length is not None else [])
        return out
