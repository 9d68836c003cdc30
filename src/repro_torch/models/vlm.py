"""VLM composition (internvl2-1b): the frontend stub and the backbone glue.

Port of ``repro/models/vlm.py``.  The vision frontend is a STUB: seeded
patch embeddings (B, P, d_model) take the first ``NUM_PATCH_TOKENS``
positions, before the prompt's tokens.  The backbone is
``models/transformer.py``, whose ``lm_forward``, ``lm_loss`` and
``lm_prefill`` take them as ``embeds``; decode steps after the prefill
are the backbone's own ``lm_decode_step`` (the cache holds the patch
positions).
"""

from __future__ import annotations

import torch

from repro_torch.config import LMConfig
from repro_torch.configs.internvl2_1b import NUM_PATCH_TOKENS
from repro_torch.core.backend import resolve_device
from repro_torch.models.transformer import (TransformerLM, lm_forward,
                                            lm_loss, lm_prefill)


def stub_patch_embeds(generator: torch.Generator, batch: int, cfg: LMConfig,
                      n_patches: int = NUM_PATCH_TOKENS, *,
                      device="cuda") -> torch.Tensor:
    """Stand-in for InternViT + pixel-shuffle output: (B, P, d_model) f32,
    ``N(0, 1) * 0.02`` drawn from ``generator`` on ``device`` (the
    reference's ``stub_patch_embeds`` with a torch generator for its
    key)."""
    return torch.randn((batch, n_patches, cfg.d_model), generator=generator,
                       device=resolve_device(device)) * 0.02


def vlm_forward(model: TransformerLM, patch_embeds: torch.Tensor,
                tokens: torch.Tensor, **kw) -> torch.Tensor:
    """f32 logits over [patch positions ++ token positions]."""
    return lm_forward(model, tokens, patch_embeds, **kw)


def vlm_loss(model: TransformerLM, patch_embeds: torch.Tensor,
             tokens: torch.Tensor, labels: torch.Tensor, **kw):
    """Cross-entropy over the text positions only (patch positions carry no
    labels): ``lm_loss``'s ``(loss, {"ce", "aux"})``."""
    return lm_loss(model, tokens, labels, patch_embeds, **kw)


def vlm_prefill(model: TransformerLM, patch_embeds: torch.Tensor,
                tokens: torch.Tensor, cache_size: int, **kw):
    """Image + prompt prefill; the caches and the length include the patch
    positions.  Raises unless ``cache_size`` holds patches and tokens."""
    need = patch_embeds.shape[1] + tokens.shape[1]
    if cache_size < need:
        raise ValueError(f"vlm_prefill: cache_size={cache_size} < "
                         f"{patch_embeds.shape[1]} patches + "
                         f"{tokens.shape[1]} tokens")
    return lm_prefill(model, tokens, cache_size, patch_embeds, **kw)
