"""internvl2-1b -- VLM: InternViT frontend (STUB) + Qwen2-0.5B LM backbone.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  [arXiv:2404.16821; hf]

The vision frontend is a stub: precomputed patch embeddings (256 tokens,
ViT-L/14 448px -> 256 patches after pixel-shuffle) occupy the first
positions (``models/vlm.py``); the backbone is exercised in full.
The port's copy of ``repro/configs/internvl2_1b.py``.
"""

import dataclasses

from repro_torch.config import AttentionConfig, LMConfig, register

NUM_PATCH_TOKENS = 256


def _base() -> LMConfig:
    return LMConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        d_ff=4864,
        vocab_size=151655,
        attention=AttentionConfig(num_heads=14, num_kv_heads=2, head_dim=64),
        mlp_activation="swiglu",
        tie_embeddings=True,
        frontend_stub=True,
        shape_skips=("long_500k",),
        skip_reason="pure full attention; 500k decode needs sub-quadratic",
        source="arXiv:2404.16821",
    )


@register("internvl2-1b")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(c.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16))
