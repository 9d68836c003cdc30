"""gemma-7b -- GeGLU, head_dim=256.  [arXiv:2403.08295; hf]

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
(kv=16 == MHA on the 7b; the 2b sibling uses MQA.)
The port's copy of ``repro/configs/gemma_7b.py``.
"""

import dataclasses

from repro_torch.config import AttentionConfig, LMConfig, register


def _base() -> LMConfig:
    return LMConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        d_ff=24576,
        vocab_size=256000,
        attention=AttentionConfig(num_heads=16, num_kv_heads=16,
                                  head_dim=256),
        mlp_activation="geglu",
        tie_embeddings=True,
        shape_skips=("long_500k",),
        skip_reason="pure full attention; 500k decode needs sub-quadratic",
        source="arXiv:2403.08295",
    )


@register("gemma-7b")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(c.attention, num_heads=4,
                                      num_kv_heads=4, head_dim=16))
