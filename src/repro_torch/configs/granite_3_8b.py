"""granite-3-8b -- dense GQA.  [hf:ibm-granite/granite-3.0-2b-base family]

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
The port's copy of ``repro/configs/granite_3_8b.py``.
"""

import dataclasses

from repro_torch.config import AttentionConfig, LMConfig, register


def _base() -> LMConfig:
    return LMConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        d_ff=12800,
        vocab_size=49155,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128),
        mlp_activation="swiglu",
        tie_embeddings=True,
        shape_skips=("long_500k",),
        skip_reason="pure full attention; 500k decode needs sub-quadratic",
        source="hf:ibm-granite/granite-3.0-2b-base",
    )


@register("granite-3-8b")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(c.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16))
