"""deepseek-67b -- dense llama-arch.  [arXiv:2401.02954; hf]

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
The port's copy of ``repro/configs/deepseek_67b.py``.
"""

import dataclasses

from repro_torch.config import AttentionConfig, LMConfig, register


def _base() -> LMConfig:
    return LMConfig(
        name="deepseek-67b",
        family="dense",
        num_layers=95,
        d_model=8192,
        d_ff=22016,
        vocab_size=102400,
        attention=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128),
        mlp_activation="swiglu",
        shape_skips=("long_500k",),
        skip_reason="pure full attention; 500k decode needs sub-quadratic",
        source="arXiv:2401.02954",
    )


@register("deepseek-67b")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=3, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(c.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16))
