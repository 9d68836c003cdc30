"""kimi-k2-1t-a32b -- trillion-param MoE (paper-table).

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840, MoE 384e top-8.
[arXiv:2501.kimi2; unverified]

Analytic params ~1.04T total / ~32B active (matches '1t-a32b'); SwiGLU
experts (3 matrices) reproduce the published ratio.
Pure full attention -> long_500k skipped (DESIGN.md §4).
The port's copy of ``repro/configs/kimi_k2.py``.
"""

import dataclasses

from repro_torch.config import AttentionConfig, LMConfig, MoEConfig, register


def _base() -> LMConfig:
    return LMConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        d_ff=2048,
        vocab_size=163840,
        attention=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128),
        moe=MoEConfig(num_experts=384, top_k=8, expert_d_ff=2048,
                      capacity_factor=1.25),
        mlp_activation="swiglu",
        shape_skips=("long_500k",),
        skip_reason="pure full attention; 500k decode needs sub-quadratic",
        source="arXiv:2501.kimi2; unverified",
    )


@register("kimi-k2-1t-a32b")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=2, d_model=64, d_ff=32,
        vocab_size=256,
        attention=dataclasses.replace(c.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16),
        moe=dataclasses.replace(c.moe, num_experts=8, top_k=2,
                                expert_d_ff=32))
