"""arctic-480b -- 128 experts top-2 + dense residual.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
[hf:Snowflake/snowflake-arctic-base; hf]

Arctic's dense-MoE hybrid: a dense FFN residual branch runs in parallel with
the routed experts on every layer.
The port's copy of ``repro/configs/arctic_480b.py``.
"""

import dataclasses

from repro_torch.config import AttentionConfig, LMConfig, MoEConfig, register


def _base() -> LMConfig:
    return LMConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        d_ff=4864,
        vocab_size=32000,
        attention=AttentionConfig(num_heads=56, num_kv_heads=8, head_dim=128),
        moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864,
                      dense_residual=True, dense_residual_d_ff=4864,
                      capacity_factor=1.25),
        mlp_activation="swiglu",
        shape_skips=("long_500k",),
        skip_reason="pure full attention; 500k decode needs sub-quadratic",
        source="hf:Snowflake/snowflake-arctic-base",
    )


@register("arctic-480b")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=2, d_model=64, d_ff=48,
        vocab_size=256,
        attention=dataclasses.replace(c.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16),
        moe=dataclasses.replace(c.moe, num_experts=4, top_k=2,
                                expert_d_ff=48, dense_residual_d_ff=48))
