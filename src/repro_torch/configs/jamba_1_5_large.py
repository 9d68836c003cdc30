"""jamba-1.5-large-398b -- Mamba+attention 1:7 interleave + MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
[arXiv:2403.19887; hf]

Period-8 blocks: one attention layer per 8 (placed mid-block), seven Mamba-2
layers; MoE replaces the dense FFN on every other layer.  Analytic totals
~399B params / ~94B active, matching the published 398B/94B.
The port's copy of ``repro/configs/jamba_1_5_large.py``.
"""

import dataclasses

from repro_torch.config import (AttentionConfig, LMConfig, MoEConfig,
                                SSMConfig, register)


def _base() -> LMConfig:
    return LMConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        d_ff=24576,
        vocab_size=65536,
        attention=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256,
                      compute_dtype="bfloat16"),
        moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576,
                      layer_pattern="every_2", capacity_factor=1.25),
        attn_every=8,
        mlp_activation="swiglu",
        source="arXiv:2403.19887",
    )


@register("jamba-1.5-large-398b")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=8, d_model=64, d_ff=64,
        vocab_size=256,
        attention=dataclasses.replace(c.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16),
        ssm=dataclasses.replace(c.ssm, d_state=16, head_dim=8,
                                chunk_size=16,
                                compute_dtype="float32"),
        moe=dataclasses.replace(c.moe, num_experts=4, top_k=2,
                                expert_d_ff=64))
