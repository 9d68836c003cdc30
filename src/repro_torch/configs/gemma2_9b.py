"""gemma2-9b -- local+global alternating attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.  [arXiv:2408.00118]

head_dim=256, sliding window 4096 on even (local) layers, attn softcap 50,
final softcap 30, GeGLU, tied embeddings, sandwich norms.
The port's copy of ``repro/configs/gemma2_9b.py``.
"""

import dataclasses

from repro_torch.config import AttentionConfig, LMConfig, register


def _base() -> LMConfig:
    return LMConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        d_ff=14336,
        vocab_size=256000,
        attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                                  sliding_window=4096,
                                  local_global_alternate=True,
                                  attn_logit_softcap=50.0),
        mlp_activation="geglu",
        tie_embeddings=True,
        final_logit_softcap=30.0,
        source="arXiv:2408.00118",
    )


@register("gemma2-9b")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=4, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(c.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16,
                                      sliding_window=16))
