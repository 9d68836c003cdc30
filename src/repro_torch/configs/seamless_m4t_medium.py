"""seamless-m4t-medium -- enc-dec, multimodal.  [arXiv:2308.11596; hf]

12L (encoder) + 12L (decoder) d_model=1024 16H (kv=16) d_ff=4096
vocab=256206.

The speech frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (enc frames = min(seq, 4096)).  The port's
copy of ``repro/configs/seamless_m4t_medium.py``.
"""

import dataclasses

from repro_torch.config import AttentionConfig, LMConfig, register

MAX_ENC_FRAMES = 4096


def enc_frames(seq_len: int) -> int:
    return min(seq_len, MAX_ENC_FRAMES)


def _base() -> LMConfig:
    return LMConfig(
        name="seamless-m4t-medium",
        family="audio",
        num_layers=12,
        encoder_layers=12,
        d_model=1024,
        d_ff=4096,
        vocab_size=256206,
        attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64),
        mlp_activation="gelu",
        tie_embeddings=True,
        frontend_stub=True,
        shape_skips=("long_500k",),
        skip_reason="full-attention decoder; 500k decode needs sub-quadratic",
        source="arXiv:2308.11596",
    )


@register("seamless-m4t-medium")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=2, encoder_layers=2,
        d_model=64, d_ff=128, vocab_size=256,
        attention=dataclasses.replace(c.attention, num_heads=4,
                                      num_kv_heads=4, head_dim=16))
