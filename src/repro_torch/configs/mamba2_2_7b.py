"""mamba2-2.7b -- SSD (state-space duality), attention-free.

64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128.  [arXiv:2405.21060]

d_inner = 2*2560 = 5120, head_dim=64 -> 80 heads, 1 group, conv4, chunk 256.
Attention-free and FFN-free: every layer is one Mamba-2 block
(``models/mamba2.py``).
The port's copy of ``repro/configs/mamba2_2_7b.py``.
"""

import dataclasses

from repro_torch.config import LMConfig, SSMConfig, register


def _base() -> LMConfig:
    return LMConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        d_ff=0,
        vocab_size=50280,
        attention=None,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256,
                      compute_dtype="bfloat16"),
        mlp_activation="gelu",
        tie_embeddings=True,
        source="arXiv:2405.21060; unverified",
    )


@register("mamba2-2.7b")
def config() -> LMConfig:
    return _base()


def reduced() -> LMConfig:
    c = _base()
    return dataclasses.replace(
        c, name=c.name + "-smoke", num_layers=2, d_model=64, vocab_size=256,
        ssm=dataclasses.replace(c.ssm, d_state=16, head_dim=8,
                                chunk_size=16,
                                compute_dtype="float32"))
