"""Published LM configs the port runs: importing this package registers
them (``repro/configs/__init__.py``).

Each module defines the exact published ``config()`` and the same
``reduced()`` smoke-test variant as its reference module.  Ported so far:
the dense attention archs, the MoE archs arctic-480b and kimi-k2, the
enc-dec seamless-m4t-medium, the SSM mamba2-2.7b and the hybrid
jamba-1.5-large.
"""

from repro_torch.configs import (arctic_480b, gemma2_9b, granite_3_8b,
                                 jamba_1_5_large, kimi_k2, mamba2_2_7b,
                                 seamless_m4t_medium)
