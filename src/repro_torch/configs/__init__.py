"""Published LM configs the port runs: importing this package registers
them (``repro/configs/__init__.py``).

Each module defines the exact published ``config()`` and the same
``reduced()`` smoke-test variant as its reference module: all ten
assigned archs -- the dense attention archs, the MoE archs arctic-480b
and kimi-k2, the enc-dec seamless-m4t-medium, the SSM mamba2-2.7b, the
hybrid jamba-1.5-large and the VLM internvl2-1b.
"""

from repro_torch.configs import (arctic_480b, deepseek_67b, gemma2_9b,
                                 gemma_7b, granite_3_8b, internvl2_1b,
                                 jamba_1_5_large, kimi_k2, mamba2_2_7b,
                                 seamless_m4t_medium)
