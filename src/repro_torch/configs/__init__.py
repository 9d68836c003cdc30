"""Published LM configs the port runs: importing this package registers
them (``repro/configs/__init__.py``).

Each module defines the exact published ``config()`` and the same
``reduced()`` smoke-test variant as its reference module.  Ported so far:
the dense attention archs and the enc-dec seamless-m4t-medium.
"""

from repro_torch.configs import gemma2_9b, granite_3_8b, seamless_m4t_medium
