"""Published LM configs the port runs: importing this package registers
them (``repro/configs/__init__.py``).

Each module defines the exact published ``config()`` and the same
``reduced()`` smoke-test variant as its reference module.  Only the dense
attention archs of the serving path are ported so far.
"""

from repro_torch.configs import gemma2_9b, granite_3_8b
