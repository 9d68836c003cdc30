"""Launchers (``repro/launch``): ``serve``, ``steps`` (the LM train and
eval steps) and ``train_lm`` (``examples/train_lm.py``'s counterpart),
and the examples' counterparts beside them."""
