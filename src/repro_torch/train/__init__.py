"""The supervised training loop with recovery (``repro/train``)."""
