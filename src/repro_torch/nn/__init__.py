"""LM building blocks: layers, GQA attention and flash attention's
hand-written backward (``repro/nn``)."""
