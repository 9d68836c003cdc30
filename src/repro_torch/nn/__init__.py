"""LM building blocks: layers and GQA attention (``repro/nn``)."""
