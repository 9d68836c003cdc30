"""Atomic, optionally asynchronous checkpoints (``repro/checkpoint``)."""
