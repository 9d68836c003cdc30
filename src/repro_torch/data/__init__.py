"""Deterministic, resumable data pipelines (``repro/data``)."""
