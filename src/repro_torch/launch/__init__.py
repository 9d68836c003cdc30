"""Launchers (``repro/launch``): ``serve``."""
