"""Hardware presets the port's cost models price against (``machine.py``)."""
