"""The inference-serving layer (``repro/serve``): the slot-based serving
core and the LM ``ServeEngine`` on it."""
