"""AdamW, its schedule and the int8 error-feedback quantizer
(``repro/optim``)."""
