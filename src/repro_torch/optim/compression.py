"""int8 error-feedback gradient compression, the math
(``repro/optim/compression.py``, :33-98).

Per leaf: ``g_eff = g + residual``, ``scale = max|g_eff| / 127``,
``q = round(g_eff / scale)`` in int8, ``residual' = g_eff - q * scale``.
The residual carries each step's quantization error into the next, so
over time the sent values track the true gradients.  The all-reduce that
puts ``q`` on the wire (``compressed_psum_leaf``,
``make_compressed_allreduce``) needs a process group and goes with
distributed training (ROADMAP item 11b).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.optimizer import tree_map


def _quantize(g: torch.Tensor, residual: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 scalar, new residual f32) of one leaf
    (``_quantize``, :33); rounding is half to even, as ``jnp.round``."""
    g_eff = g.float() + residual
    scale = torch.clamp(g_eff.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g_eff / scale), -127, 127).to(torch.int8)
    new_residual = g_eff - q.float() * scale
    return q, scale, new_residual


def init_residuals(grads_like: Any) -> Any:
    """f32 zeros shaped like each gradient leaf (``init_residuals``,
    :84)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compression_wire_bytes(params_count: int, dp: int) -> dict:
    """Ring all-reduce bytes per rank in f32, bf16 and int8 with error
    feedback (``compression_wire_bytes``, :89)."""
    ring = 2 * (dp - 1) / dp
    return {
        "fp32_bytes": 4 * params_count * ring,
        "bf16_bytes": 2 * params_count * ring,
        "int8_ef_bytes": 1 * params_count * ring,
        "reduction_vs_fp32": 4.0,
    }
