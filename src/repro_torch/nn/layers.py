"""Core LM layers: norms, dense/MLP, embeddings, rotary positions, softcap.

Port of ``repro/nn/layers.py``.  The functions take tensors; the modules
hold the parameters in the reference's layouts, so that the reference's
params pytree loads leaf for leaf:

  * a dense weight is ``(d_in, d_out)`` and applies as ``x @ w``;
  * an embedding table is ``(vocab, d)``;
  * a norm scale is f32 ``(d,)`` and applies as ``(1 + scale)``.

Weights are drawn from an explicit ``torch.Generator`` on the module's
device, in f32, then cast to the model's dtype (``init_dense`` /
``init_embedding``).  Compute follows the reference: bf16 operands with f32
accumulation (PyTorch's bf16 matmul accumulates in f32 and rounds once).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def init_normal(shape, scale: float, *, dtype, device,
                generator: torch.Generator) -> nn.Parameter:
    """``N(0, 1) * scale`` drawn in f32 on ``device``, cast to ``dtype``."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return nn.Parameter(w.mul_(scale).to(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32 with ``(1 + scale)``, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                              device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` of shape ``(d_in, d_out)``, in x's dtype."""
    return x @ w.to(x.dtype)


class MLP(nn.Module):
    """``wi``/``wo`` (and ``wg`` for the gated activations)."""

    def __init__(self, d_model: int, d_ff: int, activation: str, *, dtype,
                 device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.activation = activation
        self.wi = init_normal((d_model, d_ff), d_model ** -0.5, **kw)
        self.wo = init_normal((d_ff, d_model), d_ff ** -0.5, **kw)
        self.wg: Optional[nn.Parameter] = None
        if activation in ("swiglu", "geglu"):
            self.wg = init_normal((d_model, d_ff), d_model ** -0.5, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = dense(self.wi, x)
        if self.activation == "swiglu":
            h = F.silu(dense(self.wg, x)) * h
        elif self.activation == "geglu":
            h = F.gelu(dense(self.wg, x), approximate="tanh") * h
        elif self.activation == "gelu":
            h = F.gelu(h, approximate="tanh")
        elif self.activation == "relu":
            h = F.relu(h)
        else:
            raise ValueError(self.activation)
        return dense(self.wo, h)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
    """``table`` (vocab, d) ~ N(0, 1/d): tied-unembed logits are O(1) at
    init, and gemma's ``sqrt(d)`` embed scale restores unit variance."""

    def __init__(self, vocab: int, d: int, *, dtype, device,
                 generator: torch.Generator):
        super().__init__()
        self.table = init_normal((vocab, d), d ** -0.5, dtype=dtype,
                                 device=device, generator=generator)


def embed(table: torch.Tensor, ids: torch.Tensor,
          scale_by_sqrt_d: bool = False) -> torch.Tensor:
    """Rows of ``table``; gemma scales them by ``sqrt(d)`` in their dtype."""
    out = table[ids.long()]
    if scale_by_sqrt_d:
        out = out * (table.shape[1] ** 0.5)
    return out


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits ``x @ table.T`` as f32.

    The reference accumulates in f32 and returns f32.  Here the product is
    taken in x's dtype (f32 accumulation inside the matmul) and rounded
    once to that dtype before the cast: for bf16 that is one bf16 rounding,
    inside the bf16 band, and it avoids an f32 copy of the table (256000 x
    3584 for gemma2) on every call."""
    return (x @ table.to(x.dtype).t()).float()


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D) with positions (..., S) or (S,).  Rotates the two
    split halves of the head (not interleaved pairs), in f32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
