"""Core LM layers: norms, dense/MLP, embeddings, rotary and sinusoidal
positions, softcap.

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.backend import resolve_device


#: the configs' dtype names (``LMConfig.dtype``, ``SSMConfig.
#: compute_dtype``); float64 is the card's yardstick of an f32 gradient
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the reference computes in f32 for operands of ``dtype``:
    f32 for bf16 and f32, f64 for an f64 yardstick."""
    return torch.promote_types(dtype, torch.float32)


def init_normal(shape, scale: float, *, dtype, device,
                generator: torch.Generator) -> nn.Parameter:
    """``N(0, 1) * scale`` drawn in f32 on ``device``, cast to ``dtype``."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return nn.Parameter(w.mul_(scale).to(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMSNorm computed in f32 (f64 for f64 ``x``) with ``(1 + scale)``,
    cast to ``dtype`` (default: x's dtype)."""
    xf = x.to(acc_dtype(x.dtype))
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(dtype or x.dtype)


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's norm-then-gate (``gated_rmsnorm``, :37):
    ``rmsnorm(x * silu(z))`` with z cast to x's dtype first, the gate and
    its product in x's dtype, the result in x's dtype."""
    return rmsnorm(scale, x * silu(z.to(x.dtype)), eps)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                              device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps, dtype)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` of shape ``(d_in, d_out)``, in x's dtype."""
    return x @ w.to(x.dtype)


def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the reference casts a constant to
    its operand's dtype."""
    return float(torch.tensor(value, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` as the reference computes it.

    In bf16 the reference rounds to bf16 after every op of
    ``x * 0.5 (1 + tanh(c1 (x + c0 x^3)))``, its constants rounded to bf16
    too; ``F.gelu``, which rounds once, moves ~40% of bf16 activations by
    an ulp.  So a reduced dtype takes the same ops one by one (each torch op
    computes in f32 and rounds to x's dtype).  In f32 the one-kernel
    ``F.gelu`` is within the f32 band of it."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c0 = _const(0.044715, x.dtype)
    c1 = _const((2 / torch.pi) ** 0.5, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c1 * (x + c0 * (x * x * x)))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, where the reference's bf16
    sigmoid is ``1 / (1 + exp(-x))`` rounded after each op (see
    ``gelu_tanh``).  f32 takes ``F.silu``."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


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
            h = silu(dense(self.wg, x)) * h
        elif self.activation == "geglu":
            h = gelu_tanh(dense(self.wg, x)) * h
        elif self.activation == "gelu":
            h = gelu_tanh(h)
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
    """Rows of ``table``; gemma scales them by ``sqrt(d)`` in their dtype.
    A DTensor table (on a mesh) is gathered whole and each rank looks up
    its own ids (the table's gradient a partial sum over the mesh): the
    lookup of a sharded table has no DTensor rule that keeps it sharded."""
    if isinstance(table, DTensor):
        return _embed_per_shard(table, ids, scale_by_sqrt_d)
    out = table[ids.long()]
    if scale_by_sqrt_d:
        out = out * (table.shape[1] ** 0.5)
    return out


def shard_sums(placements) -> list:
    """The placements of a sum over each rank's shard of a tensor placed as
    ``placements``: partial over the mesh dims that split it, replicated
    over those that hold it whole (where every rank sums the same
    values)."""
    return [Partial() if isinstance(p, Shard) else Replicate()
            for p in placements]


def _embed_per_shard(table, ids, scale_by_sqrt_d: bool):
    """``embed`` of a DTensor table: the rows of the whole table at each
    rank's ids, placed as the ids are (plain ids are replicated).  The
    table's gradient is a partial sum over the mesh dims that split the
    ids (``shard_sums``)."""
    mesh = table.device_mesh
    if isinstance(ids, DTensor):
        placements, ids = ids.placements, ids.to_local()
    else:
        placements = [Replicate()] * mesh.ndim
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=shard_sums(placements))
    out = whole[ids.long()]
    if scale_by_sqrt_d:
        out = out * (table.shape[1] ** 0.5)
    return DTensor.from_local(out, mesh, placements, run_check=False)


#: vocab rows of the table upcast at a time by ``unembed`` on the CPU and
#: by ``unembed_grads``
UNEMBED_CHUNK = 4096


def unembed_grads(g: torch.Tensor, x2: torch.Tensor, table: torch.Tensor,
                  need_x: bool = True, need_table: bool = True):
    """Gradients of the f32 logits ``x2 @ table.T`` (x2 (T, D), table
    (V, D), both reduced precision) given their f32 gradient ``g`` (T, V):
    ``(dx, dtable)``, each rounded once to its operand's dtype.  The
    table is taken ``UNEMBED_CHUNK`` vocab rows at a time, upcast to f32
    (its values are exact there), so no f32 copy of the whole table or of
    its gradient (each 3.7 GB for gemma2) is made; dx accumulates over
    the slices in f32."""
    dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device) \
        if need_x else None
    dt = torch.empty_like(table) if need_table else None
    x32 = x2.float() if need_table else None
    for v0 in range(0, table.shape[0], UNEMBED_CHUNK):
        gs = g[:, v0:v0 + UNEMBED_CHUNK]
        if need_x:
            dx.addmm_(gs, table[v0:v0 + UNEMBED_CHUNK].float())
        if need_table:
            dt[v0:v0 + UNEMBED_CHUNK] = (gs.t() @ x32).to(table.dtype)
    return (dx.to(x2.dtype) if need_x else None), dt


class _UnembedF32(torch.autograd.Function):
    """``x @ table.T`` of reduced-precision operands as the f32
    accumulator (``torch.mm(..., out_dtype=torch.float32)``, which has no
    derivative of its own).  The backward is ``unembed_grads``."""

    @staticmethod
    def forward(ctx, x2, table):
        ctx.save_for_backward(x2, table)
        return torch.mm(x2, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, table = ctx.saved_tensors
        return unembed_grads(g, x2, table, *ctx.needs_input_grad)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits ``x @ table.T`` as f32: the operands in x's dtype, the f32
    accumulator returned as it is, as the reference does
    (``preferred_element_type=float32``); bf16 logits are never rounded to
    bf16.

    f32 (and f64) operands are a plain product.  Reduced-precision
    operands on a card go through ``torch.mm(..., out_dtype=torch.float32)``
    (``_UnembedF32``, differentiable for the training loss); on the CPU,
    which has no such kernel, ``UNEMBED_CHUNK`` vocab rows of the table at
    a time are upcast and multiplied in f32 (the products of bf16 values
    are exact in f32), so no f32 copy of the whole table (256000 x 3584 for
    gemma2) is made."""
    table = table.to(x.dtype)
    if x.dtype in (torch.float32, torch.float64):
        return x @ table.t()
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type != "cpu":
        out = _UnembedF32.apply(x2, table)
    else:
        x32 = x2.float()
        out = torch.cat([x32 @ table[v0:v0 + UNEMBED_CHUNK].float().t()
                         for v0 in range(0, table.shape[0], UNEMBED_CHUNK)],
                        dim=1)
    return out.reshape(*x.shape[:-1], table.shape[0])


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


def sinusoidal_positions(seq: int, d: int, *,
                         device="cuda") -> torch.Tensor:
    """(seq, d) f32 sinusoidal position table (``sinusoidal_positions``,
    :134) on ``device``: even columns ``sin(pos / 10000^(i / d))``, odd
    columns the ``cos`` of the same angle, i the even column index."""
    dev = resolve_device(device)
    pos = torch.arange(seq, dtype=torch.float32, device=dev)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=dev)[None, :]
    angle = pos / (10000.0 ** (dim / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=dev)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
