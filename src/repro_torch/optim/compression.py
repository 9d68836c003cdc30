"""int8 error-feedback gradient compression
(``repro/optim/compression.py``).

Per leaf: ``g_eff = g + residual``, ``scale = max|g_eff| / 127``,
``q = round(g_eff / scale)`` in int8, ``residual' = g_eff - q * scale``.
The residual carries each step's quantization error into the next, so
over time the sent values track the true gradients.

``compressed_psum_leaf`` puts ``q`` on the wire: an all-reduce of ``q``
as an int32 sum (``Mesh.psum`` of ``core.distributed``: ``all_reduce`` on
a process group, the sum of the held shards on a ``LocalMesh``) and one of
the scales, the output ``wire * mean scale / n``.
``make_compressed_allreduce(mesh, axis)`` applies it to every leaf of a
gradient tree.  Its contract is the reference's: gradients replicated
along ``axis`` in, their mean out (on a ``LocalMesh`` every held shard
holds the same replica and residual), and the new residuals.  On a
process group, the plan's backward already sums each rank's partial
gradient over the world (``core.distributed``, adjoint (c)), so the
gradients that come in are the replicas this contract takes.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.optimizer import tree_leaves, tree_map, \
    tree_unflatten


def _quantize(g: torch.Tensor, residual: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 scalar, new residual f32) of one leaf
    (``_quantize``, :33); rounding is half to even, as ``jnp.round``."""
    g_eff = g.float() + residual
    scale = torch.clamp(g_eff.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g_eff / scale), -127, 127).to(torch.int8)
    new_residual = g_eff - q.float() * scale
    return q, scale, new_residual


def compressed_psum_leaf(mesh, g: torch.Tensor, residual: torch.Tensor,
                         axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce one gradient leaf in int8 over ``axis`` of ``mesh``
    (``compressed_psum_leaf``, :42): (the mean gradient in g's dtype, the
    new residual).  ``g`` and ``residual`` are this process's replica; on
    a ``LocalMesh`` every held shard contributes the same one.  The wire
    is ``q`` summed as int32 (at most 127 P, exact); each shard sent
    ``q_i * scale_i``, and dequantizing with the mean scale is exact when
    the scales agree -- the error lands in the residual either way."""
    q, scale, new_residual = _quantize(g, residual)
    held = len(mesh.coords)
    wire = mesh.psum([q.to(torch.int32)] * held, axis)[0]
    scale_sum = mesh.psum([scale] * held, axis)[0]
    n = float(mesh.axis_size(axis))
    g_out = wire.to(torch.float32) * (scale_sum / n) / n
    return g_out.to(g.dtype), new_residual


def make_compressed_allreduce(mesh, axis: str = "data"):
    """``fn(grads, residuals) -> (mean grads, new residuals)`` over trees
    of tensors (``make_compressed_allreduce``, :55): each leaf through
    ``compressed_psum_leaf``, in ``tree_leaves`` order (every process of
    a group takes the same order)."""
    def allreduce(grads: Any, residuals: Any):
        outs = [compressed_psum_leaf(mesh, g, r, axis)
                for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
        return (tree_unflatten(grads, [o[0] for o in outs]),
                tree_unflatten(residuals, [o[1] for o in outs]))
    return allreduce


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
