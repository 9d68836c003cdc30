"""K2 ``fused_agg_combine``: blocked segmented sum fused with ``@ W``.

Port of the TPU kernel
``repro/kernels/fused_agg_combine.py::fused_agg_combine_blocked`` (:73) to
the hand-written CUDA kernel ``csrc/fused_agg_combine.cu``.  Per
destination block of ``tile_m`` rows, the block's gathered rows are summed
on chip and multiplied by ``W`` before anything is written::

    out[b*tile_m + m] = (sum_{e: dstl[b,e]=m, mask[b,e]!=0}
                             mask[b,e] * x[src[b,e]]) @ W

``fused_agg_combine`` is the wrapper: a tensor on the CPU takes
``fused_agg_combine_plain``, a CUDA tensor launches the kernel or raises.
``fused_agg_combine.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.seg_agg import blocks_per_chunk, fold_blocks_plain

#: static shared memory of the kernel (the staged slot indices)
_STATIC_SMEM = 3 * 256 * 4
#: per-block shared memory limit (opt-in) of the H100
_H100_SMEM_OPTIN = 232448


def fused_agg_combine_plain(x: torch.Tensor, src: torch.Tensor,
                            dstl: torch.Tensor, mask: torch.Tensor,
                            w: torch.Tensor, *, tile_m: int) -> torch.Tensor:
    """The plain PyTorch version: per chunk of blocks, the segmented sum of
    the gathered rows, then ``@ w``.  The loop over blocks is the
    ``lax.scan`` of the reference's ``fused_gcn_layer`` (:186-193), taken a
    chunk of blocks at a time.  Returns ``(nblocks * tile_m, F_out)``."""
    nblocks, emax = src.shape
    step = blocks_per_chunk(emax, x.shape[1])
    out = torch.empty((nblocks * tile_m, w.shape[1]), dtype=w.dtype,
                      device=x.device)
    for b0 in range(0, nblocks, step):
        b1 = min(nblocks, b0 + step)
        agg = fold_blocks_plain(x, src[b0:b1], dstl[b0:b1], mask[b0:b1],
                                None, tile_m)
        out[b0 * tile_m:b1 * tile_m] = agg @ w
    return out


def smem_bytes(tile_m: int, f_out: int) -> int:
    """Dynamic shared memory one launch takes (mirrors the kernel's own
    ``fused_agg_combine_smem_bytes``): a (tile_m, 256) slab of the
    aggregate and the (tile_m, f_out) output sums, f32."""
    return (tile_m * 256 + tile_m * f_out) * 4


def fused_agg_combine(x: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                      mask: torch.Tensor, w: torch.Tensor, *,
                      tile_m: int) -> torch.Tensor:
    """Fused aggregate -> combine: the CUDA kernel for CUDA tensors, the
    plain version for tensors on the CPU.

    x: (V, F_in) f32; src, dstl: (nblocks, emax) int32 (``dstl`` in
    ``[0, tile_m)``, non-decreasing over the valid slots of a block, as
    ``core.dataflow.block_graph`` lays it out; ``src`` in ``[0, V)``);
    mask: (nblocks, emax) f32; w: (F_in, F_out) f32.  Returns
    (nblocks * tile_m, F_out) f32, computed in full f32 (no TF32).
    Launches on the current stream and does not synchronize.
    """
    if x.device.type == "cpu":
        return fused_agg_combine_plain(x, src, dstl, mask, w, tile_m=tile_m)
    nblocks, emax = src.shape
    f_in, f_out = (w.shape[0], w.shape[1]) if w.dim() == 2 else (-1, -1)
    lay = (nblocks, emax)
    _build.check_args("fused_agg_combine", x.device, {
        "x": (x, torch.float32, (None, f_in)),
        "src": (src, torch.int32, lay), "dstl": (dstl, torch.int32, lay),
        "mask": (mask, torch.float32, lay),
        "w": (w, torch.float32, (f_in, f_out))})
    if not (tile_m > 0 and nblocks > 0 and emax > 0 and f_out > 0):
        raise ValueError(f"fused_agg_combine: empty launch (tile_m={tile_m},"
                         f" layout {lay}, W {tuple(w.shape)})")
    limit = getattr(torch.cuda.get_device_properties(x.device),
                    "shared_memory_per_block_optin", _H100_SMEM_OPTIN)
    if smem_bytes(tile_m, f_out) + _STATIC_SMEM > limit:
        raise ValueError(
            f"fused_agg_combine: tile_m={tile_m} with F_out={f_out} needs "
            f"{smem_bytes(tile_m, f_out) + _STATIC_SMEM} bytes of shared "
            f"memory per block; this card allows {limit}")
    out = torch.empty((nblocks * tile_m, f_out), dtype=torch.float32,
                      device=x.device)
    fn = _build.load("fused_agg_combine").fused_agg_combine_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), src.data_ptr(), dstl.data_ptr(),
                 mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                 nblocks, emax, f_in, f_out, tile_m,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_agg_combine: kernel launch failed with "
                           f"CUDA error {err}")
    fused_agg_combine.launches += 1
    return out


fused_agg_combine.launches = 0
