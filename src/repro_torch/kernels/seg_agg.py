"""K1 ``seg_agg``: blocked segmented row sum, gather inside the kernel.

Port of the TPU kernel ``repro/kernels/seg_agg.py::seg_agg_blocked`` (:74)
to the hand-written CUDA kernel ``csrc/seg_agg.cu``.  The reference takes
pre-gathered ``(nblocks, emax, F)`` rows; this kernel takes ``x`` and the
blocked layout's ``src`` and gathers itself, so that slab never exists::

    out[b*tile_m + m] = sum_{e: dstl[b,e]=m, mask[b,e]!=0}
                            mask[b,e] * weight[b,e] * x[src[b,e]]

``seg_agg`` is the wrapper: a tensor on the CPU takes ``seg_agg_plain``, a
CUDA tensor launches the kernel or raises.  ``seg_agg.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

#: bytes of gathered rows one plain-version step may hold; chunking over
#: blocks keeps Reddit at F=602 (28 GB of gathered rows) inside memory
PLAIN_CHUNK_BYTES = 1 << 28


def fold_blocks_plain(x: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                      mask: torch.Tensor, weight: Optional[torch.Tensor],
                      tile_m: int) -> torch.Tensor:
    """Segmented sum of the gathered rows of a few blocks, plain PyTorch:
    ``(nb, emax)`` layout in, ``(nb * tile_m, F)`` out.  Pad slots
    (``mask == 0``) are dropped with ``where``, never multiplied by 0."""
    nb = src.shape[0]
    coef = mask if weight is None else mask * weight
    rows = x[src.reshape(-1).long()] * coef.reshape(-1, 1)
    rows = torch.where((mask != 0).reshape(-1, 1), rows, 0.0)
    seg = (torch.arange(nb, device=x.device)[:, None] * tile_m
           + dstl).reshape(-1).long()
    out = torch.zeros((nb * tile_m, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, rows)


def blocks_per_chunk(emax: int, width: int) -> int:
    """Blocks one plain-version step folds (``PLAIN_CHUNK_BYTES`` of rows)."""
    return max(1, PLAIN_CHUNK_BYTES // max(1, emax * width * 4))


def seg_agg_plain(x: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                  mask: torch.Tensor, weight: Optional[torch.Tensor] = None,
                  *, tile_m: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same function, folded a
    chunk of blocks at a time.  Returns ``(nblocks * tile_m, F)``."""
    nblocks, emax = src.shape
    step = blocks_per_chunk(emax, x.shape[1])
    out = torch.empty((nblocks * tile_m, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    for b0 in range(0, nblocks, step):
        b1 = min(nblocks, b0 + step)
        out[b0 * tile_m:b1 * tile_m] = fold_blocks_plain(
            x, src[b0:b1], dstl[b0:b1], mask[b0:b1],
            None if weight is None else weight[b0:b1], tile_m)
    return out


def seg_agg(x: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
            mask: torch.Tensor, weight: Optional[torch.Tensor] = None,
            *, tile_m: int) -> torch.Tensor:
    """Blocked segmented sum: the CUDA kernel for CUDA tensors, the plain
    version for tensors on the CPU.

    x: (V, F) f32; src, dstl: (nblocks, emax) int32 (``dstl`` in
    ``[0, tile_m)``, non-decreasing over the valid slots of a block, as
    ``core.dataflow.block_graph`` lays it out; ``src`` in ``[0, V)``);
    mask, weight: (nblocks, emax) f32 (``weight`` optional).  Returns
    (nblocks * tile_m, F) f32.  Launches on the current stream and does not
    synchronize.
    """
    if x.device.type == "cpu":
        return seg_agg_plain(x, src, dstl, mask, weight, tile_m=tile_m)
    nblocks, emax = src.shape
    f = x.shape[1] if x.dim() == 2 else -1
    lay = (nblocks, emax)
    args = {"x": (x, torch.float32, (None, f)),
            "src": (src, torch.int32, lay), "dstl": (dstl, torch.int32, lay),
            "mask": (mask, torch.float32, lay)}
    if weight is not None:
        args["weight"] = (weight, torch.float32, lay)
    _build.check_args("seg_agg", x.device, args)
    if not (tile_m > 0 and nblocks > 0 and emax > 0 and f > 0):
        raise ValueError(f"seg_agg: empty launch (tile_m={tile_m}, "
                         f"layout {lay}, F={f})")
    out = torch.empty((nblocks * tile_m, f), dtype=torch.float32,
                      device=x.device)
    fn = _build.load("seg_agg").seg_agg_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), src.data_ptr(), dstl.data_ptr(),
                 mask.data_ptr(),
                 None if weight is None else weight.data_ptr(),
                 out.data_ptr(), nblocks, emax, f, tile_m,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"seg_agg: kernel launch failed with CUDA error "
                           f"{err}")
    seg_agg.launches += 1
    return out


seg_agg.launches = 0
