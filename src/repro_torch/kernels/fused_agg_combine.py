"""K2 ``fused_agg_combine``: blocked segmented sum fused with ``@ W``.

Port of the TPU kernel
``repro/kernels/fused_agg_combine.py::fused_agg_combine_blocked`` (:73) to
the hand-written CUDA kernel ``csrc/fused_agg_combine.cu``.  Per
destination block of ``tile_m`` rows, the block's gathered rows are summed
on chip and multiplied by ``W`` before anything is written::

    out[b*tile_m + m] = (sum_{e: dstl[b,e]=m, mask[b,e]!=0}
                             mask[b,e] * x[src[b,e]]) @ W

The kernel folds 64 destination rows per CTA, 64 input columns at a time,
and multiplies each slice on the tensor cores in 3xTF32 (f32 accuracy).

Three (x, W) dtype pairs are instantiated, the output in W's dtype as the
reference's: (f32, f32); (bf16, bf16), a bf16 plan's fused layer; and
(f32, bf16), a bf16 plan's fused dedup layer, whose ``[x ; partials]``
rows are f32.  The fold and the product accumulate in f32 either way and
a bf16 output is rounded once.  A bf16 W is exact in TF32, so its low
part is 0 and the bf16-W instances take two TF32 products, not three.

``fused_agg_combine`` is the wrapper: a tensor on the CPU takes
``fused_agg_combine_plain``, a CUDA tensor launches the kernel or raises.
Both go through one opaque torch op, ``repro_torch::fused_agg_combine``
(``fused_agg_combine_op``), whose fake implementation gives the output's
shape and dtype alone, so a fake-tensor trace sees K2 as one node and
launches nothing; the counts below move in its real body only.  An eager
call outside any trace runs the body directly
(``kernels.seg_agg.opaque_call``).
``fused_agg_combine.launches`` counts the launches,
``fused_agg_combine.launches_bf16`` those with a bf16 W among them and
``fused_agg_combine.launches_mixed`` those of the (f32, bf16) pair.  The
launch shapes (``cols_per_wg``, ``smem_bytes``, ``slot_capacity``,
``scratch_bytes``) are pure functions of the shapes, so the CPU tests hold
them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.seg_agg import (alignment, blocks_per_chunk,
                                         fold_blocks_plain, launch_params,
                                         opaque_call)

#: per-block shared memory limit (opt-in) of the H100
_H100_SMEM_OPTIN = 232448
#: shared memory a CTA may take for two CTAs to share an H100 SM (228 KB
#: an SM, 1 KB of it reserved per CTA)
SMEM_TWO_PER_SM = (233472 - 2 * 1024) // 2
#: destination rows of a CTA (one wgmma M), input columns of a K-slice,
#: warpgroups of a CTA (each owns half of the output columns)
CTA_ROWS = 64
SLICE = 64
WARPGROUPS = 2
#: output columns of one fused launch; wider W runs one launch per 128
MAX_COLS = 128
#: output columns a warpgroup may own: the instantiated wgmma widths
WG_COLS = (8, 16, 24, 32, 48, 64)
#: lanes of a fold unit (csrc/fused_agg_combine.cu kLanes): a lane loads
#: at most SLICE / FOLD_LANES = 4 elements of a slot at once
FOLD_LANES = 16
#: the instantiated (x dtype, W dtype) pairs, with their C entry's code
PAIRS = {(torch.float32, torch.float32): 0,
         (torch.bfloat16, torch.bfloat16): 1,
         (torch.float32, torch.bfloat16): 2}
#: the kernel's accuracy against its plain version, beside the max-abs f32
#: band: each output row's largest error over that row's largest magnitude,
#: and the relative Frobenius error.  3xTF32 keeps about 22 mantissa bits:
#: on the H100 the kernel reads at most 2.0e-06 / 6.2e-07 at chip_smoke.py's
#: six shapes; one TF32 product keeps 10 and reads at least 5.7e-04 /
#: 2.9e-04 (PERF.md), so it must fail both
ROW_LIMIT = 3e-5
FRO_LIMIT = 1e-5


def fused_agg_combine_plain(x: torch.Tensor, src: torch.Tensor,
                            dstl: torch.Tensor, mask: torch.Tensor,
                            w: torch.Tensor, *, tile_m: int) -> torch.Tensor:
    """The plain PyTorch version: per chunk of blocks, the segmented sum of
    the gathered rows in f32, then ``@ w`` in f32 (a bf16 W upcast, which
    is exact), rounded once to W's dtype.  The loop over blocks is the
    ``lax.scan`` of the reference's ``fused_gcn_layer`` (:186-193), taken a
    chunk of blocks at a time.  Returns ``(nblocks * tile_m, F_out)`` in
    ``w.dtype``."""
    nblocks, emax = src.shape
    step = blocks_per_chunk(emax, x.shape[1])
    wf = w if w.dtype == torch.float32 else w.float()
    out = torch.empty((nblocks * tile_m, w.shape[1]), dtype=w.dtype,
                      device=x.device)
    for b0 in range(0, nblocks, step):
        b1 = min(nblocks, b0 + step)
        agg = fold_blocks_plain(x, src[b0:b1], dstl[b0:b1], mask[b0:b1],
                                None, tile_m)
        out[b0 * tile_m:b1 * tile_m] = agg @ wf
    return out


def pair_code(x_dtype: torch.dtype, w_dtype: torch.dtype) -> int:
    """The C entry's code for an (x, W) dtype pair (``PAIRS``); a pair the
    kernel is not instantiated for raises ``TypeError``."""
    try:
        return PAIRS[(x_dtype, w_dtype)]
    except KeyError:
        raise TypeError(
            f"fused_agg_combine: x {x_dtype} with W {w_dtype}; the kernel "
            f"takes (x, W) in " + ", ".join(
                f"({a}, {b})" for a, b in PAIRS)) from None


def load_vec(f_in: int, elt: int, align: int) -> int:
    """Elements a fold lane loads at once for ``f_in`` columns of
    ``elt``-byte elements at an address that is a multiple of ``align``:
    ``seg_agg``'s load for 64-column slices (slices start at multiples of
    64 columns, so every slice keeps x's alignment), at most
    ``SLICE // FOLD_LANES`` = 4 elements (8 bytes of bf16)."""
    return min(launch_params(f_in, SLICE, elt, align)[0],
               SLICE // FOLD_LANES)


def cols_per_wg(ncols: int) -> int:
    """Output columns each of the kernel's two warpgroups owns in a launch
    of ``ncols`` (<= MAX_COLS) columns: half of them rounded up to 8, then
    up to an instantiated wgmma width (``fused_agg_combine.cu``
    ``cols_per_wg``)."""
    half = (-(-ncols // 8) * 8 + 1) // 2
    return next(n for n in WG_COLS if n >= half)


def smem_bytes(f_out: int, cap: int) -> int:
    """Dynamic shared memory of the widest fused launch for ``f_out``
    columns with ``cap`` staged slots (the kernel's ``smem_bytes_for``):
    1 KB of alignment slack, the A tile's hi and lo parts (2 x 16 KB), one
    stage of the W image (32 K columns, hi and lo: 256 bytes per image row,
    one row per output column of the two warpgroups), the f32 running sum
    (64 rows of the image's width plus 8), 1 KB of row starts and segment
    tables, and 4 bytes per staged slot.  The kernel reserves no static
    shared memory."""
    nw = WARPGROUPS * cols_per_wg(min(f_out, MAX_COLS))
    return (1024 + 2 * CTA_ROWS * SLICE * 4 + nw * SLICE * 4
            + CTA_ROWS * (nw + 8) * 4 + 1024 + 4 * cap)


def slot_capacity(tile_m: int, emax: int, f_out: int) -> int:
    """Slots whose ``src`` a CTA stages in shared memory: all a CTA can
    hold (64 / tile_m blocks' emax, or one block's), as far as two CTAs
    still share an SM.  A CTA with more valid slots reads them from L2 in
    every slice instead."""
    most = (CTA_ROWS // tile_m if tile_m <= CTA_ROWS else 1) * emax
    return max(0, min(most, (SMEM_TWO_PER_SM - smem_bytes(f_out, 0)) // 4))


def scratch_bytes(f_in: int, f_out: int) -> int:
    """Bytes of the W image the prepass writes: per 64-column K-slice, 512
    bytes per image row (hi and lo), one row per output column of the two
    warpgroups."""
    return (-(-f_in // SLICE) * 512 * WARPGROUPS
            * cols_per_wg(min(f_out, MAX_COLS)))


def _is_cpu(t: torch.Tensor) -> bool:
    """True when ``t`` takes the plain version (it lies on the CPU)."""
    return t.device.type == "cpu"


def fused_agg_combine(x: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                      mask: torch.Tensor, w: torch.Tensor, *,
                      tile_m: int) -> torch.Tensor:
    """Fused aggregate -> combine: the CUDA kernel for CUDA tensors, the
    plain version for tensors on the CPU.

    x: (V, F_in); src, dstl: (nblocks, emax) int32 (``dstl`` in
    ``[0, tile_m)``; in each block the valid slots, ``mask != 0``, come
    first and are sorted by ``dstl``, as ``core.dataflow.block_graph`` lays
    them out; ``src`` in ``[0, V)``); mask: (nblocks, emax) f32; w:
    (F_in, F_out); (x, w) f32 and f32, bf16 and bf16, or f32 and bf16
    (``PAIRS``).  Returns (nblocks * tile_m, F_out) in w's dtype: the
    aggregate and the product (3xTF32, or two TF32 products for a bf16 W,
    which TF32 holds exactly) to f32 accuracy, rounded once for bf16.
    Launches on the current stream and does not synchronize.

    The kernel has no backward: on a card, an ``x`` or ``w`` that requires
    a gradient (with grad mode on) raises ``NotImplementedError`` rather
    than cutting the gradient.  Train with unfused plans.
    """
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if _is_cpu(x) and grad:
        # the plain version is differentiable as it stands; the op is not
        return fused_agg_combine_plain(x, src, dstl, mask, w, tile_m=tile_m)
    if grad:
        raise NotImplementedError(
            "fused_agg_combine has no backward on the card (ROADMAP §2: K2 "
            "backward for a fused training path); train with fused=False, "
            "whose aggregation K1 differentiates")
    return opaque_call(torch.ops.repro_torch.fused_agg_combine.default,
                       _fused_agg_combine_body, x, src, dstl, mask, w, tile_m)


def _fused_agg_combine_body(x: torch.Tensor, src: torch.Tensor,
                            dstl: torch.Tensor, mask: torch.Tensor,
                            w: torch.Tensor, tile_m: int) -> torch.Tensor:
    """The body of K2's opaque op ``repro_torch::fused_agg_combine``
    (``fused_agg_combine_op``) for its three (x, W) pairs: on the CPU the
    plain version, on a card the prepass and the kernel, and their
    counts.  ``(nblocks * tile_m, F_out)`` in W's dtype."""
    if _is_cpu(x):
        return fused_agg_combine_plain(x, src, dstl, mask, w, tile_m=tile_m)
    out = _launch(x, src, dstl, mask, w, tile_m)
    fused_agg_combine.launches += 1
    if w.dtype == torch.bfloat16:
        fused_agg_combine.launches_bf16 += 1
        if x.dtype == torch.float32:
            fused_agg_combine.launches_mixed += 1
    return out


fused_agg_combine_op = torch.library.custom_op(
    "repro_torch::fused_agg_combine", _fused_agg_combine_body,
    mutates_args=())


@fused_agg_combine_op.register_fake
def _fused_agg_combine_fake(x, src, dstl, mask, w, tile_m):
    pair_code(x.dtype, w.dtype)
    return x.new_empty((src.shape[0] * tile_m, w.shape[-1]), dtype=w.dtype)


def _launch(x, src, dstl, mask, w, tile_m: int, *, terms: int = 3,
            cap: int | None = None) -> torch.Tensor:
    """Check the arguments and launch the prepass and the kernel.
    ``fused_agg_combine`` passes the defaults; ``terms=1`` (one TF32
    product, a control that must fail the f32 checks) and ``cap`` (staged
    slots per CTA; 0 reads every index from L2) are for ``chip_smoke.py``
    and the card tests."""
    nblocks, emax = src.shape
    f_in, f_out = (w.shape[0], w.shape[1]) if w.dim() == 2 else (-1, -1)
    lay = (nblocks, emax)
    pair = pair_code(x.dtype, w.dtype)
    _build.check_args("fused_agg_combine", x.device, {
        "x": (x, x.dtype, (None, f_in)),
        "src": (src, torch.int32, lay), "dstl": (dstl, torch.int32, lay),
        "mask": (mask, torch.float32, lay),
        "w": (w, w.dtype, (f_in, f_out))})
    if not (tile_m > 0 and nblocks > 0 and emax > 0 and f_in > 0
            and f_out > 0):
        raise ValueError(f"fused_agg_combine: empty launch (tile_m={tile_m},"
                         f" layout {lay}, W {tuple(w.shape)})")
    if terms not in (1, 3):
        raise ValueError(f"fused_agg_combine: terms must be 1 or 3, got "
                         f"{terms}")
    if cap is None:
        cap = slot_capacity(tile_m, emax, f_out)
    limit = getattr(torch.cuda.get_device_properties(x.device),
                    "shared_memory_per_block_optin", _H100_SMEM_OPTIN)
    if smem_bytes(f_out, cap) > limit:
        raise ValueError(
            f"fused_agg_combine: F_out={f_out} with {cap} staged slots needs "
            f"{smem_bytes(f_out, cap)} bytes of shared memory per block; "
            f"this card allows {limit}")
    out = torch.empty((nblocks * tile_m, f_out), dtype=w.dtype,
                      device=x.device)
    wimg = torch.empty(scratch_bytes(f_in, f_out), dtype=torch.uint8,
                       device=x.device)
    vec = load_vec(f_in, x.element_size(), alignment(x))
    fn = _build.load("fused_agg_combine").fused_agg_combine
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), src.data_ptr(), dstl.data_ptr(),
                 mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                 wimg.data_ptr(), nblocks, emax, f_in, f_out, tile_m, vec,
                 cap, terms, pair, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_agg_combine: kernel launch failed with "
                           f"CUDA error {err}")
    return out


fused_agg_combine.launches = 0
fused_agg_combine.launches_bf16 = 0
fused_agg_combine.launches_mixed = 0
