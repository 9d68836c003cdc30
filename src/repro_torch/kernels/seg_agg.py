"""K1 ``seg_agg``: blocked segmented row sum, gather inside the kernel.

Port of the TPU kernel ``repro/kernels/seg_agg.py::seg_agg_blocked`` (:74)
to the hand-written CUDA kernel ``csrc/seg_agg.cu``.  The reference takes
pre-gathered ``(nblocks, emax, F)`` rows; this kernel takes ``x`` and the
blocked layout's ``src`` and gathers itself, so that slab never exists::

    out[b*tile_m + m] = sum_{e: dstl[b,e]=m, mask[b,e]!=0}
                            mask[b,e] * weight[b,e] * x[src[b,e]]

x and the output are f32 or bf16 (the reference's ``rows.dtype``); the
fold is f32 either way and a bf16 output is rounded once, at the store.
``out_dtype=torch.float32`` with bf16 x stores the f32 sums unrounded (the
entry ``seg_agg_bf16_f32``): a distributed layer's halo partials over a
bf16 wire slab, which the reference accumulates in f32.

``seg_agg`` is the wrapper: a tensor on the CPU takes ``seg_agg_plain``, a
CUDA tensor launches the kernel or raises.  It runs through the autograd
Function ``SegAgg``, whose backward for ``x`` is the same fold over the
transposed layout (``core.dataflow``)::

    gx[u] = sum_{slots e with src[e] = u} mask[e] * weight[e] * gout[dst[e]]

so on a card both directions launch the kernel.  Over a capped
transposed layout (``core.dataflow._transposed`` with a cap: rows cut
into pieces) the backward is two launches of the same kernel,
``fold_transposed``: the pieces' sums in f32, then the fold-back layout
adding each row's pieces in order, rounded once to x's dtype.
``seg_agg.launches`` counts the launches, ``seg_agg.launches_bf16`` the
bf16 ones,
``seg_agg.launches_bf16_f32`` those of bf16 x with an f32 output and
``seg_agg.launches_bwd`` the backward ones among them.  The kernel
walks x in column slices of ``slice_cols`` with 16-, 8-, 4- or (bf16)
2-byte loads (``launch_params``), both pure functions of the shapes, so
the CPU tests hold them; so are the split threshold and the shared
memory the chunk sums take (``split_threshold``, ``max_chunks``,
``fold_smem_bytes``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

#: bytes of gathered rows one plain-version step may hold; chunking over
#: blocks keeps Reddit at F=602 (28 GB of gathered rows) inside memory
PLAIN_CHUNK_BYTES = 1 << 28
#: widest slice, in columns: a lane of a fold unit holds at most 8 floats
#: of a slot.  Every slice is another pass over the indices and another
#: round of per-slot instructions, so the kernel takes the widest: on the
#: H100 at Reddit, 64-column slices (1.19 x the L2) beat 32-column ones
#: (0.6 x the L2) at F = 128 and 602
MAX_SLICE = 64
#: lanes of a fold unit (csrc/seg_agg.cu kLanes)
UNIT_LANES = 8
#: what a lane of a fold unit holds of one slot, in elements
LANE_ELEMS = 8
#: fold units of a CTA (csrc/seg_agg.cu kUnits): 256 threads of 8 lanes
FOLD_UNITS = 32
#: a row of at most MIN_SPLIT slots is never split: one in-order fold
MIN_SPLIT = 256
#: only a row of more than emax / SPLIT_WAYS slots is split, so a block
#: has at most SPLIT_WAYS split rows and their chunks' sums fit shared
#: memory
SPLIT_WAYS = 64
#: dynamic shared memory a CTA may take on the H100, and what it takes
#: without opting in (csrc/seg_agg.cu sets the attribute above that)
SMEM_LIMIT = 232448
SMEM_DEFAULT = 48 * 1024
#: the element types the kernel takes, with its C entry for each (the
#: output in x's dtype)
ENTRIES = {torch.float32: "seg_agg_f32", torch.bfloat16: "seg_agg_bf16"}
#: the element types that also take an f32 output, with that C entry
F32_OUT_ENTRIES = {torch.bfloat16: "seg_agg_bf16_f32"}


def fold_blocks_plain(x: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                      mask: torch.Tensor, weight: Optional[torch.Tensor],
                      tile_m: int) -> torch.Tensor:
    """Segmented sum of the gathered rows of a few blocks, plain PyTorch:
    ``(nb, emax)`` layout in, ``(nb * tile_m, F)`` f32 out.  The gathered
    rows are upcast to f32 (exact) before the coefficients; pad slots
    (``mask == 0``) are dropped with ``where``, never multiplied by 0."""
    nb = src.shape[0]
    coef = mask if weight is None else mask * weight
    rows = x[src.reshape(-1).long()]
    if rows.dtype != torch.float32:
        rows = rows.float()
    rows = rows * coef.reshape(-1, 1)
    rows = torch.where((mask != 0).reshape(-1, 1), rows, 0.0)
    seg = (torch.arange(nb, device=x.device)[:, None] * tile_m
           + dstl).reshape(-1).long()
    out = torch.zeros((nb * tile_m, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, seg, rows)


def blocks_per_chunk(emax: int, width: int) -> int:
    """Blocks one plain-version step folds (``PLAIN_CHUNK_BYTES`` of rows)."""
    return max(1, PLAIN_CHUNK_BYTES // max(1, emax * width * 4))


def seg_agg_plain(x: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                  mask: torch.Tensor, weight: Optional[torch.Tensor] = None,
                  *, tile_m: int,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same function, folded a
    chunk of blocks at a time in f32.  Returns ``(nblocks * tile_m, F)``
    in ``out_dtype`` (default x's dtype; one rounding for bf16)."""
    nblocks, emax = src.shape
    step = blocks_per_chunk(emax, x.shape[1])
    out = torch.empty((nblocks * tile_m, x.shape[1]),
                      dtype=out_dtype or x.dtype, device=x.device)
    for b0 in range(0, nblocks, step):
        b1 = min(nblocks, b0 + step)
        out[b0 * tile_m:b1 * tile_m] = fold_blocks_plain(
            x, src[b0:b1], dstl[b0:b1], mask[b0:b1],
            None if weight is None else weight[b0:b1], tile_m)
    return out


def slice_cols(f: int) -> int:
    """Columns per slice of x the kernel walks: all of F up to
    ``MAX_SLICE``; the last slice takes what is left."""
    return min(f, MAX_SLICE)


def backward_slice_cols(f: int, elt: int, align: int) -> int:
    """Columns per slice of K1's backward: one load a lane a slot, the
    widest that holds (``UNIT_LANES`` times the load ``launch_params``
    picks for F's widest slice, at most F): 32 at F = 128 in f32, 8 at F =
    41.  A transposed layout of a sampled block gathers each row about
    once, so wide slices buy no reuse there, while narrow ones spread a
    hub's block over more SMs and let more CTAs share one (measured on
    the H100 at phase 11's block 0: 32 columns beat 64 at F = 128, 8 beat
    41 at F = 41; chip_smoke.py phase 11)."""
    vec, _ = launch_params(f, slice_cols(f), elt, align)
    return min(f, UNIT_LANES * vec)


def launch_params(f: int, width: int, elt: int,
                  align: int) -> tuple[int, int]:
    """(vec, c): elements per load and loads per slot of one lane, for F
    columns of ``elt``-byte elements (4: f32, 2: bf16) walked in slices of
    ``width``, x's address a multiple of ``align`` bytes.  The widest load
    of 16, 8, 4 or 2 bytes (at least one element) whose element count
    divides F and the width and whose size divides ``align``; then
    c = ceil(width / (8 vec)) loads a slot for each of a fold unit's
    ``UNIT_LANES`` lanes.  For bf16: F = 128 takes 16-byte loads; F = 602
    (1,204-byte rows) 4-byte; F = 41 (82-byte rows) 2-byte."""
    vec = 1
    for nbytes in (16, 8, 4):
        n = nbytes // elt
        if f % n == 0 and width % n == 0 and align % nbytes == 0:
            vec = n
            break
    return vec, -(-width // (UNIT_LANES * vec))


def split_threshold(emax: int) -> int:
    """T in ``csrc/seg_agg.cu``: a row of more than T slots is split, a
    shorter one folded whole, in slot order.  A function of ``emax`` alone
    -- never of the layout's contents, so the shared memory is fixed by the
    shapes and a CUDA graph captured over one layout replays over any other
    of its shape: ``max(MIN_SPLIT, ceil(emax / SPLIT_WAYS))``."""
    return max(MIN_SPLIT, -(-int(emax) // SPLIT_WAYS))


def max_chunks(emax: int) -> int:
    """The most chunks a block of ``emax`` slots can hold: at most
    emax / (T + 1) rows are split, and each of the FOLD_UNITS - 1 unit
    starts cuts at most one of them once more."""
    return int(emax) // (split_threshold(emax) + 1) + FOLD_UNITS - 1


def fold_smem_bytes(tile_m: int, emax: int, width: int) -> int:
    """Dynamic shared memory of a fold CTA (``csrc/seg_agg.cu`` launch):
    the block's chunk table, 2 (tile_m + 1) ints, then an f32 sum of
    ``width`` columns for each chunk the block can hold."""
    return 4 * (2 * (tile_m + 1) + max_chunks(emax) * width)


def unit_starts(row_lengths) -> list[int]:
    """Where the kernel's fold units start in a block whose rows hold
    ``row_lengths`` valid slots: for each unit, a position of the block's
    W = n_valid + tile_m (row m's store at its first slot + m, its slots
    after it), ``k W // FOLD_UNITS``, so units share the slots to fold and
    the rows to store alike."""
    w = sum(int(n) for n in row_lengths) + len(row_lengths)
    return [k * w // FOLD_UNITS for k in range(1, FOLD_UNITS)]


def chunk_plan(row_lengths, emax: int) -> list[tuple[int, int, int, int]]:
    """The kernel's rows and chunks over one block of ``emax`` slots whose
    rows hold ``row_lengths`` valid slots: ``(row, first slot, end,
    ordinal)`` in slot order.  A row of at most ``split_threshold(emax)``
    slots (an empty one too) is one item, ``ordinal`` -1, folded in slot
    order and stored.  A longer row is cut at every unit start
    (``unit_starts``) strictly inside its slots; each chunk is folded in
    slot order from 0, and its sum (``ordinal``: its place in the block's
    chunk table) is added to the row's in chunk order."""
    t = split_threshold(emax)
    starts = unit_starts(row_lengths)
    items, slot, ordinal = [], 0, 0
    for row, n in enumerate(int(v) for v in row_lengths):
        if n <= t:
            items.append((row, slot, slot + n, -1))
        else:
            # the slot at position p of row `row` is p - row - 1
            cuts = [p - row - 1 for p in starts
                    if slot < p - row - 1 < slot + n]
            for a, b in zip([slot] + cuts, cuts + [slot + n]):
                items.append((row, a, b, ordinal))
                ordinal += 1
        slot += n
    if slot > emax:
        raise ValueError(f"rows of {slot} slots in a block of {emax}")
    return items


def alignment(t: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides ``t``'s address."""
    a = 16
    while t.data_ptr() % a:
        a //= 2
    return a


def _entry(kernel: str, dtype: torch.dtype,
           out_dtype: Optional[torch.dtype] = None) -> str:
    """The C entry for x's dtype and the output's (default x's); any other
    pair raises ``TypeError``."""
    if out_dtype in (None, dtype) and dtype in ENTRIES:
        return ENTRIES[dtype]
    if out_dtype == torch.float32 and dtype in F32_OUT_ENTRIES:
        return F32_OUT_ENTRIES[dtype]
    raise TypeError(f"{kernel}: x is {dtype} with a {out_dtype or dtype} "
                    f"output; the kernel takes "
                    f"{' or '.join(str(d) for d in ENTRIES)} with an output "
                    f"of x's dtype, or bf16 with an f32 output")


def _fold(x, src, dstl, mask, weight, tile_m: int, *,
          backward: bool = False,
          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One fold: the plain version on the CPU, the kernel on a card (a
    ``backward`` one -- narrow slices, CTAs block by block -- counted in
    ``seg_agg.launches_bwd`` too)."""
    if x.device.type == "cpu":
        return seg_agg_plain(x, src, dstl, mask, weight, tile_m=tile_m,
                             out_dtype=out_dtype)
    f = x.shape[-1]
    width = backward_slice_cols(f, x.element_size(), alignment(x)) \
        if backward else slice_cols(f)
    out = _launch(x, src, dstl, mask, weight, tile_m, width,
                  blocks_first=backward, out_dtype=out_dtype)
    if backward:
        seg_agg.launches_bwd += 1
    return out


def fold_transposed(g: torch.Tensor, t, weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """K1's backward fold of ``g`` over the transposed layout ``t`` (a
    ``core.dataflow.BlockedGraph``), ``(t rows, F)``: one backward launch,
    or over a capped layout two -- the pieces' sums in f32 (x's own dtype
    when uncapped), then ``t.fold`` adding each row's pieces in piece
    order, in f32.  ``weight``: the per-slot weights of ``t``'s slots.
    The plain version on the CPU, as ``_fold``."""
    if t.fold is None:
        return _fold(g, t.src, t.dstl, t.mask, weight, t.tile_m,
                     backward=True)
    parts = _fold(g, t.src, t.dstl, t.mask, weight, t.tile_m, backward=True,
                  out_dtype=torch.float32)
    f = t.fold
    return _fold(parts, f.src, f.dstl, f.mask, None, f.tile_m, backward=True)


class SegAgg(torch.autograd.Function):
    """K1 with its backward.  Forward: the fold.  Backward for ``x``: the
    same fold over the transposed layout (the one given, or else
    ``core.dataflow.transposed_layout`` of the forward one, built in this
    backward), the weights regrouped through its ``eidx``; over a capped
    transposed layout, the pieces and then the fold-back
    (``fold_transposed``), rounded once to x's dtype.  Nothing launches
    when ``x`` needs no gradient.  The layout, mask and weights get
    none."""

    @staticmethod
    def forward(ctx, x, src, dstl, mask, weight, tile_m, transposed,
                out_dtype=None):
        ctx.save_for_backward(src, dstl, mask, weight)
        ctx.tile_m, ctx.transposed, ctx.rows = tile_m, transposed, x.shape[0]
        ctx.x_dtype = x.dtype
        return _fold(x, src, dstl, mask, weight, tile_m, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, gout):
        if not ctx.needs_input_grad[0]:
            return (None,) * 8
        src, dstl, mask, weight = ctx.saved_tensors
        t = ctx.transposed
        if t is None:
            from repro_torch.core.dataflow import (BlockedGraph,
                                                   transposed_layout)
            t = transposed_layout(
                BlockedGraph(src, dstl, mask, ctx.tile_m, ctx.rows),
                ctx.rows)
        wt = None if weight is None else \
            weight.reshape(-1)[t.eidx.long()].contiguous()
        gx = fold_transposed(gout.contiguous(), t, wt)
        return (gx[:ctx.rows].to(ctx.x_dtype),) + (None,) * 7


def seg_agg(x: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
            mask: torch.Tensor, weight: Optional[torch.Tensor] = None,
            *, tile_m: int, transposed=None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Blocked segmented sum: the CUDA kernel for CUDA tensors, the plain
    version for tensors on the CPU, differentiable in ``x`` (``SegAgg``).

    x: (V, F) f32 or bf16; src, dstl: (nblocks, emax) int32 (``dstl`` in
    ``[0, tile_m)``; in each block the valid slots, ``mask != 0``, come
    first and are sorted by ``dstl``, as ``core.dataflow.block_graph`` lays
    them out; ``src`` in ``[0, V)``); mask, weight: (nblocks, emax) f32
    (``weight`` optional; neither may require a gradient); transposed: the
    layout's ``core.dataflow.BlockedGraph.transposed`` for the backward
    (its capped form too), or None to build it from this layout in each
    backward (a host regroup: callers that run many backward passes keep
    it); out_dtype:
    the output's dtype, default x's (``torch.float32`` with bf16 x: the
    f32 sums unrounded).
    Returns (nblocks * tile_m, F) in out_dtype: f32 sums, rounded once for
    a bf16 output.  Launches on the current stream and does not
    synchronize.
    """
    if torch.is_grad_enabled():
        if mask.requires_grad or (weight is not None and
                                  weight.requires_grad):
            raise ValueError("seg_agg: the mask and the edge weights get "
                             "no gradient; detach them")
        if x.requires_grad:
            return SegAgg.apply(x, src, dstl, mask, weight, tile_m,
                                transposed, out_dtype)
    # no gradient to carry
    return _fold(x, src, dstl, mask, weight, tile_m, out_dtype=out_dtype)


def _c_entry(entry: str):
    """The C entry's ctypes function, built and loaded at first use, its
    signature set once (a launch's host time is most of a small fold's)."""
    fn = _C_ENTRIES.get(entry)
    if fn is None:
        fn = getattr(_build.load("seg_agg"), entry)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _C_ENTRIES[entry] = fn
    return fn


_C_ENTRIES: dict = {}


def _launch(x, src, dstl, mask, weight, tile_m: int, width: int, *,
            blocks_first: bool = False,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Check the arguments and launch the kernel with column slices of
    ``width``; ``seg_agg`` passes ``slice_cols(F)``, the card tests force
    narrower slices through here.  ``blocks_first`` orders the CTAs block
    by block (K1's backward, whose layout gathers each row about once, so
    slice-major order has no reuse to keep; at most 65,535 blocks), else
    slice by slice; the sums are the same either way."""
    nblocks, emax = src.shape
    f = x.shape[1] if x.dim() == 2 else -1
    lay = (nblocks, emax)
    out_dtype = out_dtype or x.dtype
    entry = _entry("seg_agg", x.dtype, out_dtype)
    args = {"x": (x, x.dtype, (None, f)),
            "src": (src, torch.int32, lay), "dstl": (dstl, torch.int32, lay),
            "mask": (mask, torch.float32, lay)}
    if weight is not None:
        args["weight"] = (weight, torch.float32, lay)
    _build.check_args("seg_agg", x.device, args)
    if not (tile_m > 0 and nblocks > 0 and emax > 0 and f > 0):
        raise ValueError(f"seg_agg: empty launch (tile_m={tile_m}, "
                         f"layout {lay}, F={f})")
    if not 0 < width <= min(f, MAX_SLICE):
        raise ValueError(f"seg_agg: slice width {width} must be in "
                         f"[1, min(F={f}, {MAX_SLICE})]")
    smem = fold_smem_bytes(tile_m, emax, width)
    if smem > SMEM_LIMIT or 8 * (tile_m + 1) > SMEM_DEFAULT:
        raise ValueError(f"seg_agg: tile_m={tile_m}, emax={emax} need "
                         f"{smem} B of shared memory a CTA (at most "
                         f"{SMEM_LIMIT})")
    out = torch.empty((nblocks * tile_m, f), dtype=out_dtype,
                      device=x.device)
    # the chunk table: row starts and split chunks before each row, per
    # block, written by the first launch and read by the second
    tables = torch.empty((nblocks, 2 * (tile_m + 1)), dtype=torch.int32,
                         device=x.device)
    vec, c = launch_params(f, width, x.element_size(), alignment(x))
    fn = _c_entry(entry)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), src.data_ptr(), dstl.data_ptr(),
                 mask.data_ptr(),
                 None if weight is None else weight.data_ptr(),
                 tables.data_ptr(), out.data_ptr(), nblocks, emax, f, tile_m,
                 width, vec, c, split_threshold(emax), max_chunks(emax),
                 int(blocks_first and nblocks <= 65535),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"seg_agg: kernel launch failed with CUDA error "
                           f"{err}")
    seg_agg.launches += 1
    if x.dtype == torch.bfloat16:
        if out_dtype == torch.float32:
            seg_agg.launches_bf16_f32 += 1
        else:
            seg_agg.launches_bf16 += 1
    return out


seg_agg.launches = 0
seg_agg.launches_bf16 = 0
seg_agg.launches_bf16_f32 = 0
seg_agg.launches_bwd = 0
