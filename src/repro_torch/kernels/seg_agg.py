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
CUDA tensor launches the kernel or raises.  Each fold goes through one of
two opaque torch ops, ``repro_torch::seg_agg`` (``seg_agg_op``) and, with a
row map, ``repro_torch::seg_agg_packed`` (``seg_agg_packed_op``), whose
fake implementations give the output's shape and dtype alone: a
fake-tensor trace (``make_fx``, ``repro_torch.analysis``) sees K1 as one
node and launches nothing, and the counts below move in the ops' real
bodies only.  An eager call outside any trace runs the body directly
(``opaque_call``), without the op's dispatch cost.  It runs through the autograd
Function ``SegAgg``, whose backward for ``x`` is the same fold over the
transposed layout (``core.dataflow``)::

    gx[u] = sum_{slots e with src[e] = u} mask[e] * weight[e] * gout[dst[e]]

so on a card both directions launch the kernel.  Over a capped
transposed layout (``core.dataflow._transposed`` with a cap: packed
pieces of rows, each block row with a destination in the layout's row
map ``out_rows``) the backward is ``fold_transposed``: one launch that
stores each uncut row's f32 sum in place, once, and each piece of a cut
row to a scratch row after them; then, when some row was cut (and
always at a fixed capacity, where an empty fold-back stores nothing), a
second launch over the fold-back layout adding each cut row's pieces in
piece order into its row.  Both are packed launches: one kernel each,
warp-wide fold units, slices of ``packed_launch`` and the split
threshold ``packed_split``; the result is f32, rounded once to x's
dtype by ``SegAgg``.  ``seg_agg.launches`` counts the launches,
``seg_agg.launches_bf16`` the bf16 ones, ``seg_agg.launches_bf16_f32``
those of bf16 x with an f32 output and ``seg_agg.launches_bwd`` the
backward ones among them.  The kernel
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
#: a packed launch's fold unit (a launch with a row map, over a capped
#: transposed layout): one warp, so the lanes of a warp meet the same row
#: ends (its rows are short: most batches cross one); 8 units a CTA
PACKED_LANES = 32
PACKED_UNITS = 8
#: a packed launch's widest slice: 32 lanes of 4 floats
PACKED_SLICE = 128
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


def packed_launch(f: int, elt: int, align: int) -> tuple[int, bool]:
    """(columns per slice, CTAs block by block) of K1's packed launches,
    those over a capped transposed layout (``fold_transposed``): all of F
    up to ``PACKED_SLICE`` columns in one slice, slices in order."""
    return min(f, PACKED_SLICE), False


def launch_params(f: int, width: int, elt: int, align: int,
                  lanes: int = UNIT_LANES) -> tuple[int, int]:
    """(vec, c): elements per load and loads per slot of one lane, for F
    columns of ``elt``-byte elements (4: f32, 2: bf16) walked in slices of
    ``width``, x's address a multiple of ``align`` bytes, by fold units of
    ``lanes`` lanes.  The widest load of 16, 8, 4 or 2 bytes (at least one
    element) whose element count divides F and the width and whose size
    divides ``align`` -- in a packed launch (``PACKED_LANES``) also no
    wider than keeps every lane busy (lanes x vec <= width); then
    c = ceil(width / (lanes vec)) loads a slot for each lane.  For bf16
    with 8-lane units: F = 128 takes 16-byte loads; F = 602 (1,204-byte
    rows) 4-byte; F = 41 (82-byte rows) 2-byte."""
    vec = 1
    for nbytes in (16, 8, 4):
        n = nbytes // elt
        if f % n == 0 and width % n == 0 and align % nbytes == 0 and (
                lanes == UNIT_LANES or n * lanes <= width):
            vec = n
            break
    return vec, -(-width // (lanes * vec))


def split_threshold(emax: int) -> int:
    """T in ``csrc/seg_agg.cu``: a row of more than T slots is split, a
    shorter one folded whole, in slot order.  A function of ``emax`` alone
    -- never of the layout's contents, so the shared memory is fixed by the
    shapes and a CUDA graph captured over one layout replays over any other
    of its shape: ``max(MIN_SPLIT, ceil(emax / SPLIT_WAYS))``."""
    return max(MIN_SPLIT, -(-int(emax) // SPLIT_WAYS))


def packed_split(emax: int, tile_m: int) -> int:
    """The split threshold of K1's packed launches (over a capped
    transposed layout, ``fold_transposed``): a fold unit's share of a
    full block, ``(emax + tile_m) // PACKED_UNITS`` positions (at least
    1).  Its rows are pieces of ~12.5 slots on average (Reddit's shard
    sub-layouts), so
    a row far longer than a unit's share keeps one unit busy while the
    CTA's others idle; ``core.dataflow._capped`` stores in place only the
    rows of at most ``packed_split(cap, tile_m)`` slots, which K1 folds
    whole, and sends the longer ones through scratch rows, which K1
    splits across its units at this threshold."""
    return max(1, (int(emax) + int(tile_m)) // PACKED_UNITS)


def max_chunks(emax: int, split: Optional[int] = None,
               units: int = FOLD_UNITS) -> int:
    """The most chunks a block of ``emax`` slots can hold when rows of
    more than ``split`` slots (default ``split_threshold(emax)``) are
    split at the starts of ``units`` fold units: at most emax / (split +
    1) rows are, and each of the units - 1 unit starts cuts at most one of
    them once more."""
    split = split_threshold(emax) if split is None else split
    return int(emax) // (split + 1) + units - 1


def fold_smem_bytes(tile_m: int, emax: int, width: int,
                    mapped: bool = False,
                    split: Optional[int] = None) -> int:
    """Dynamic shared memory of a fold CTA (``csrc/seg_agg.cu`` launch):
    the block's chunk table, 2 (tile_m + 1) ints, its row map (tile_m
    ints, in a packed launch: ``mapped``), then an f32 sum of ``width``
    columns for each chunk the block can hold (``max_chunks``)."""
    units = PACKED_UNITS if mapped else FOLD_UNITS
    return 4 * (2 * (tile_m + 1) + (tile_m if mapped else 0)
                + max_chunks(emax, split, units) * width)


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


#: the tensor types an eager call may hand a kernel's body directly
_PLAIN_TENSORS = (torch.Tensor, torch.nn.Parameter)


def opaque_call(op, body, *args):
    """Call a kernel through its opaque op (``op``) where a tracer can see
    it -- under a dispatch mode (a fake-tensor or proxy trace), inside
    ``torch.compile``, or with a tensor subclass (a fake tensor) among the
    arguments -- and its body directly otherwise: the same function,
    without the custom op's dispatch cost, which an eager many-launch path
    (a halo's K1 over shard sub-layouts, K1's backward over their
    transposed ones) would pay on every launch (PERF.md §6 measures it on
    the H100's host)."""
    if torch._C._len_torch_dispatch_stack() or \
            torch.compiler.is_compiling() or \
            any(isinstance(a, torch.Tensor) and
                type(a) not in _PLAIN_TENSORS for a in args):
        return op(*args)
    return body(*args)


def _fold(x, src, dstl, mask, weight, tile_m: int, *,
          backward: bool = False,
          out_dtype: Optional[torch.dtype] = None,
          out: Optional[torch.Tensor] = None,
          out_rows: Optional[torch.Tensor] = None, split_from: int = 0,
          plain: bool = False) -> torch.Tensor:
    """One fold: the plain version when ``plain``, else K1's opaque op
    (``seg_agg_op``, or ``seg_agg_packed_op`` with a row map; its body
    directly outside a trace, ``opaque_call``), which runs the plain
    version on the CPU and the kernel on a card (a ``backward``
    one counted in ``seg_agg.launches_bwd`` too: without a row map narrow
    slices, CTAs block by block; with one ``packed_launch``'s).  With
    ``out_rows`` block row m of block b goes to row ``out_rows[b, m]`` of
    ``out`` (-1: nowhere), and ``out`` is returned."""
    if out_rows is None:
        if plain:
            return seg_agg_plain(x, src, dstl, mask, weight, tile_m=tile_m,
                                 out_dtype=out_dtype)
        return opaque_call(torch.ops.repro_torch.seg_agg.default,
                           _seg_agg_body, x, src, dstl, mask, weight, tile_m,
                           backward, out_dtype)
    if out_dtype not in (None, out.dtype):
        raise TypeError(f"seg_agg: a {out_dtype} fold stored into a "
                        f"{out.dtype} out")
    if plain:
        _store_plain(x, src, dstl, mask, weight, out, out_rows, tile_m)
    else:
        opaque_call(torch.ops.repro_torch.seg_agg_packed.default,
                    _seg_agg_packed_body, x, src, dstl, mask, weight, out,
                    out_rows, tile_m, split_from, backward)
    return out


def _store_plain(x, src, dstl, mask, weight, out, out_rows,
                 tile_m: int) -> None:
    """A packed fold's plain version: every block row with a destination
    in ``out_rows`` stored into that row of ``out``."""
    rows = seg_agg_plain(x, src, dstl, mask, weight, tile_m=tile_m,
                         out_dtype=out.dtype)
    to = out_rows.reshape(-1).long()
    keep = to >= 0
    out[to[keep]] = rows[keep]


def _seg_agg_body(x: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
                  mask: torch.Tensor, weight: Optional[torch.Tensor],
                  tile_m: int, backward: bool,
                  out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The body of K1's opaque op ``repro_torch::seg_agg`` (``seg_agg_op``):
    the fold, ``(nblocks * tile_m, F)`` in ``out_dtype`` (default x's): on
    the CPU the plain version, on a card
    one launch (``backward``: ``backward_slice_cols``'s slices, CTAs block
    by block; else ``slice_cols``'s) and its counts.  Its fake
    implementation gives the shape and dtype alone, so a fake-tensor trace
    (``repro_torch.analysis``) sees one node and launches nothing."""
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


seg_agg_op = torch.library.custom_op("repro_torch::seg_agg", _seg_agg_body,
                                     mutates_args=())


@seg_agg_op.register_fake
def _seg_agg_fake(x, src, dstl, mask, weight, tile_m, backward, out_dtype):
    _entry("seg_agg", x.dtype, out_dtype)
    return x.new_empty((src.shape[0] * tile_m, x.shape[-1]),
                       dtype=out_dtype or x.dtype)


def _seg_agg_packed_body(x: torch.Tensor, src: torch.Tensor,
                         dstl: torch.Tensor, mask: torch.Tensor,
                         weight: Optional[torch.Tensor], out: torch.Tensor,
                         out_rows: torch.Tensor, tile_m: int,
                         split_from: int, backward: bool) -> None:
    """The body of K1's opaque op ``repro_torch::seg_agg_packed``
    (``seg_agg_packed_op``): the packed fold (a row map ``out_rows``, over
    a capped transposed layout), stored into ``out`` in ``out``'s dtype:
    on the CPU the plain version, on a card one launch with
    ``packed_launch``'s slices and ``packed_split``'s threshold, the rows
    stored at or after ``split_from`` split.  Its fake implementation
    stores nothing."""
    if x.device.type == "cpu":
        _store_plain(x, src, dstl, mask, weight, out, out_rows, tile_m)
        return
    width, blocks_first = packed_launch(x.shape[-1], x.element_size(),
                                        alignment(x))
    _launch(x, src, dstl, mask, weight, tile_m, width,
            blocks_first=blocks_first, out_dtype=out.dtype, out=out,
            out_rows=out_rows, split_from=split_from,
            split=packed_split(src.shape[1], tile_m))
    if backward:
        seg_agg.launches_bwd += 1


seg_agg_packed_op = torch.library.custom_op(
    "repro_torch::seg_agg_packed", _seg_agg_packed_body,
    mutates_args=("out",))


@seg_agg_packed_op.register_fake
def _seg_agg_packed_fake(x, src, dstl, mask, weight, out, out_rows, tile_m,
                         split_from, backward):
    _entry("seg_agg", x.dtype, out.dtype)


def fold_transposed(g: torch.Tensor, t, weight: Optional[torch.Tensor] = None,
                    *, plain: bool = False) -> torch.Tensor:
    """K1's backward fold of ``g`` over the transposed layout ``t`` (a
    ``core.dataflow.BlockedGraph``), ``weight`` the per-slot weights of
    its slots.  Uncapped: one backward launch, ``(t rows, F)`` in g's
    dtype.  Capped (``t.out_rows``): ``(t.num_vertices + scratch, F)``
    f32, its first ``t.num_vertices`` rows the result -- the pieces'
    launch stores each uncut row there, its one in-order fold, and each
    piece of a cut row to a scratch row after them; the fold-back's
    launch (``t.fold``: when a row was cut, and always over a layout at a
    fixed capacity, whose fold-back with no row cut stores nothing) reads
    the scratch rows and adds each cut row's pieces in piece order into
    its row.  No row is written twice, and nothing is read back to the
    host, so the launches are the layout's alone.  The plain version on
    the CPU or when ``plain``, as ``_fold``."""
    if t.out_rows is None:
        return _fold(g, t.src, t.dstl, t.mask, weight, t.tile_m,
                     backward=True, plain=plain)
    n, f = t.num_vertices, t.fold
    out = torch.empty((n + (0 if f is None else f.num_vertices),
                       g.shape[1]), dtype=torch.float32, device=g.device)
    _fold(g, t.src, t.dstl, t.mask, weight, t.tile_m, backward=True,
          out_dtype=torch.float32, out=out, out_rows=t.out_rows,
          split_from=n, plain=plain)
    if f is not None:
        _fold(out[n:], f.src, f.dstl, f.mask, None, f.tile_m, backward=True,
              out=out, out_rows=f.out_rows, split_from=n, plain=plain)
    return out


class SegAgg(torch.autograd.Function):
    """K1 with its backward.  Forward: the fold.  Backward for ``x``: the
    same fold over the transposed layout (the one given, or else
    ``core.dataflow.transposed_layout`` of the forward one, built on the
    host in this backward -- which raises under a CUDA-graph capture, as
    ``kernels.ops.seg_agg`` does: a captured backward takes its
    transposed layout with the forward one), the weights regrouped
    through its ``eidx``; over a capped transposed layout, the pieces and
    the fold-back (``fold_transposed``), rounded once to x's dtype.
    Nothing launches when ``x`` needs no gradient.  The layout, mask and
    weights get none."""

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
            if gout.is_cuda and torch.cuda.is_current_stream_capturing():
                raise ValueError(
                    "K1's backward builds a missing transposed layout on "
                    "the host, which a CUDA-graph capture cannot run; pass "
                    "the layout's transposed one (transposed=, "
                    "plan.runtime_layout(..., transposed=True))")
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
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _C_ENTRIES[entry] = fn
    return fn


_C_ENTRIES: dict = {}


def _launch(x, src, dstl, mask, weight, tile_m: int, width: int, *,
            blocks_first: bool = False,
            out_dtype: Optional[torch.dtype] = None,
            out: Optional[torch.Tensor] = None,
            out_rows: Optional[torch.Tensor] = None,
            split_from: int = 0,
            split: Optional[int] = None) -> torch.Tensor:
    """Check the arguments and launch the kernel with column slices of
    ``width``; ``seg_agg`` passes ``slice_cols(F)``, the card tests force
    narrower slices through here.  ``blocks_first`` orders the CTAs block
    by block (K1's backward, whose layout gathers each row about once, so
    slice-major order has no reuse to keep; at most 65,535 blocks), else
    slice by slice; the sums are the same either way.  Rows of more than
    ``split`` slots (default T, ``split_threshold(emax)``) are split.
    ``out_rows``, an ``(nblocks, tile_m)`` int32 row map, makes the launch
    packed: block row m of block b goes to row ``out_rows[b, m]`` of
    ``out`` (given, ``(R, F)`` of ``out_dtype``; the map's entries in
    ``[-1, R)``, -1 not stored, x's rows apart from the stored ones), only
    the rows stored at or after row ``split_from`` are split, a fold unit
    is a warp (``PACKED_LANES``, slices up to ``PACKED_SLICE`` columns)
    and the launch is one kernel.  Else the output is a new ``(nblocks *
    tile_m, F)``."""
    nblocks, emax = src.shape
    packed = out_rows is not None
    f = x.shape[1] if x.dim() == 2 else -1
    lay = (nblocks, emax)
    out_dtype = out_dtype or x.dtype
    entry = _entry("seg_agg", x.dtype, out_dtype)
    args = {"x": (x, x.dtype, (None, f)),
            "src": (src, torch.int32, lay), "dstl": (dstl, torch.int32, lay),
            "mask": (mask, torch.float32, lay)}
    if weight is not None:
        args["weight"] = (weight, torch.float32, lay)
    if packed:
        if out is None:
            raise ValueError("seg_agg: a row map stores into a given out")
        args["out_rows"] = (out_rows, torch.int32, (nblocks, tile_m))
        args["out"] = (out, out_dtype, (None, f))
    _build.check_args("seg_agg", x.device, args)
    if not (tile_m > 0 and nblocks > 0 and emax > 0 and f > 0):
        raise ValueError(f"seg_agg: empty launch (tile_m={tile_m}, "
                         f"layout {lay}, F={f})")
    widest = PACKED_SLICE if packed else MAX_SLICE
    if not 0 < width <= min(f, widest):
        raise ValueError(f"seg_agg: slice width {width} must be in "
                         f"[1, min(F={f}, {widest})]")
    split = split_threshold(emax) if split is None else split
    smem = fold_smem_bytes(tile_m, emax, width, packed, split)
    if smem > SMEM_LIMIT or 8 * (tile_m + 1) > SMEM_DEFAULT:
        raise ValueError(f"seg_agg: tile_m={tile_m}, emax={emax} need "
                         f"{smem} B of shared memory a CTA (at most "
                         f"{SMEM_LIMIT})")
    tables = None
    if not packed:
        out = torch.empty((nblocks * tile_m, f), dtype=out_dtype,
                          device=x.device)
        # the chunk table: row starts and split chunks before each row, per
        # block, written by the first launch and read by the second (a
        # packed launch's CTAs build their own in shared memory)
        tables = torch.empty((nblocks, 2 * (tile_m + 1)), dtype=torch.int32,
                             device=x.device)
    vec, c = launch_params(f, width, x.element_size(), alignment(x),
                           PACKED_LANES if packed else UNIT_LANES)
    fn = _c_entry(entry)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), src.data_ptr(), dstl.data_ptr(),
                 mask.data_ptr(),
                 None if weight is None else weight.data_ptr(),
                 None if tables is None else tables.data_ptr(),
                 out.data_ptr(),
                 None if out_rows is None else out_rows.data_ptr(), nblocks,
                 emax, f, tile_m, width, vec, c, split,
                 max_chunks(emax, split,
                            PACKED_UNITS if packed else FOLD_UNITS),
                 int(blocks_first and nblocks <= 65535),
                 split_from, torch.cuda.current_stream().cuda_stream)
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
