"""Blocked layouts and the fused aggregate->combine layer
(``repro/core/dataflow.py``; paper F5, §5.1-3).

Destination vertices are processed in blocks of ``tile_m`` rows; each block
is aggregated and immediately combined, so the (V, F_in) aggregate never
makes a round trip through device memory.  ``block_graph`` regroups a
destination-sorted edge list into that layout once, on the host;
``suggest_tile_m`` sizes the block for a ``Machine``; ``fused_gcn_layer``
runs it on either tier:

  * ``torch`` -- the fused kernel's plain version: a loop over chunks of
    blocks (the reference's ``lax.scan`` over blocks, :186-193).
  * ``cuda``  -- the ``fused_agg_combine`` CUDA kernel.

K1's backward (``kernels.seg_agg.SegAgg``) is K1 over the TRANSPOSED
layout: the same edges regrouped by source, each slot naming the forward
slot it mirrors, so per-edge weights regroup with one gather.
``block_graph_arrays(..., transpose_rows=)`` builds both at once from
host arrays (the minibatch trainer's runtime layouts, capped, at a fixed
capacity for a CUDA-graph capture); ``transposed_layout`` builds it from
a layout already on the device (a plan keeps the capped one of each
layout it owns, ``GraphExecutionPlan.with_transposed``).

A hub source makes the transposed layout's block as long as its row: a
dense ``(nblocks, emax)`` array then holds many times the edges (the
distributed plans' shard sub-layouts of Reddit, 86.5x).
``_transposed(..., cap)`` builds the CAPPED form instead (the halos'
backward layouts, ``core.distributed.shard_transposed_layouts``, the
layouts a plan keeps for its own and a runtime graph's; ``TRANSPOSE_CAP``
slots): each row is one piece, or, over
``cap`` slots, cut into pieces of at most ``cap``; the pieces are packed
in order into blocks of at most ``tile_m`` pieces and ``cap`` slots, and
a row map (``BlockedGraph.out_rows``) gives each block row its
destination: a short row's own row, written once and in place (an empty
row too, by a piece of no slots), a piece of a cut row -- one longer
than about a fold unit's share of a block, which K1 splits across its
fold units -- a scratch row after the rows, an unused block row none.  A
small fold-back layout (``BlockedGraph.fold``) holds the cut rows only,
each gathering its scratch rows in piece order into its own row.  K1
runs the pieces, then, only when a row was cut, the fold-back: no row is
longer than ``cap`` slots, none is written twice, every row stored in
place is one in-order fold, and no atomics are needed.  At a fixed capacity
(``transposed_capacity``: the shapes that hold any graph of a bucket's
edge count) the layout has a fold-back always, an empty one when no row
is cut, so K1's backward over it launches the same kernels every time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.graph.structure import Graph
from repro_torch.profile.machine import Machine, get_machine

#: slots a row of a capped transposed layout holds at most, and a block of
#: its pieces (``_transposed``'s ``cap``): the layouts a plan keeps for its
#: own layouts (``GraphExecutionPlan.with_transposed``), a runtime graph's
#: (``GraphExecutionPlan.runtime_layout``) and the halos' backward shard
#: sub-layouts (``core.distributed.shard_transposed_layouts``, which
#: re-exports it).  At Reddit's 4 shards the uncapped sub-layouts would
#: hold 86.5x the edges (a hub source's row fills its block); capped they
#: hold under 2x, fold-backs included (``chip_smoke.py`` phase 14 counts
#: both).  2,048 rather than 1,024: blocks of 128 pieces then fill before
#: their slots do, and a hub row folds back from half the pieces (K1's
#: backward over the 16 sub-layouts on the H100, ``chip_smoke.py`` phase
#: 14)
TRANSPOSE_CAP = 2048


class BlockedGraph(NamedTuple):
    """Edges regrouped by destination block (``BlockedGraph``, :41).

    src:   (nblocks, emax) int32 global source ids (pad slots: 0).
    dstl:  (nblocks, emax) int32 destination row LOCAL to the block; over a
           block's valid slots it is non-decreasing (the kernels rely on it).
    mask:  (nblocks, emax) f32, 1 for a real edge, 0 for a pad slot.
    tile_m: rows per block; num_vertices: real vertex count.
    eidx:  (nblocks, emax) int32 original edge index of each slot (pad
           slots: 0), so per-edge data regroups with one gather; in a
           transposed layout, the forward layout's slot (``b * emax + j``)
           each slot mirrors.
    transposed: the layout K1's backward runs over (rows: the sources),
           or None (``transposed_layout`` builds it from this one).
    fold:  on a capped transposed layout with a cut row, the fold-back
           layout: one row a cut source, whose slots gather its pieces'
           scratch rows (``src``: 0 .. scratch - 1) in piece order, its
           ``out_rows`` the source's row and its ``num_vertices`` the
           scratch rows; else None.
    out_rows: on a capped transposed layout (and its fold-back), the
           ``(nblocks, tile_m)`` int32 row map: where K1 stores each
           block row -- an uncut source's piece at the source's row in
           ``[0, num_vertices)``, a cut source's piece at scratch row
           ``num_vertices + i``, an unused block row -1 (not stored);
           else None.
    """

    src: torch.Tensor
    dstl: torch.Tensor
    mask: torch.Tensor
    tile_m: int
    num_vertices: int
    eidx: Optional[torch.Tensor] = None
    transposed: Optional["BlockedGraph"] = None
    fold: Optional["BlockedGraph"] = None
    out_rows: Optional[torch.Tensor] = None

    @property
    def nblocks(self) -> int:
        return int(self.src.shape[0])

    @property
    def emax(self) -> int:
        return int(self.src.shape[1])

    def to(self, device) -> "BlockedGraph":
        """The same layout (its transposed and fold-back ones and its row
        map too) on ``device``."""
        return self._replace(
            src=self.src.to(device), dstl=self.dstl.to(device),
            mask=self.mask.to(device),
            eidx=None if self.eidx is None else self.eidx.to(device),
            transposed=None if self.transposed is None
            else self.transposed.to(device),
            fold=None if self.fold is None else self.fold.to(device),
            out_rows=None if self.out_rows is None
            else self.out_rows.to(device))


def block_offsets(block_ids: np.ndarray, nblocks: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-edge offset within its block (``block_offsets``, :70).

    ``block_ids`` must be non-decreasing (edges are dst-sorted).  Returns
    (counts, offsets): edge e lands at [block_ids[e], offsets[e]].
    """
    counts = np.bincount(block_ids, minlength=nblocks)
    starts = np.zeros(nblocks + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    offsets = np.arange(len(block_ids), dtype=np.int64) - starts[block_ids]
    return counts, offsets


def block_graph(g: Graph, tile_m: int) -> BlockedGraph:
    """Host-side regroup of a destination-sorted graph into row blocks
    (``block_graph``, :85), placed on the graph's device."""
    return block_graph_arrays(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                              g.num_vertices, tile_m, device=g.device)


def _block_layout(src: np.ndarray, dst: np.ndarray, v: int, tile_m: int,
                  dev, emax: Optional[int] = None,
                  eidx: Optional[np.ndarray] = None):
    """The layout of dst-sorted edges on ``dev`` and each edge's slot
    ``b * emax + j``.  The slots are placed on the host; the padded arrays
    are made on ``dev`` and only the edges' entries are copied there.
    ``emax`` fixes the slots per block (a block with more edges raises);
    by default it is the largest block's edge count rounded up to 8 (at
    least 8).  ``eidx`` gives each edge's ``eidx`` entry (default: its
    index)."""
    nblocks = -(-v // tile_m)
    blk = dst // tile_m
    counts, offs = block_offsets(blk, nblocks)
    most = int(counts.max()) if len(src) else 0
    if emax is None:
        emax = max(8, -(-max(most, 1) // 8) * 8)
    elif most > emax:
        raise ValueError(f"a block of {tile_m} rows holds {most} edges, "
                         f"over the layout's capacity of {emax} slots")
    slot = blk * emax + offs
    at = torch.from_numpy(slot).to(dev)

    def place(values, dtype):
        t = torch.from_numpy(np.ascontiguousarray(values, dtype))
        out = torch.zeros(nblocks * emax, dtype=t.dtype, device=dev)
        out[at] = t.to(dev)
        return out.view(nblocks, emax)

    if eidx is None:
        eidx = np.arange(len(src))
    bg = BlockedGraph(place(src, np.int32),
                      place(dst - blk * tile_m, np.int32),
                      place(np.ones(len(src)), np.float32), tile_m, v,
                      place(eidx, np.int32))
    return bg, slot


def _transposed(src: np.ndarray, dst: np.ndarray, slot: np.ndarray,
                num_rows: int, tile_m: int, dev,
                cap: Optional[int] = None,
                max_edges: Optional[int] = None) -> BlockedGraph:
    """The transposed layout of edges ``src -> dst`` held in forward slots
    ``slot``: regrouped by source (stable, so each source keeps its edges'
    forward order), gathering from the destinations, ``eidx`` the forward
    slots; with ``cap``, its capped form (``_capped``), and with
    ``max_edges`` too, that form at the capacity of any ``max_edges``
    edges over ``num_rows`` rows (``transposed_capacity``)."""
    order = _stable_order(src)
    if cap is not None:
        return _capped(dst[order], src[order], slot[order], num_rows,
                       tile_m, dev, int(cap), max_edges)
    return _block_layout(dst[order], src[order], num_rows, tile_m, dev,
                         eidx=slot[order])[0]


def _stable_order(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` of non-negative integer keys,
    by one unstable sort of the distinct keys ``key * n + index`` --
    several times faster than numpy's stable sort (a merge sort) on the
    10^5 edges of a sampled block -- where those fit an int64."""
    n = len(keys)
    if n and int(keys.max()) >= (1 << 62) // n:
        return np.argsort(keys, kind="stable")
    return np.sort(keys.astype(np.int64) * n + np.arange(n)) % max(n, 1)


def pack_pieces(lengths: np.ndarray, tile_m: int, cap: int) -> np.ndarray:
    """First piece of each block when pieces of ``lengths`` slots (each at
    most ``cap``) are packed in order, greedily: a block takes pieces while
    it holds fewer than ``tile_m`` and their slots stay within ``cap``."""
    ends = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    n = len(lengths)
    # whether the next tile_m pieces (or the rest) fit from each piece on,
    # all at once: most blocks close at tile_m pieces, and only the others
    # search for the last piece that fits
    full = ends[np.minimum(np.arange(n) + tile_m, n)] - ends[:-1] <= cap
    starts, i = [], 0
    while i < n:
        starts.append(i)
        if full[i]:
            i = min(i + tile_m, n)
        else:
            fit = int(np.searchsorted(ends, ends[i] + cap,
                                      side="right")) - 1
            i = max(i + 1, min(i + tile_m, fit))
    return np.asarray(starts, np.int64)


class Capacity(NamedTuple):
    """The fixed shapes of a capped transposed layout that holds any
    ``max_edges`` edges over ``num_rows`` rows (``transposed_capacity``).

    nblocks: the pieces' blocks, each of ``cap`` slots (its ``emax``).
    cut_rows: the most rows that can be cut -- over ``min(cap,
           packed_split(cap, tile_m))`` slots each.
    scratch: the most scratch rows their pieces can take.
    fold_nblocks, fold_emax: the fold-back layout's blocks (``tile_m``
           cut rows each) and their slots.
    """

    nblocks: int
    cut_rows: int
    scratch: int
    fold_nblocks: int
    fold_emax: int


def transposed_capacity(num_rows: int, max_edges: int, tile_m: int,
                        cap: int) -> Capacity:
    """Shapes that hold the capped transposed layout (``_capped``) of ANY
    ``max_edges`` edges over ``num_rows`` rows, so that two graphs of one
    bucket give tensors of equal shapes: a CUDA graph captured over one
    replays over the other.  Rows of ``n`` slots take ``ceil(n / cap)``
    pieces (at least one), so at most ``num_rows + max_edges // cap``
    pieces; a block closes at ``tile_m`` pieces, or when the next piece
    would take it past ``cap`` slots -- that block's slots and the next
    piece's sum past ``cap``, and the two are disjoint slots of at most
    ``2 max_edges``, so fewer than ``2 max_edges / cap`` blocks close so;
    plus the last.  A cut row has over ``min(cap, packed_split(cap,
    tile_m))`` slots; its pieces number at most one more than its slots
    over ``cap``.  At least one block and one scratch row each, so every
    launch has work to walk."""
    from repro_torch.kernels.seg_agg import packed_split
    e, cap = int(max_edges), int(cap)
    pieces = int(num_rows) + e // cap
    nblocks = -(-pieces // tile_m) + 2 * e // cap + 1
    cut = e // (min(cap, packed_split(cap, tile_m)) + 1)
    scratch = max(1, cut + e // cap)
    fold_emax = max(8, -(-min(scratch, tile_m + e // cap) // 8) * 8)
    return Capacity(nblocks, cut, scratch, max(1, -(-cut // tile_m)),
                    fold_emax)


def _capped(gather: np.ndarray, rows: np.ndarray, eidx: np.ndarray,
            num_rows: int, tile_m: int, dev, cap: int,
            max_edges: Optional[int] = None) -> BlockedGraph:
    """The capped transposed layout of slots sorted by ``rows`` (each
    gathering ``gather``, mirroring ``eidx``) over ``num_rows`` rows.
    Each row is one piece -- a row of no slots too, so K1 stores its zero
    row -- or, over ``cap`` slots, is cut into pieces of ``cap`` in slot
    order; the pieces are packed (``pack_pieces``), piece k of block b in
    block row k.  A row of one piece and at most
    ``packed_split(cap, tile_m)`` slots (about a fold unit's share of a
    block, which K1 folds whole, in slot order) is stored in place:
    ``out_rows`` maps its piece to the row.  A longer row is a cut row,
    whatever its length: its pieces map to scratch rows ``num_rows + i``
    in piece order (K1 splits them across its fold units, so no unit
    folds a long row alone), and ``fold``, the layout of the cut rows,
    gathers them in that order into the row (None when no row is cut).
    The block rows no piece took map to -1.  So each row of ``[0,
    num_rows)`` is written once, and every row stored in place is one
    in-order fold.  At least one block, so an empty layout still
    launches.

    With ``max_edges`` the layout takes the shapes of
    ``transposed_capacity``: ``nblocks`` blocks of ``cap`` slots, and a
    fold-back always, of ``fold_nblocks`` blocks of ``fold_emax`` slots
    over ``scratch`` scratch rows -- with no row cut, one whose row maps
    are all -1, which stores nothing.  Padding slots are masked, padding
    block rows map to -1; more edges than ``max_edges`` raise."""
    from repro_torch.kernels.seg_agg import packed_split
    if cap < 8 or cap % 8:
        raise ValueError(f"cap must be a positive multiple of 8; got {cap}")
    room = None
    if max_edges is not None:
        if len(rows) > max_edges:
            raise ValueError(f"{len(rows)} edges, over the transposed "
                             f"layout's capacity of {max_edges}")
        room = transposed_capacity(num_rows, max_edges, tile_m, cap)
    n = np.bincount(rows, minlength=num_rows).astype(np.int64)
    npieces = np.maximum(1, -(-n // cap))
    piece_row = np.repeat(np.arange(num_rows, dtype=np.int64), npieces)
    first_piece = np.concatenate([[0], np.cumsum(npieces)])[:-1]
    j = np.arange(len(piece_row), dtype=np.int64) - first_piece[piece_row]
    lengths = np.minimum(cap, n[piece_row] - j * cap)
    starts = pack_pieces(lengths, tile_m, cap)
    block = np.repeat(np.arange(len(starts)),
                      np.diff(np.append(starts, len(lengths))))
    out_row = block * tile_m + (np.arange(len(lengths)) - starts[block])
    # slot s of row r lies in piece first_piece[r] + (s - row start) // cap
    row_start = np.concatenate([[0], np.cumsum(n)])[:-1]
    piece = first_piece[rows] + (np.arange(len(rows)) - row_start[rows]) \
        // cap
    nblocks = max(1, len(starts))
    if room is not None:
        if nblocks > room.nblocks:
            raise ValueError(f"{nblocks} blocks of pieces, over the "
                             f"capacity of {room.nblocks}")
        nblocks = room.nblocks
    # a cut row's pieces go to scratch rows, numbered in piece order
    long_rows = n > min(cap, packed_split(cap, tile_m))
    cut = long_rows[piece_row]
    dest = piece_row.copy()
    dest[cut] = num_rows + np.arange(int(cut.sum()))
    row_map = np.full(nblocks * tile_m, -1, np.int64)
    row_map[out_row] = dest
    pieces = _block_layout(gather, out_row[piece], nblocks * tile_m, tile_m,
                           dev, emax=None if room is None else cap,
                           eidx=eidx)[0]
    pieces = pieces._replace(num_vertices=num_rows,
                             out_rows=_row_map(row_map, tile_m, dev))
    if room is None and not cut.any():
        return pieces
    cut_rows = np.flatnonzero(long_rows)
    # fold-back row i: cut row cut_rows[i], its scratch rows in order
    fold_row = np.repeat(np.arange(len(cut_rows)), npieces[cut_rows])
    fold_rows, scratch = len(cut_rows), int(cut.sum())
    if room is not None:
        if fold_rows > room.cut_rows or scratch > room.scratch:
            raise ValueError(f"{fold_rows} cut rows in {scratch} scratch "
                             f"rows, over the capacity of {room.cut_rows} "
                             f"in {room.scratch}")
        fold_rows, scratch = room.fold_nblocks * tile_m, room.scratch
    fold = _block_layout(dest[cut] - num_rows, fold_row, fold_rows, tile_m,
                         dev, emax=None if room is None
                         else room.fold_emax)[0]
    fold_map = np.full(fold.nblocks * tile_m, -1, np.int64)
    fold_map[:len(cut_rows)] = cut_rows
    fold = fold._replace(num_vertices=scratch,
                         out_rows=_row_map(fold_map, tile_m, dev))
    return pieces._replace(fold=fold)


def _row_map(row_map: np.ndarray, tile_m: int, dev) -> torch.Tensor:
    """A row map as K1 takes it: ``(nblocks, tile_m)`` int32 on ``dev``."""
    return torch.from_numpy(row_map.astype(np.int32)).view(
        -1, tile_m).to(dev)


def block_graph_arrays(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                       tile_m: int, *, device="cpu",
                       emax: Optional[int] = None,
                       transpose_rows: Optional[int] = None,
                       transpose_cap: Optional[int] = None,
                       max_edges: Optional[int] = None) -> BlockedGraph:
    """``block_graph`` over raw dst-sorted arrays (``block_graph_arrays``,
    :91).  ``num_vertices`` is the destination row count; ``emax`` is the
    largest block's edge count rounded up to 8 (at least 8), or the fixed
    capacity given (a block over it raises).  ``transpose_rows`` (the rows
    of the gathered matrix) also builds the transposed layout K1's
    backward runs over, from the same host arrays: uncapped, or capped
    at ``transpose_cap`` (``_capped``), and then, with ``max_edges``, at
    the fixed capacity of any ``max_edges`` edges
    (``transposed_capacity``)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    dev = torch.device(device)
    bg, slot = _block_layout(src, dst, int(num_vertices), tile_m, dev, emax)
    if transpose_rows is not None:
        bg = bg._replace(transposed=_transposed(
            src.astype(np.int64), dst.astype(np.int64), slot,
            int(transpose_rows), tile_m, dev, transpose_cap, max_edges))
    return bg


def transposed_layout(bg: BlockedGraph, num_rows: int,
                      cap: Optional[int] = None) -> BlockedGraph:
    """The transposed layout of ``bg``, a layout already on its device,
    for K1's backward over ``num_rows`` rows of the gathered matrix (its
    capped form with ``cap``): read back to the host and built there, on
    every call (a plan keeps the result for the layouts it owns)."""
    m = bg.mask.cpu().numpy() != 0
    b, j = np.nonzero(m)                 # forward slot order
    emax = m.shape[1]
    s = bg.src.cpu().numpy()[b, j].astype(np.int64)
    d = b * bg.tile_m + bg.dstl.cpu().numpy()[b, j].astype(np.int64)
    return _transposed(s, d, b * emax + j, int(num_rows), bg.tile_m,
                       bg.src.device, cap)


def suggest_tile_m(in_len: int, out_len: int, avg_deg: float,
                   dtype_bytes: int = 4,
                   machine: Optional[Machine] = None) -> int:
    """Largest aligned tile whose fused working set fits the on-chip budget
    (``suggest_tile_m``, :121), priced on ``machine`` (default ``H100``).

    Working set per block row: input + output row + the gathered rows
    stream (avg_deg * in, double-buffered).  On a GPU the tile fits a
    per-CTA share of the SM carveout, warp-aligned and at most 256 rows; on
    a TPU it fits half of VMEM beside W.
    """
    machine = get_machine(machine)
    per_row = (in_len + out_len + 2 * avg_deg * in_len) * dtype_bytes
    if machine.kind == "gpu":
        warp = machine.row_align
        m = max(warp, int(machine.tile_budget() / max(per_row, 1)))
        m = (m // warp) * warp
        return int(max(warp, min(256, m)))
    align = machine.row_align
    w = in_len * out_len * dtype_bytes
    m = max(align, int((machine.tile_budget() - w) / max(per_row, 1)))
    return int(max(align, min(4096, (m // align) * align)))


def fused_gcn_layer(bg: BlockedGraph, x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    agg_op: str = "mean",
                    in_deg: Optional[torch.Tensor] = None,
                    backend: str = "torch") -> torch.Tensor:
    """Aggregate-then-combine per vertex block (``fused_gcn_layer``, :169).

    Semantics: combine(aggregate(x)) with a single matmul.  The blocked
    neighbour sum and ``@ w`` run fused (``kernels.ops.fused_agg_combine``);
    the self term and the mean normalization are linear and applied after
    the product, outside the kernel, as in the reference (:196-211):
    ``agg_op`` is "mean" (self + reciprocal of in_deg+1), "sum_self" or
    "sum".  x: (R, F_in), R >= V (a dedup plan passes ``[x ; partials]``;
    the self term reads the first V rows); w: (F_in, F_out).  With reduced
    operands the self term is ``phases._mm``'s f32 accumulator and the
    mean runs in the dtype the two promote to, as the reference's
    ``norm_dtype``.
    """
    from repro_torch.core.phases import _mm
    from repro_torch.kernels import ops as kops
    out = kops.fused_agg_combine(bg.src, bg.dstl, bg.mask, x, w,
                                 tile_m=bg.tile_m, backend=backend)
    out = out[: bg.num_vertices]
    if agg_op == "mean":
        if in_deg is None:
            raise ValueError("agg_op='mean' needs in_deg")
        self_term = _mm(x[: bg.num_vertices], w)
        norm_dtype = torch.promote_types(out.dtype, self_term.dtype)
        out = (out.to(norm_dtype) + self_term) * (
            1.0 / (in_deg.to(norm_dtype) + 1.0))[:, None]
    elif agg_op == "sum_self":
        out = out + _mm(x[: bg.num_vertices], w)
    if bias is not None:
        out = out + bias
    return out
