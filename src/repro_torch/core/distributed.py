"""Distributed GCN execution: vertex-partitioned aggregation over a mesh
(``repro/core/distributed.py``).

With a 1-D destination partition (``graph.partition``) the Aggregation
phase's remote traffic is one feature row per cut edge, so running
Combination first shrinks the collective term by in_len/out_len -- the
multi-chip restatement of the paper's 4.7x (Table 4).

**Meshes.**  The counterpart of a ``jax.sharding.Mesh`` axis is one
interface, ``Mesh``, with two implementations:

  * ``LocalMesh(shape, axis_names, device=)`` -- every shard held by one
    process on one device; its collectives are device copies.  On a card
    ``ppermute`` copies on a communication stream of its own, ordered with
    CUDA events, so the pipelined ring really starts hop k+1's copy before
    hop k's partial combine (the sent slabs are held until the caller's
    stream waits for the copies).
  * ``ProcessGroupMesh(shape, axis_names, device=)`` -- one shard per rank
    of an initialized ``torch.distributed`` group (NCCL, or gloo on the
    CPU: the same calls), over a ``torch.distributed.device_mesh.
    DeviceMesh``: ``all_gather`` is ``all_gather_into_tensor``,
    ``ppermute`` is ``batch_isend_irecv`` around the ring (a local copy
    when the axis has one shard), ``psum_scatter`` is
    ``reduce_scatter_tensor``.

The per-shard bodies take "the shards this process holds" as lists -- all
of them on a ``LocalMesh``, one on a process group -- so both meshes run
the same body code.  Each mesh counts the bytes each of its collectives
moves, per shard (``Mesh.collective_bytes``, the port's
``core.characterize.collective_bytes``).

**Halo strategies** (both exact): ``allgather`` -- one all-gather of the
feature slabs per layer, then each shard's local sum; ``ring`` -- P hops
of ``ppermute`` around the axis, each hop folding the block it holds.  The
ring has two schedules (``overlap=``): ``"none"`` reduces the resident
slab and then passes it on (P sends); ``"pipelined"`` starts the send
first and reduces while it is in flight (P-1 sends).  The partials are
added left to right onto zeros in f32 in both, so they are equal bit for
bit.

Each shard's local sum is K1 (``kernels.seg_agg``) on the cuda tier and
K1's plain version on the torch tier, over blocked layouts built once from
the partition (``shard_layouts``): for the all-gather one per shard,
global sources; for the ring one per (shard, owner), sources local to the
owner's block, so hop k of shard p folds layout (p, (p-k) mod P) over the
resident slab.  The reference keeps every edge in every hop at weight 0 (a
static shape); over sub-layouts a layer's K1 slots add up to the shard's
edges.  A bf16 wire slab is folded by K1's bf16-in/f32-out entry: f32
partials over the 2-byte wire, as the reference's promoted accumulator.

**2-D (node x feature)** (``distributed_gcn_layer_2d``): shard (p, q) owns
node block p's rows restricted to feature columns q; the halo runs along
the node axis on rows F/Q wide, and the Combination is a partial product
by W's matching row block closed by one ``psum_scatter`` over the feature
axis.

**Gradients.**  A halo is one ``autograd.Function`` (``_Halo``) over the
held shards' slabs: its forward is the body above, its backward the SAME
body run over the output gradients at the wire's dtype, each owner o
folding the transposed sub-layouts (p, o) -- at ring hop k owner o holds
``g_{(o-k) mod P}`` and folds sub-layout ((o-k) mod P, o); the all-gather
gathers the gradients and each owner folds all P.  So the backward moves
the forward's bytes, adds its partials left to right in the same order
(none and pipelined bit for bit), and K1 runs it over the capped
transposed sub-layouts (``shard_transposed_layouts``: rows cut into
pieces, then K1 over the fold-back), built once on the host, never in a
backward.  The 2-D layer's ``psum_scatter`` has the all-gather over the
feature axis as its adjoint (``_PsumScatter``, counted).  On a process
group three adjoints are not what autograd would give by itself, and
follow ``shard_map``'s transposes:

  (a) ``assemble`` all-gathers the logits, so every rank computes the
      same global loss: its adjoint is this rank's own slice of the
      incoming gradient (``_Assemble``), not a reduce-scatter sum, which
      would scale every gradient by P;
  (b) the halo's all-gather feeds each rank different work: its adjoint
      is a sum over the ranks, which the halo's backward folds make;
  (c) a replicated parameter (W, the bias) gets this rank's partial
      gradient: ``Mesh.replicated`` sums it over the world (``psum``, an
      all-reduce) before the optimizer sees it.

On a ``LocalMesh`` (a) and (c) fall out of autograd (``torch.cat``; one
shared W).  ``Mesh.psum`` is the counted all-reduce ("all-reduce"):
``all_reduce`` on a group, the sum of the held shards on a ``LocalMesh``;
an integer tensor sums in its own dtype (``optim.compression``'s int8
wire sums int32).

``halo_bytes``, ``overlap_model``, ``choose_overlap`` and
``schedule_wire_bytes`` price the schedules; they are pure arithmetic and
equal the reference's.
"""

from __future__ import annotations

import itertools
import types
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.backend import AUTO, resolve_backend, resolve_device
# TRANSPOSE_CAP is re-exported: the halos' backward layouts read it here
from repro_torch.core.dataflow import (TRANSPOSE_CAP, BlockedGraph,
                                       _block_layout, _transposed)
from repro_torch.graph.partition import Partition2D, PartitionedGraph

#: the collectives a mesh counts, by the reference's HLO names
#: (``core/characterize.py::_COLLECTIVE_OPS``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: resolved overlap schedules a distributed layer accepts ("auto" is a
#: plan-level request resolved by ``choose_overlap`` before dispatch)
OVERLAP_MODES = ("none", "pipelined")

#: least modeled saving (a fraction of the single-buffered exchange time)
#: at which ``choose_overlap`` commits to the pipelined schedule
OVERLAP_SAVING_THRESHOLD = 0.02


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


class _Ready:
    """A collective already complete (CPU copies; a process group's
    blocking calls)."""

    def __init__(self, outs):
        self.outs = outs

    def wait(self) -> list:
        return self.outs


class _Pending:
    """Slabs copied on a ``LocalMesh``'s communication stream: ``wait``
    makes the caller's stream wait for the copies' event.  The sent slabs
    are held until then, so their memory returns to the caller's stream
    only once it is ordered after the copies (no ``record_stream``, whose
    deferred frees would keep the allocator from reusing the blocks)."""

    def __init__(self, outs, done, stream, sent):
        self.outs, self.done, self.stream, self.sent = outs, done, stream, \
            sent

    def wait(self) -> list:
        self.stream.wait_event(self.done)
        self.sent = None
        return self.outs


class _P2P:
    """A ring hop in flight on a process group: ``wait`` waits for its
    send and receive (keeping the sent slab alive until then)."""

    def __init__(self, outs, reqs, sent):
        self.outs, self.reqs, self.sent = outs, reqs, sent

    def wait(self) -> list:
        for r in self.reqs:
            r.wait()
        self.sent = None
        return self.outs


class Mesh:
    """Named mesh axes over the shards of a distributed plan.

    ``shape`` maps each axis name to its size, in order; ``coords`` are
    the shards this process holds (row-major mesh coordinates), and every
    collective takes and returns one tensor per held shard, in that order.
    ``collective_bytes()`` reports the bytes each shard's collectives
    moved since ``reset_counts()``, by collective: the operand each
    collective takes in (a ``ppermute``'s slab, an all-gather's local
    slab, a ``psum_scatter``'s whole partial), as the reference's
    ``schedule_wire_bytes`` prices them.
    """

    axis_names: tuple
    device: torch.device
    coords: List[tuple]

    def _init_axes(self, shape, axis_names) -> None:
        shape = tuple(int(n) for n in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or not shape or \
                any(n < 1 for n in shape) or \
                len(set(axis_names)) != len(axis_names):
            raise ValueError(f"a mesh needs one positive size per distinct "
                             f"axis name; got shape {shape}, axes "
                             f"{axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.reset_counts()

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def all_coords(self) -> List[tuple]:
        """Every shard's coordinates, row-major."""
        return list(itertools.product(*[range(n)
                                        for n in self.shape.values()]))

    def axis_size(self, axis: str) -> int:
        if axis not in self.shape:
            raise ValueError(f"mesh has axes {self.axis_names}, not "
                             f"{axis!r}")
        return self.shape[axis]

    def index(self, coord: tuple, axis: str) -> int:
        """A shard's coordinate along ``axis``."""
        return coord[self.axis_names.index(axis)]

    def reset_counts(self) -> None:
        """Set every collective's byte and call counts to 0."""
        self._bytes = {k: 0 for k in COLLECTIVES}
        self._calls = {k: 0 for k in COLLECTIVES}

    def _count(self, kind: str, xs) -> None:
        sizes = {int(x.numel()) * x.element_size() for x in xs}
        if len(sizes) != 1:
            raise ValueError(f"{kind}: shards of unequal sizes {sizes}")
        self._bytes[kind] += sizes.pop()
        self._calls[kind] += 1

    def collective_bytes(self) -> Dict:
        """Bytes one shard's collectives moved since ``reset_counts()``:
        ``{collective: bytes, ..., "total": bytes, "counts": {collective:
        calls}}``, the keys of the reference's
        ``core.characterize.collective_bytes``."""
        out: Dict = dict(self._bytes)
        out["total"] = sum(self._bytes.values())
        out["counts"] = dict(self._calls)
        return out

    def ppermute(self, xs, axis: str) -> list:
        """One ring hop along ``axis``, waited for (``ppermute_start``)."""
        return self.ppermute_start(xs, axis).wait()

    def replicated(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a parameter every shard holds whole, as a layer uses it:
        on a process group, when ``t`` needs a gradient, through
        ``_Replicated``, whose backward sums this rank's partial gradient
        over the world (adjoint (c)); else ``t`` itself."""
        return t

    def _along(self, coord: tuple, axis: str) -> List[tuple]:
        """The coordinates of ``coord``'s group along ``axis``, in order."""
        i = self.axis_names.index(axis)
        return [coord[:i] + (j,) + coord[i + 1:]
                for j in range(self.shape[axis])]

    def __repr__(self) -> str:
        dims = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"{type(self).__name__}(({dims}), device={self.device})"


class LocalMesh(Mesh):
    """Every shard of the mesh held by this process on one device (the
    counterpart of the reference's fake multi-device CPU mesh).  The
    collectives are copies on the device; on a card ``ppermute`` copies on
    the mesh's communication stream, so a pipelined ring's copy runs under
    the hop's partial combine.

    ::

        >>> mesh = LocalMesh((4,), ("data",), device="cpu")
        >>> mesh2 = LocalMesh((4, 2), ("node", "feat"), device="cpu")
    """

    def __init__(self, shape, axis_names, device="cuda"):
        self.device = resolve_device(device)
        self._init_axes(shape, axis_names)
        self.coords = self.all_coords
        self._pos = {c: i for i, c in enumerate(self.coords)}
        self._comm = None

    def all_gather(self, xs, axis: str) -> list:
        """Each shard gets its group's slabs along ``axis`` stacked in axis
        order (``all_gather(tiled=True)``)."""
        self._count("all-gather", xs)
        return [torch.cat([xs[self._pos[g]] for g in self._along(c, axis)])
                for c in self.coords]

    def ppermute_start(self, xs, axis: str):
        """Start one ring hop along ``axis`` (shard i sends to i + 1):
        returns a handle whose ``wait()`` gives each shard the slab of its
        predecessor."""
        self._count("collective-permute", xs)
        n = self.shape[axis]
        src = [self._pos[self._along(c, axis)[(self.index(c, axis) - 1) % n]]
               for c in self.coords]
        if self.device.type != "cuda":
            return _Ready([xs[j].clone() for j in src])
        cur = torch.cuda.current_stream(self.device)
        if self._comm is None:
            self._comm = torch.cuda.Stream(self.device)
        # the slabs are ready, and the outputs' blocks free, on the caller's
        # stream up to here
        outs = [torch.empty_like(x) for x in xs]
        ready = torch.cuda.Event()
        ready.record(cur)
        self._comm.wait_event(ready)
        with torch.cuda.stream(self._comm):
            for o, j in zip(outs, src):
                o.copy_(xs[j], non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._comm)
        return _Pending(outs, done, cur, list(xs))

    def psum_scatter(self, xs, axis: str) -> list:
        """Each shard gets its column block (its index along ``axis``) of
        the sum of its group's partials, added left to right in axis order
        (``psum_scatter(scatter_dimension=1, tiled=True)``)."""
        self._count("reduce-scatter", xs)
        n = self.shape[axis]
        w = xs[0].shape[1] // n
        outs = []
        for c in self.coords:
            q = self.index(c, axis)
            parts = [xs[self._pos[g]][:, q * w:(q + 1) * w]
                     for g in self._along(c, axis)]
            acc = parts[0].contiguous()
            for part in parts[1:]:
                acc = acc + part
            outs.append(acc)
        return outs

    def psum(self, xs, axis: Optional[str] = None) -> list:
        """Each shard gets the sum of its group's tensors along ``axis``
        (every shard when None), added left to right in coordinate order
        in their own dtype (``psum``)."""
        self._count("all-reduce", xs)
        outs = []
        for c in self.coords:
            group = self.coords if axis is None else self._along(c, axis)
            parts = [xs[self._pos[g]] for g in group]
            acc = parts[0].clone()
            for part in parts[1:]:
                acc = acc + part
            outs.append(acc)
        return outs

    def assemble(self, xs) -> list:
        """Every shard's tensor, in ``all_coords`` order (all are held)."""
        return list(xs)


class ProcessGroupMesh(Mesh):
    """One shard per rank of the initialized default process group, over
    ``torch.distributed.device_mesh.init_device_mesh(device.type, shape,
    mesh_dim_names=axis_names)``.  Initialize the group first, with its
    address, world size and rank given (e.g. ``init_process_group("gloo",
    store=FileStore(path, world), rank=r, world_size=world)``); the mesh's
    size must be the world size.  ``device`` is where this rank computes
    (default ``"cuda"``: the current card)."""

    def __init__(self, shape, axis_names, device="cuda"):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs an initialized "
                               "torch.distributed process group")
        self.device = resolve_device(device)
        self._init_axes(shape, axis_names)
        if self.size != dist.get_world_size():
            raise ValueError(f"mesh of {self.size} shards over a world of "
                             f"{dist.get_world_size()} ranks")
        self._dist = dist
        self.dm = init_device_mesh(self.device.type,
                                   tuple(self.shape.values()),
                                   mesh_dim_names=self.axis_names)
        self.coords = [tuple(self.dm.get_local_rank(a)
                             for a in self.axis_names)]
        ranks = self.dm.mesh.flatten().tolist()
        #: global rank of each coordinate, row-major
        self.rank_of = {c: r for c, r in zip(self.all_coords, ranks)}

    def _group(self, axis: str):
        return self.dm.get_group(axis)

    def _gather(self, x, group, n: int) -> torch.Tensor:
        """``x`` of every rank of ``group`` stacked along dim 0."""
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    def all_gather(self, xs, axis: str) -> list:
        self._count("all-gather", xs)
        return [self._gather(xs[0], self._group(axis), self.shape[axis])]

    def ppermute_start(self, xs, axis: str):
        self._count("collective-permute", xs)
        n = self.shape[axis]
        x = xs[0]
        if n == 1:                       # a self-permute: a local copy
            return _Ready([x.clone()])
        dist = self._dist
        c = self.coords[0]
        i = self.index(c, axis)
        ring = self._along(c, axis)
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, self.rank_of[ring[(i + 1) % n]]),
               dist.P2POp(dist.irecv, out, self.rank_of[ring[(i - 1) % n]])]
        return _P2P([out], dist.batch_isend_irecv(ops), x)

    def psum_scatter(self, xs, axis: str) -> list:
        self._count("reduce-scatter", xs)
        n = self.shape[axis]
        x = xs[0]
        w = x.shape[1] // n
        # the column blocks stacked along dim 0, the layout the collective
        # scatters; the backend picks the order of the sum
        inp = x.reshape(x.shape[0], n, w).transpose(0, 1).contiguous()
        out = torch.empty((x.shape[0], w), dtype=x.dtype, device=x.device)
        self._dist.reduce_scatter_tensor(out, inp.view(n * x.shape[0], w),
                                         group=self._group(axis))
        return [out]

    def psum(self, xs, axis: Optional[str] = None) -> list:
        """This rank's tensor summed over its group along ``axis`` (the
        world when None): one ``all_reduce``, in the tensor's dtype."""
        self._count("all-reduce", xs)
        out = xs[0].clone()
        self._dist.all_reduce(out, group=None if axis is None
                              else self._group(axis))
        return [out]

    def replicated(self, t: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and t.requires_grad:
            return _Replicated.apply(self, t)
        return t

    def assemble(self, xs) -> list:
        """Every shard's tensor in ``all_coords`` order: one all-gather over
        the world (counted).  Differentiable: the adjoint is this rank's
        own slice of the gradient (``_Assemble``)."""
        full = _Assemble.apply(self, xs[0])
        by_rank = {r: full[r] for r in range(self.size)}
        return [by_rank[self.rank_of[c]] for c in self.all_coords]


class _Assemble(torch.autograd.Function):
    """A process group's gather of every rank's tensor, ``(world, ...)``.
    Every rank then computes the same global function of it, so the
    gradient a rank receives for its own tensor is its own slice of the
    incoming one (adjoint (a)); nothing crosses the wire."""

    @staticmethod
    def forward(ctx, mesh, x):
        mesh._count("all-gather", [x])
        ctx.me = mesh.rank_of[mesh.coords[0]]
        return mesh._gather(x, None, mesh.size).view(
            (mesh.size,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.me].contiguous()


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward sums this rank's partial gradient of
    a replicated parameter over the world (``mesh.psum``, adjoint (c))."""

    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh.psum([g.contiguous()])[0]


# ---------------------------------------------------------------------------
# Per-shard layouts and bodies
# ---------------------------------------------------------------------------


def shard_tile(block: int) -> int:
    """Rows per block of the shards' K1 layouts: the local plans' rule
    over a shard's ``block`` rows (warp-aligned, at most 128)."""
    return max(32, min(128, -(-int(block) // 32) * 32))


def shard_layouts(pg: PartitionedGraph, strategy: str, *,
                  nodes: Optional[Sequence[int]] = None,
                  device=None) -> Dict[int, object]:
    """K1's layouts of the shards in ``nodes`` (default all), built on the
    host once: for ``"allgather"`` one ``BlockedGraph`` a shard (global
    sources, ``block`` rows); for ``"ring"`` a list over owners o of the
    layout of the shard's edges from o's block, sources local to it.  Each
    layout's edges keep the shard's destination order."""
    _check_strategy(strategy)
    dev = pg.src.device if device is None else torch.device(device)
    block, nsh = pg.block_size, pg.num_shards
    tile = shard_tile(block)
    out: Dict[int, object] = {}
    for p in (range(nsh) if nodes is None else nodes):
        src, dstl = pg.shard_edges(p)
        if strategy == "allgather":
            out[p] = _block_layout(src, dstl, block, tile, dev)[0]
            continue
        owner = src // block
        out[p] = [_block_layout(src[owner == o] - o * block,
                                dstl[owner == o], block, tile, dev)[0]
                  for o in range(nsh)]
    return out


def shard_transposed_layouts(pg: PartitionedGraph, *,
                             nodes: Optional[Sequence[int]] = None,
                             device=None) -> Dict[int, list]:
    """The halos' backward layouts of the owners in ``nodes`` (default
    all), built on the host once: for owner o a list over shards p of the
    capped transposed layout of shard p's edges from o's block -- rows
    o's sources (local to its block), each gathering the gradient row of
    its edge's destination in p's block, rows longer than
    ``TRANSPOSE_CAP`` slots cut into pieces, long rows folded back from
    scratch rows (``core.dataflow._capped``).  Both strategies' backwards
    fold them (the all-gather's global-source layouts would have as many
    rows as the graph)."""
    dev = pg.src.device if device is None else torch.device(device)
    block, nsh = pg.block_size, pg.num_shards
    tile = shard_tile(block)
    nodes = range(nsh) if nodes is None else nodes
    out: Dict[int, list] = {o: [] for o in nodes}
    for p in range(nsh):
        src, dstl = pg.shard_edges(p)
        owner = src // block
        for o in nodes:
            sel = owner == o
            s = (src[sel] - o * block).astype(np.int64)
            out[o].append(_transposed(
                s, dstl[sel].astype(np.int64), np.arange(len(s)), block,
                tile, dev, TRANSPOSE_CAP))
    return out


def _check_strategy(strategy: str) -> None:
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {sorted(_STRATEGIES)}")


def pad_features(x: torch.Tensor, block: int, num_shards: int
                 ) -> torch.Tensor:
    """Pad vertex features to num_shards * block rows (``pad_features``,
    :67)."""
    return torch.nn.functional.pad(x, (0, 0, 0, block * num_shards
                                       - x.shape[0]))


def _require_uniform(pg: PartitionedGraph) -> None:
    """The strategies lay rows out as p * block + local, which needs the
    UNIFORM partition (``_require_uniform``, :74)."""
    starts = pg.vtx_start.cpu().numpy()
    expect = np.arange(pg.num_shards) * pg.block_size
    expect = np.minimum(expect, pg.num_vertices)
    if not np.array_equal(starts, expect):
        raise ValueError(
            "distributed aggregation requires a uniform partition; build "
            "with partition_1d(g, P, edge_balanced=False)")


def _local_agg(x_full: torch.Tensor, layout: BlockedGraph, *,
               backend: str) -> torch.Tensor:
    """One shard's local sum over its layout (``_local_agg``, :87):
    ``sum_e x_full[src_e]`` into each of its ``block`` rows, f32 (K1, the
    bf16-in/f32-out entry for a bf16 slab).  Over a capped transposed
    sub-layout (a backward's), K1 over the pieces, then, when a row was
    cut, the fold-back."""
    from repro_torch.kernels import ops as kops
    if layout.out_rows is not None:
        return kops.seg_agg_transposed(layout, x_full, backend=backend)
    return kops.seg_agg_planned(layout, x_full, backend=backend,
                                out_dtype=torch.float32)


def _hop_partial(buf: torch.Tensor, k: int, p: int, layouts, nsh: int, *,
                 backend: str) -> torch.Tensor:
    """Partial combine of hop k's resident slab (``_hop_partial``, :99):
    shard p holds owner (p - k) mod P's block (the ring sends i -> i+1) and
    folds the layout of its edges from that block.  Shared by both ring
    schedules, so their per-hop sums are the same."""
    return _local_agg(buf, layouts[(p - k) % nsh], backend=backend)


def _allgather_local(mesh: Mesh, xs, layouts, axis: str, *,
                     backend: str) -> list:
    """All-gather halo body (``_allgather_local``, :92): gather the axis's
    slabs, then each shard's local sum."""
    fulls = mesh.all_gather(xs, axis)
    return [_local_agg(xf, lay, backend=backend)
            for xf, lay in zip(fulls, layouts)]


def _ring_acc0(xs) -> list:
    """Zero accumulators in the promoted dtype (f32 partials, also over a
    bf16 wire slab); each hop's partial is added in place, left to right,
    the same rounding as ``acc + partial``."""
    return [torch.zeros(x.shape, dtype=torch.promote_types(x.dtype,
                                                           torch.float32),
                        device=x.device) for x in xs]


def _ring_local(mesh: Mesh, xs, layouts, axis: str, *,
                backend: str) -> list:
    """Ring halo body, single-buffered (``overlap="none"``; ``_ring_local``,
    :114): P hops, each reducing the held slab and THEN passing it on, so
    every send waits behind its hop's partial combine (P sends, the last
    the schedule's wrap-around)."""
    nsh = mesh.axis_size(axis)
    ps = [mesh.index(c, axis) for c in mesh.coords]
    accs, bufs = _ring_acc0(xs), list(xs)
    for k in range(nsh):
        for acc, b, p, lay in zip(accs, bufs, ps, layouts):
            acc.add_(_hop_partial(b, k, p, lay, nsh, backend=backend))
        bufs = mesh.ppermute(bufs, axis)
    return accs


def _ring_local_pipelined(mesh: Mesh, xs, layouts, axis: str, *,
                          backend: str) -> list:
    """Ring halo body, double-buffered (``overlap="pipelined"``;
    ``_ring_local_pipelined``, :142): each hop starts the send FIRST, so
    hop k+1's slab is in flight while hop k's is reduced, and the last
    resident slab is reduced without a send (P-1 sends).  The partials are
    added in the same order as ``_ring_local``'s: both are bit for bit
    equal."""
    nsh = mesh.axis_size(axis)
    ps = [mesh.index(c, axis) for c in mesh.coords]
    accs, bufs = _ring_acc0(xs), list(xs)
    for k in range(nsh - 1):
        nxt = mesh.ppermute_start(bufs, axis)      # in flight during reduce
        for acc, b, p, lay in zip(accs, bufs, ps, layouts):
            acc.add_(_hop_partial(b, k, p, lay, nsh, backend=backend))
        bufs = nxt.wait()
    # last hop: the slab is already resident -- reduce it, send nothing
    for acc, b, p, lay in zip(accs, bufs, ps, layouts):
        acc.add_(_hop_partial(b, nsh - 1, p, lay, nsh, backend=backend))
    return accs


def _allgather_local_t(mesh: Mesh, gs, tlayouts, axis: str, *,
                       backend: str) -> list:
    """The all-gather halo's backward body: gather the axis's output
    gradients (the forward's bytes), then each owner o folds the
    transposed sub-layouts (p, o) over shard p's rows, p = 0 .. P-1,
    adding the partials left to right onto zeros."""
    nsh = mesh.axis_size(axis)
    fulls = mesh.all_gather(gs, axis)
    outs = []
    for gf, acc, lays in zip(fulls, _ring_acc0(gs), tlayouts):
        block = gf.shape[0] // nsh
        for p, lay in enumerate(lays):
            acc.add_(_local_agg(gf[p * block:(p + 1) * block], lay,
                                backend=backend))
        outs.append(acc)
    return outs


_STRATEGIES = {"ring": _ring_local, "allgather": _allgather_local}


def _halo_body(strategy: str, overlap: str):
    """Resolve (strategy, overlap) to the halo body, validating the pair:
    pipelining needs the ring's per-hop structure (``_halo_body``, :183)."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {sorted(_STRATEGIES)}")
    if overlap not in OVERLAP_MODES:
        raise ValueError(
            f"unknown overlap {overlap!r}; expected 'none' | 'pipelined' "
            "('auto' is resolved at plan build -- see choose_overlap)")
    if overlap == "pipelined":
        if strategy != "ring":
            raise ValueError(
                "overlap='pipelined' requires strategy='ring'; the "
                "all-gather halo is one collective with no per-hop "
                "structure to pipeline")
        return _ring_local_pipelined
    return _STRATEGIES[strategy]


class _Halo(torch.autograd.Function):
    """A halo over the held shards' slabs, ``(op, *xs) -> accs`` (f32
    partial sums).  ``op.forward(xs)`` runs the body; the backward casts
    the accs' gradients to the wire's dtype (the slabs') and runs
    ``op.backward`` over them -- the same halo, folding the transposed
    sub-layouts -- and rounds its f32 sums once to each slab's dtype.  It
    drives the mesh itself: no gradient flows through a collective."""

    @staticmethod
    def forward(ctx, op, *xs):
        ctx.op, ctx.dtypes = op, [x.dtype for x in xs]
        return tuple(op.forward(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        wire = [g.to(dt).contiguous() for g, dt in zip(gs, ctx.dtypes)]
        gxs = ctx.op.backward(wire)
        return (None,) + tuple(g.to(dt) for g, dt in zip(gxs, ctx.dtypes))


def _halo(mesh: Mesh, xs, layouts, tlayouts, axis: str, *, strategy: str,
          overlap: str, backend: str) -> list:
    """The halo of ``_halo_body(strategy, overlap)`` over the held slabs
    ``xs`` with their layouts; when a slab needs a gradient, through
    ``_Halo`` with the held owners' transposed sub-layouts ``tlayouts``
    (a ring's backward is its own body over them; the all-gather's,
    ``_allgather_local_t``)."""
    body = _halo_body(strategy, overlap)
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return body(mesh, xs, layouts, axis, backend=backend)
    if tlayouts is None:
        raise ValueError("a halo under autograd needs the transposed shard "
                         "sub-layouts (shard_transposed_layouts)")
    back = body if strategy == "ring" else _allgather_local_t
    op = types.SimpleNamespace(
        forward=lambda v: body(mesh, v, layouts, axis, backend=backend),
        backward=lambda g: back(mesh, g, tlayouts, axis, backend=backend))
    return list(_Halo.apply(op, *xs))


class _PsumScatter(torch.autograd.Function):
    """``mesh.psum_scatter`` over the feature axis, ``(mesh, axis, *xs)``;
    its adjoint is the all-gather of the output gradients over that axis,
    laid side by side along the columns (counted by the mesh)."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(mesh.psum_scatter(list(xs), axis))

    @staticmethod
    def backward(ctx, *gs):
        q = ctx.mesh.axis_size(ctx.axis)
        gs = [g.contiguous() for g in gs]
        fulls = ctx.mesh.all_gather(gs, ctx.axis)
        out = [f.view((q,) + tuple(g.shape)).transpose(0, 1).reshape(
            g.shape[0], q * g.shape[1]) for f, g in zip(fulls, gs)]
        return (None, None) + tuple(out)


def _held_layouts(mesh: Mesh, layouts, axis: str) -> list:
    """The layouts of each held shard, by its index along ``axis``."""
    return [layouts[mesh.index(c, axis)] for c in mesh.coords]


def _slab(x: torch.Tensor, r0: int, r1: int, c0: int, c1: int
          ) -> torch.Tensor:
    """Rows [r0, r1) and columns [c0, c1) of ``x``, zero-padded past its
    edges: a view when they lie inside and span every column."""
    if r1 <= x.shape[0] and (c0, c1) == (0, x.shape[1]):
        return x[r0:r1]
    out = torch.zeros((r1 - r0, c1 - c0), dtype=x.dtype, device=x.device)
    rows, cols = max(0, min(r1, x.shape[0]) - r0), \
        max(0, min(c1, x.shape[1]) - c0)
    out[:rows, :cols] = x[r0:r0 + rows, c0:c0 + cols]
    return out


def split_shards(mesh: Mesh, x: torch.Tensor, block: int, *,
                 node_axis: str, feat_axis: Optional[str] = None,
                 feature_block: Optional[int] = None) -> list:
    """The held shards' slabs of ``x`` -- natural (V, F) or the padded
    partition layout: node block p's rows (zero rows past V) and, on a 2-D
    mesh, feature block q's columns (zero columns past F)."""
    out = []
    for c in mesh.coords:
        p = mesh.index(c, node_axis)
        if feat_axis is None:
            out.append(_slab(x, p * block, (p + 1) * block, 0, x.shape[1]))
        else:
            q = mesh.index(c, feat_axis)
            out.append(_slab(x, p * block, (p + 1) * block,
                             q * feature_block,
                             (q + 1) * feature_block).contiguous())
    return out


def assemble_shards(mesh: Mesh, xs, *, node_axis: str,
                    feat_axis: Optional[str] = None) -> torch.Tensor:
    """The padded global tensor of every shard's slab (a process group
    gathers them: one counted all-gather)."""
    parts = dict(zip(mesh.all_coords, mesh.assemble(xs)))
    if feat_axis is None:
        return torch.cat([parts[c] for c in mesh.all_coords])
    rows = []
    for p in range(mesh.axis_size(node_axis)):
        row = [parts[c] for c in mesh.all_coords
               if mesh.index(c, node_axis) == p]
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows)


def _require_1d(mesh: Mesh, axis: str) -> None:
    if mesh.axis_names != (axis,):
        raise ValueError(f"a 1-D halo runs on a mesh of the one axis "
                         f"{axis!r}; got {mesh}")


def _grad_wanted(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _layouts_for(pg: PartitionedGraph, mesh: Mesh, axis: str, strategy: str,
                 layouts, tlayouts, want_grad: bool, device):
    """The held shards' forward layouts and, when a gradient is wanted,
    the held owners' transposed sub-layouts: those given, else built here
    (on the host, before the forward)."""
    if layouts is None:
        layouts = shard_layouts(pg, strategy, device=device)
    if want_grad and tlayouts is None:
        tlayouts = shard_transposed_layouts(pg, device=device)
    return (_held_layouts(mesh, layouts, axis),
            _held_layouts(mesh, tlayouts, axis) if want_grad else None)


def aggregate_allgather(pg: PartitionedGraph, x: torch.Tensor, mesh: Mesh,
                        axis: str = "data", *, layouts=None, tlayouts=None,
                        backend: str = AUTO) -> torch.Tensor:
    """x: (P*block, F) in the partition layout -> the neighbour sums
    (P*block, F), f32 (``aggregate_allgather``, :203).  ``layouts``: the
    shards' all-gather layouts (default built here, ``shard_layouts``);
    ``tlayouts``: the owners' transposed sub-layouts for a gradient
    (default built here when ``x`` needs one,
    ``shard_transposed_layouts``)."""
    return _aggregate(pg, x, mesh, axis, "allgather", "none", layouts,
                      tlayouts, backend)


def aggregate_ring(pg: PartitionedGraph, x: torch.Tensor, mesh: Mesh,
                   axis: str = "data", *, overlap: str = "none",
                   layouts=None, tlayouts=None,
                   backend: str = AUTO) -> torch.Tensor:
    """Ring halo exchange with a partial reduce per hop
    (``aggregate_ring``, :223); ``overlap`` picks the schedule, both equal
    bit for bit.  ``layouts``: the shards' ring sub-layouts, ``tlayouts``
    their transposed ones for a gradient (default built here)."""
    return _aggregate(pg, x, mesh, axis, "ring", overlap, layouts, tlayouts,
                      backend)


def _aggregate(pg, x, mesh, axis, strategy, overlap, layouts, tlayouts,
               backend) -> torch.Tensor:
    _require_uniform(pg)
    _require_1d(mesh, axis)
    _halo_body(strategy, overlap)     # validate the (strategy, overlap) pair
    backend = resolve_backend(backend, x.device)
    lays, tlays = _layouts_for(pg, mesh, axis, strategy, layouts, tlayouts,
                               _grad_wanted(x), x.device)
    xs = split_shards(mesh, x, pg.block_size, node_axis=axis)
    out = _halo(mesh, xs, lays, tlays, axis, strategy=strategy,
                overlap=overlap, backend=backend)
    return assemble_shards(mesh, out, node_axis=axis)


# ---------------------------------------------------------------------------
# Analytic side (equal to the reference's, exactly)
# ---------------------------------------------------------------------------


def halo_bytes(pg: PartitionedGraph, feature_len: int,
               dtype_bytes: int = 4) -> dict:
    """Analytic collective cost of one distributed Aggregation
    (``halo_bytes``, :249)."""
    v_padded = pg.block_size * pg.num_shards
    per_device = v_padded * feature_len * dtype_bytes * \
        (pg.num_shards - 1) / pg.num_shards
    # cut edges: sources not owned by the destination shard
    src = pg.src.cpu().numpy()
    starts = pg.vtx_start.cpu().numpy()
    owners = np.clip(np.searchsorted(starts, src, side="right") - 1, 0,
                     pg.num_shards - 1)
    mine = owners == np.arange(pg.num_shards)[:, None]
    cut_edges = int((pg.mask.cpu().numpy() * ~mine).sum())
    return {
        "allgather_bytes_per_device": per_device,
        "ring_bytes_per_device": per_device,  # same total, spread over hops
        "bytes_per_hop_per_device":           # one slab per ring hop
            pg.block_size * feature_len * dtype_bytes,
        "ring_hops": max(pg.num_shards - 1, 0),
        "cut_edges": cut_edges,
        "min_halo_bytes": cut_edges * feature_len * dtype_bytes,
    }


def _local_graph_view(pg: PartitionedGraph):
    """|V|/|E| view of a partition for the analytic cost models
    (``_local_graph_view``, :387)."""
    return types.SimpleNamespace(
        num_vertices=pg.num_vertices,
        num_edges=int(pg.mask.cpu().numpy().sum()))


def overlap_model(pg: PartitionedGraph, feature_len: int, machine, *,
                  strategy: str = "ring", dtype_bytes: int = 4) -> dict:
    """Price both ring schedules for ONE halo exchange on ``machine``
    (``overlap_model``, :287): per hop one (block, feature_len) slab over
    one link (``Machine.hop_time``) against the resident slab's partial
    combine, the aggregation roofline over the shard count.  The
    single-buffered schedule exposes every hop's wire time; the pipelined
    one hides ``min(t_wire, t_comp)`` a hop.  ``feature_len`` is the width
    the exchange moves (F/Q on a 2-D partition)."""
    from repro_torch.core.phases import aggregate_cost
    from repro_torch.profile.machine import get_machine
    m = get_machine(machine)
    nsh = pg.num_shards
    hops = max(nsh - 1, 0)
    bytes_hop = pg.block_size * feature_len * dtype_bytes
    agg = aggregate_cost(_local_graph_view(pg), feature_len, dtype_bytes)
    t_comp_hop = max(agg["flops"] / nsh / m.peak_flops,
                     agg["bytes"] / nsh / m.hbm_bw)
    if strategy == "ring" and hops > 0:
        t_wire_hop = m.hop_time(bytes_hop)
        exposed_none = hops * t_wire_hop
        overlapped = hops * min(t_wire_hop, t_comp_hop)
        exposed_pipelined = hops * max(t_wire_hop - t_comp_hop, 0.0)
    else:
        # all-gather (one collective, nothing to hide) or a single shard
        v_padded = pg.block_size * nsh
        total = v_padded * feature_len * dtype_bytes * hops / max(nsh, 1)
        t_wire_hop = m.hop_time(total) if total else 0.0
        exposed_none = exposed_pipelined = t_wire_hop
        overlapped = 0.0
    t_none = hops * t_comp_hop + exposed_none
    return {
        "strategy": strategy, "hops": hops, "bytes_per_hop": bytes_hop,
        "t_wire_hop_s": t_wire_hop, "t_comp_hop_s": t_comp_hop,
        "exposed_none_s": exposed_none,
        "exposed_pipelined_s": exposed_pipelined,
        "overlapped_pipelined_s": overlapped,
        "t_none_s": t_none,
        "saving_frac": overlapped / t_none if t_none > 0 else 0.0,
    }


def choose_overlap(pg: PartitionedGraph, feature_lens, machine, *,
                   strategy: str = "ring", dtype_bytes: int = 4) -> str:
    """Resolve ``overlap="auto"`` to "none" | "pipelined"
    (``choose_overlap``, :350): pipelined iff the modeled hidden collective
    time, summed over the layers' exchanged widths, is at least
    ``OVERLAP_SAVING_THRESHOLD`` of the single-buffered exchange time.  The
    all-gather strategy is always "none"."""
    if strategy != "ring":
        return "none"
    if isinstance(feature_lens, (int, np.integer)):
        feature_lens = [feature_lens]
    models = [overlap_model(pg, int(fl), machine, strategy=strategy,
                            dtype_bytes=dtype_bytes)
              for fl in feature_lens]
    saving = sum(m["overlapped_pipelined_s"] for m in models)
    t_none = sum(m["t_none_s"] for m in models)
    if t_none <= 0.0:
        return "none"
    return "pipelined" if saving >= OVERLAP_SAVING_THRESHOLD * t_none \
        else "none"


def halo_bytes_2d(p2: Partition2D, feature_len: int,
                  dtype_bytes: int = 4) -> dict:
    """The 1-D halo numbers at the F/Q column slice a 2-D shard exchanges
    (``halo_bytes_2d``, :596)."""
    out = halo_bytes(p2.nodes, p2.feature_block(feature_len), dtype_bytes)
    out["feat_shards"] = p2.feat_shards
    return out


def wire_dtype_bytes(dtype: str) -> int:
    """Bytes per element the halo collectives move (``wire_dtype_bytes``,
    :610): bf16 2, f32 4, int8-agg 4 (its f32 carrier)."""
    return {"f32": 4, "bf16": 2, "int8-agg": 4}[dtype]


def schedule_wire_bytes(partition, feature_len: int, *,
                        strategy: str = "ring", overlap: str = "none",
                        dtype: str = "f32", combine_out_len=None) -> dict:
    """Schedule-exact bytes one shard's collectives take in over ONE
    distributed layer, by collective (``schedule_wire_bytes``, :623): the
    single-buffered ring P slab sends, the pipelined P-1, the all-gather
    its local slab; a 2-D partition's slab is ``feature_block(...)`` wide
    and each layer adds one ``psum_scatter`` of the f32 partial product
    ``(block, Q * feature_block(combine_out_len))``.  A mesh's counters
    (``Mesh.collective_bytes``) equal it layer by layer."""
    two_d = isinstance(partition, Partition2D)
    pg = partition.nodes if two_d else partition
    if two_d and combine_out_len is None:
        raise ValueError("2-D schedules need combine_out_len (the layer's "
                         "dout) to price the feature-axis psum_scatter")
    wire = wire_dtype_bytes(dtype)
    flen = partition.feature_block(feature_len) if two_d else feature_len
    out = {"ppermute_sends": 0, "ppermute_bytes_per_send": 0,
           "ppermute_bytes": 0, "all_gather_bytes": 0,
           "reduce_scatter_bytes": 0, "psum_bytes": 0,
           "wire_dtype_bytes": wire}
    if strategy == "ring":
        sends = pg.num_shards if overlap == "none" \
            else max(pg.num_shards - 1, 0)
        per = pg.block_size * flen * wire
        out.update(ppermute_sends=sends, ppermute_bytes_per_send=per,
                   ppermute_bytes=sends * per)
    elif strategy == "allgather":
        out["all_gather_bytes"] = pg.block_size * flen * wire
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    if two_d:
        fb_out = partition.feature_block(combine_out_len)
        out["reduce_scatter_bytes"] = \
            pg.block_size * partition.feat_shards * fb_out * 4
    out["total_bytes"] = (out["ppermute_bytes"] + out["all_gather_bytes"]
                          + out["reduce_scatter_bytes"] + out["psum_bytes"])
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _reduce_wire(h: torch.Tensor, dtype: str) -> torch.Tensor:
    """The halo operand at the plan dtype's wire width (``_reduce_wire``,
    :395): a bf16 cast, int8 per-row fake quantization (f32 carrier), or
    unchanged for f32."""
    if dtype == "bf16":
        return h.to(torch.bfloat16)
    if dtype == "int8-agg":
        from repro_torch.core.phases import quantize_int8
        return quantize_int8(h)
    return h


def _rdeg(in_deg: torch.Tensor, dtype: torch.dtype, rows: int
          ) -> torch.Tensor:
    """(rows, 1) reciprocal of in-degree + 1 over the padded rows (pad
    rows: 1), multiplied, never divided (:450-456)."""
    deg = torch.clamp(in_deg.to(torch.promote_types(dtype, torch.float32))
                      + 1.0, min=1.0)[:, None]
    deg = torch.nn.functional.pad(deg, (0, 0, 0, rows - deg.shape[0]))
    return 1.0 / torch.where(deg == 0, 1.0, deg)


def _resolve_order(pg: PartitionedGraph, order, f_in: int, f_out: int):
    if order is not None:
        return order
    from repro_torch.core.scheduler import choose_ordering
    return choose_ordering(_local_graph_view(pg), f_in, f_out,
                           agg_op="mean", n_mlp_layers=1)


def gcn_layer_shards(mesh: Mesh, xs, w, bias, rdegs, layouts, *, order: str,
                     strategy: str, axis: str, overlap: str, dtype: str,
                     backend: str, tlayouts=None) -> list:
    """One 1-D distributed GCN layer over the held shards' slabs ``xs``
    (each (block, din)), their (block, 1) reciprocal degrees and their
    layouts; returns the held shards' (block, dout) outputs.  Under
    autograd the halo needs the held owners' transposed sub-layouts
    ``tlayouts``; ``w`` and ``bias`` are replicated (``Mesh.replicated``)."""
    from repro_torch.core.phases import _mm
    _halo_body(strategy, overlap)     # validate the (strategy, overlap) pair
    ws, bs = _shard_params(mesh, w, bias, len(xs), dtype)
    if dtype == "bf16":
        xs = [x.to(torch.bfloat16) for x in xs]

    def halo(slabs):
        return _halo(mesh, slabs, layouts, tlayouts, axis,
                     strategy=strategy, overlap=overlap, backend=backend)

    if order == "combine_first":
        hs = [_reduce_wire(_mm(x, wi), dtype)               # the wire's h
              for x, wi in zip(xs, ws)]
        outs = [(a + h) * r for a, h, r in zip(halo(hs), hs, rdegs)]
    else:
        xws = [_reduce_wire(x, dtype) for x in xs]          # the wire's x
        outs = [_mm((a + xw) * r, wi)
                for a, xw, r, wi in zip(halo(xws), xws, rdegs, ws)]
    outs = [o + b for o, b in zip(outs, bs)]
    return [o.to(torch.bfloat16) for o in outs] if dtype == "bf16" else outs


def _shard_params(mesh: Mesh, w, bias, n: int, dtype: str):
    """W and the bias as each of ``n`` held shards uses them: replicated
    (``Mesh.replicated``) and, in a bf16 layer, cast once a shard, so each
    shard's gradient reaches the f32 parameter unrounded and the shards'
    partials add in f32, as on a process group (and in the reference's
    ``shard_map``)."""
    w, bias = mesh.replicated(w), mesh.replicated(bias)
    if dtype != "bf16":
        return [w] * n, [bias] * n
    return ([w.to(torch.bfloat16) for _ in range(n)],
            [bias.to(torch.bfloat16) for _ in range(n)])


def distributed_gcn_layer(pg: PartitionedGraph, x, w, bias, in_deg,
                          mesh: Mesh, *, order: Optional[str] = None,
                          strategy: str = "ring", axis: str = "data",
                          overlap: str = "none", dtype: str = "f32",
                          layouts=None, tlayouts=None, backend: str = AUTO):
    """One distributed GCN layer with explicit phase ordering
    (``distributed_gcn_layer``, :408): combine-first projects each shard's
    rows and exchanges dout-wide rows; aggregate-first exchanges din-wide
    rows, then projects.  ``order=None`` asks the scheduler.  ``overlap``
    picks the ring's schedule (bit for bit equal); ``dtype`` the plan's
    precision: "bf16" moves bf16 slabs and accumulates f32 partials,
    "int8-agg" fake-quantizes the exchanged operand.  x: (V or P*block,
    din); returns (P*block, dout), differentiable in x, w and bias (the
    transposed sub-layouts ``tlayouts`` built here when a gradient is
    wanted and none are given).  Model code reaches it through a plan
    built with ``mesh=`` (``core/plan.py``)."""
    _require_uniform(pg)
    _require_1d(mesh, axis)
    _halo_body(strategy, overlap)     # validate the (strategy, overlap) pair
    order = _resolve_order(pg, order, int(w.shape[0]), int(w.shape[1]))
    backend = resolve_backend(backend, x.device)
    lays, tlays = _layouts_for(pg, mesh, axis, strategy, layouts, tlayouts,
                               _grad_wanted(x, w, bias), x.device)
    block = pg.block_size
    xs = split_shards(mesh, x, block, node_axis=axis)
    rdeg = _rdeg(in_deg, x.dtype, block * pg.num_shards)
    rdegs = split_shards(mesh, rdeg, block, node_axis=axis)
    out = gcn_layer_shards(mesh, xs, w, bias, rdegs, lays, order=order,
                           strategy=strategy, axis=axis, overlap=overlap,
                           dtype=dtype, backend=backend, tlayouts=tlays)
    return assemble_shards(mesh, out, node_axis=axis)


def pad_features_2d(x: torch.Tensor, p2: Partition2D) -> torch.Tensor:
    """Pad (V, F) features to the (P*block, Q*fblock) partition layout
    (``pad_features_2d``, :472)."""
    fb = p2.feature_block(x.shape[1])
    rows = p2.block_size * p2.node_shards - x.shape[0]
    cols = fb * p2.feat_shards - x.shape[1]
    return torch.nn.functional.pad(x, (0, cols, 0, rows))


def gcn_layer_2d_shards(mesh: Mesh, xs, w, bias, rdegs, layouts, *,
                        p2: Partition2D, order: str, strategy: str, axes,
                        overlap: str, dtype: str, backend: str,
                        tlayouts=None) -> list:
    """One 2-D layer over the held shards' (block, fb_in) slabs: the halo
    along the node axis on F/Q-wide columns, a partial product by W's
    matching row block and one ``psum_scatter`` over the feature axis;
    returns (block, fb_out) slabs (pad columns exact zeros).  Under
    autograd as ``gcn_layer_shards``; the ``psum_scatter``'s adjoint is an
    all-gather over the feature axis."""
    from repro_torch.core.phases import _mm
    node_ax, feat_ax = axes
    q_sh = p2.feat_shards
    f_in, f_out = int(w.shape[0]), int(w.shape[1])
    fb_in, fb_out = p2.feature_block(f_in), p2.feature_block(f_out)
    _halo_body(strategy, overlap)     # validate the (strategy, overlap) pair
    ws, bs = _shard_params(mesh, w, bias, len(xs), dtype)
    if dtype == "bf16":
        xs = [x.to(torch.bfloat16) for x in xs]
    # each shard's W rows and bias columns, zero-padded onto the (Q*fb_in,
    # Q*fb_out) grid: pad x columns meet zero W rows, pad W columns give
    # zero outputs
    pad = torch.nn.functional.pad
    qs = [mesh.index(c, feat_ax) for c in mesh.coords]
    w_blocks = [pad(wi[q * fb_in:(q + 1) * fb_in],
                    (0, q_sh * fb_out - f_out,
                     0, fb_in - max(0, min(fb_in, f_in - q * fb_in))))
                for wi, q in zip(ws, qs)]
    b_blocks = [pad(bi, (0, q_sh * fb_out - f_out))[q * fb_out:
                                                    (q + 1) * fb_out]
                for bi, q in zip(bs, qs)]

    def combine(hs):
        # the partial product, closed by a reduce-scatter over the feature
        # axis: each shard receives its own (block, fb_out) columns
        return list(_PsumScatter.apply(
            mesh, feat_ax, *[_mm(h, wq) for h, wq in zip(hs, w_blocks)]))

    def halo(slabs):
        return _halo(mesh, slabs, layouts, tlayouts, node_ax,
                     strategy=strategy, overlap=overlap, backend=backend)

    if order == "combine_first":
        hq = [_reduce_wire(h, dtype) for h in combine(xs)]
        outs = [(a + h) * r for a, h, r in zip(halo(hq), hq, rdegs)]
    else:
        xws = [_reduce_wire(x, dtype) for x in xs]
        outs = combine([(a + xw) * r
                        for a, xw, r in zip(halo(xws), xws, rdegs)])
    outs = [o + b for o, b in zip(outs, b_blocks)]
    return [o.to(torch.bfloat16) for o in outs] if dtype == "bf16" else outs


def distributed_gcn_layer_2d(p2: Partition2D, x, w, bias, in_deg,
                             mesh: Mesh, *, order: Optional[str] = None,
                             strategy: str = "ring", axes=("node", "feat"),
                             overlap: str = "none", dtype: str = "f32",
                             layouts=None, tlayouts=None,
                             backend: str = AUTO):
    """One GCN layer on a 2-D (node x feature) mesh
    (``distributed_gcn_layer_2d``, :480).  ``x`` in the padded (P*block,
    Q*fblock_in) layout (``pad_features_2d``); returns (P*block,
    Q*fblock_out), pad columns exact zeros.  Arguments as
    ``distributed_gcn_layer``'s; ``axes`` names the (node, feature) axes."""
    pg = p2.nodes
    _require_uniform(pg)
    node_ax, feat_ax = axes
    if mesh.axis_names != tuple(axes):
        raise ValueError(f"a 2-D layer runs on a mesh of axes {tuple(axes)};"
                         f" got {mesh}")
    nsh, block = pg.num_shards, pg.block_size
    f_in, f_out = int(w.shape[0]), int(w.shape[1])
    fb_in = p2.feature_block(f_in)
    order = _resolve_order(pg, order, f_in, f_out)
    _halo_body(strategy, overlap)
    expect = (nsh * block, p2.feat_shards * fb_in)
    if tuple(x.shape) != expect:
        raise ValueError(f"x must be in the padded 2-D layout {expect}, "
                         f"got {tuple(x.shape)} (see pad_features_2d)")
    backend = resolve_backend(backend, x.device)
    lays, tlays = _layouts_for(pg, mesh, node_ax, strategy, layouts,
                               tlayouts, _grad_wanted(x, w, bias), x.device)
    xs = split_shards(mesh, x, block, node_axis=node_ax, feat_axis=feat_ax,
                      feature_block=fb_in)
    rdeg = _rdeg(in_deg, x.dtype, block * nsh)
    rdegs = split_shards(mesh, rdeg, block, node_axis=node_ax)
    out = gcn_layer_2d_shards(mesh, xs, w, bias, rdegs, lays, p2=p2,
                              order=order, strategy=strategy, axes=axes,
                              overlap=overlap, dtype=dtype, backend=backend,
                              tlayouts=tlays)
    return assemble_shards(mesh, out, node_axis=node_ax, feat_axis=feat_ax)


__all__ = [
    "COLLECTIVES", "OVERLAP_MODES", "OVERLAP_SAVING_THRESHOLD", "Mesh",
    "TRANSPOSE_CAP", "LocalMesh", "ProcessGroupMesh", "shard_tile",
    "shard_layouts", "shard_transposed_layouts",
    "pad_features", "pad_features_2d", "split_shards", "assemble_shards",
    "aggregate_allgather", "aggregate_ring", "halo_bytes", "halo_bytes_2d",
    "overlap_model", "choose_overlap", "wire_dtype_bytes",
    "schedule_wire_bytes", "distributed_gcn_layer",
    "distributed_gcn_layer_2d", "gcn_layer_shards", "gcn_layer_2d_shards",
]
