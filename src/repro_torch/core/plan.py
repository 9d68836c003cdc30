"""GraphExecutionPlan: one planning/dispatch layer (``repro/core/plan.py``).

Decided ONCE per (graph, model, machine) and replayed on every forward:

  * **Phase ordering (paper F2).**  ``scheduler.choose_ordering`` priced on
    the plan's ``Machine`` (default ``H100``); GIN is pinned to
    aggregate-first.
  * **Tier.**  ``torch`` (plain PyTorch) or ``cuda`` (the hand-written
    kernels); ``"auto"`` resolves by the graph's device.
  * **Inter-phase fusion (paper F5).**  The fused layer needs a
    ``BlockedGraph`` with ``suggest_tile_m`` rows per block; the plan builds
    it once (``_blocked_for``, cached per graph).  GIN fuses aggregation
    with its FIRST matmul.  Every ``cuda`` layer also owns the layout its
    unfused aggregation runs on (``LayerPlan.agg_layout``).
  * **Locality reordering (paper F4, §5.1-1).**  ``reorder="degree"``
    (or "auto", priced by ``graph.reorder.choose_reorder``) renumbers the
    vertices once at build time; the forward permutes the features at
    ingress and the logits back at egress, so callers see the natural
    vertex order.
  * **Execution dtype.**  "f32"; "bf16" (bf16 storage at every phase
    boundary, f32 accumulation: the kernels' bf16 instances on the cuda
    tier); "int8-agg" (the aggregation operand fake-quantized per row,
    ``phases.quantize_int8``); "auto" priced by
    ``profile.machine.choose_dtype``.
  * **Pair dedup.**  ``dedup="pairs"`` (or "auto", priced by
    ``choose_dedup``) aggregates two-level over a
    ``graph.dedup.DedupLayout`` matched once at build time.
  * **Compiled execution.**  ``plan.compile()`` is the forward as a
    ``CompiledPlan``: on a card one CUDA graph per input signature (and,
    when a gradient is wanted, a second one for the backward), on the CPU
    the eager forward under the same caching and retrace guard.
  * **Shard partition.**  ``mesh=`` (a ``core.distributed`` ``LocalMesh``
    or ``ProcessGroupMesh``) plans distributed execution: one named axis
    gives the 1-D vertex partition (``graph.partition.partition_1d``), two
    (node, feature) the 2-D one (``partition_2d``); the layers run through
    ``core.distributed``'s ring or all-gather halo with each shard's sums
    in K1 (``strategy=``, the ring's ``overlap=`` schedule, "auto" priced
    by ``choose_overlap``).  The distributed forward is differentiable:
    the halos' backward folds the capped transposed shard sub-layouts,
    which the plan builds on first need and caches with the shard layouts.
    ``compile()`` captures it like a local forward, the mesh's
    communication stream and a process group's NCCL collectives inside
    the graphs.

A bucket plan (the
minibatch trainer's) dispatches runtime graphs, each bringing its own
edge arrays, its dedup arrays (``dedup_pad=``) and, on the cuda tier, its
host-built blocked layouts (``runtime_layout``, passed beside the graph),
eagerly or through ``compile(dynamic=True)``, under autograd too.  On the
cuda tier the forward is differentiable: K1's backward runs over each
layout's capped transposed layout -- a runtime graph's built with it at
the bucket's fixed capacity, a plan's own built on first need and kept
(``with_transposed``).

Public surface::

  build_plan(g, cfg, in_dim, num_classes, ...)  -> GraphExecutionPlan
  plan.run_model(params, x)       full forward through all planned layers
  plan.run_layer(params_i, x, layer=i)
  plan.run_phases(x, weights, ...)
  plan.compile(donate=, layer=, dynamic=)       -> CompiledPlan
  plan.runtime_layout(src, dst, ...)             a runtime graph's layout
  plan.with_transposed(bg)        a plan layout with its transposed layout
  plan.instrument(machine=)       -> profile.instrument.InstrumentedPlan
  plan.describe()                 decisions + modeled aggregation cost
  plan.layer_costs(layer)         analytic per-phase costs (Tables 3/4)
"""

from __future__ import annotations

import contextlib
import functools
import gc
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import phases
from repro_torch.core.backend import (AUTO, CUDA, require_device,
                                      resolve_backend, resolve_device)
from repro_torch.core.dataflow import (TRANSPOSE_CAP, BlockedGraph,
                                       block_graph, block_graph_arrays,
                                       fused_gcn_layer, suggest_tile_m)
from repro_torch.core.scheduler import (AGGREGATE_FIRST, COMBINE_FIRST,
                                        choose_ordering, ordering_cost)
from repro_torch.graph.partition import Partition2D
from repro_torch.graph.structure import Graph
from repro_torch.profile.machine import Machine, get_machine

# ---------------------------------------------------------------------------
# Plan data model
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class LayerPlan:
    """All decisions for one graph-conv layer (``LayerPlan``, :91)."""

    index: int
    kind: str                 # "gcn" | "sage" | "gin" | "phase"
    dims: Tuple[int, ...]     # (din, [hidden...,] dout) of the combination MLP
    agg_op: str               # "sum" | "mean" | "max"
    include_self: bool
    order: str                # COMBINE_FIRST | AGGREGATE_FIRST (resolved)
    backend: str              # "torch" | "cuda" (resolved, never "auto")
    fused: bool               # inter-phase dataflow fusion (F5)
    tile_m: int               # fused tile rows (0 when unfused)
    blocked: Optional[BlockedGraph]  # fused layout (None when unfused)
    #: layout of the UNFUSED aggregation on the cuda tier (also the fusion
    #: fallback's); None on the torch tier
    agg_layout: Optional[BlockedGraph] = None

    @property
    def din(self) -> int:
        return self.dims[0]

    @property
    def dout(self) -> int:
        return self.dims[-1]

    @property
    def n_mlp(self) -> int:
        return len(self.dims) - 1


class GraphExecutionPlan:
    """Precomputed execution recipe for a model over one fixed graph."""

    def __init__(self, g: Graph, layers: Sequence[LayerPlan], *,
                 machine: Machine, reorder: str = "none", perm=None,
                 dtype: str = "f32", dedup: str = "none",
                 dedup_layout=None, dedup_pad: Optional[tuple] = None,
                 mesh=None, partition=None, strategy: str = "ring",
                 axis: str = "data", axes: Tuple[str, str] = ("node", "feat"),
                 overlap: str = "none", shard_layouts=None):
        self.g = g                   # the execution graph (renumbered when
                                     # reorder="degree")
        self.layers: Tuple[LayerPlan, ...] = tuple(layers)
        self.machine = machine
        self.mesh = mesh
        self.partition = partition   # None | PartitionedGraph | Partition2D
        self.strategy = strategy     # "ring" | "allgather"
        self.axis = axis             # 1-D partition: the mesh's one axis
        self.axes = axes             # 2-D partition: (node, feature) axes
        self.overlap = overlap       # "none" | "pipelined" (resolved)
        #: K1's layouts of the held node shards (core.distributed
        #: .shard_layouts), shared by every layer
        self.shard_layouts = shard_layouts
        self.reorder = reorder       # "none" | "degree" (resolved)
        self.dtype = dtype           # "f32" | "bf16" | "int8-agg" (resolved)
        self.dedup = dedup           # "none" | "pairs" (resolved; never
                                     # "pairs" with zero matched pairs)
        self.dedup_layout = dedup_layout  # graph.dedup.DedupLayout | None
        #: (num_pairs, num_edges2) of a bucket plan, whose dedup layout is
        #: padded with sink edges: it serves runtime dispatch only
        self.dedup_pad = dedup_pad
        # perm[old_id] = new_id (degree_reorder's contract), inv[new_id] =
        # old_id: device tensors the ingress and egress gathers read
        if perm is not None:
            perm = torch.as_tensor(np.asarray(perm, np.int64))
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(len(perm))
            self.perm, self.inv = perm.to(g.device), inv.to(g.device)
        else:
            self.perm = self.inv = None
        self._compiled: Dict = {}    # (donate, layer, dynamic) -> CompiledPlan
        self._transposed: Dict = {}  # (id(layout), rows) -> its transposed

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def device(self) -> torch.device:
        return self.g.device

    @property
    def distributed(self) -> bool:
        return self.partition is not None

    @property
    def partition_kind(self) -> str:
        """"none" | "1d" | "2d": which shard partition the plan owns."""
        if self.partition is None:
            return "none"
        return "2d" if isinstance(self.partition, Partition2D) else "1d"

    @property
    def _node_partition(self):
        """The node partition (a 2-D partition's ``nodes``)."""
        return self.partition.nodes if self.partition_kind == "2d" \
            else self.partition

    @property
    def agg_tile(self) -> int:
        """Rows per block of the cuda tier's aggregation layouts (every
        layer's, since they share the graph); 0 on the torch tier."""
        return next((lp.agg_layout.tile_m for lp in self.layers
                     if lp.agg_layout is not None), 0)

    def runtime_layout(self, src, dst, *, num_rows: Optional[int] = None,
                       max_in_deg: Optional[int] = None,
                       transposed: bool = False) -> BlockedGraph:
        """The cuda tier's blocked layout of a graph dispatched at run
        time, built on the host over the plan's V destination rows: the
        graph's (passed beside it, ``graph_layout=``), or for a runtime
        dedup layout its level 2 (``DedupLayout.blocked``).

        src, dst: the REAL edges, destination-sorted numpy arrays.  Pad
        edges stay out: they are sink no-ops, so every row but the sink is
        what the padded edge list gives.  ``num_rows``: rows of the
        gathered matrix (default V; V + P for level 2).  ``max_in_deg``
        bounds each row's edges, fixing ``emax`` at ``agg_tile *
        max_in_deg`` rounded up to 8, the static shape a
        ``compile(dynamic=True)`` capture needs (a block over it raises);
        by default ``emax`` fits this graph.  ``transposed`` also builds
        the layout K1's backward runs over, in its capped form
        (``TRANSPOSE_CAP``, as a plan keeps for its own layouts); with
        ``max_in_deg`` at the fixed capacity of as many edges as the
        plan's graph has -- a bucket plan's template holds the bucket's
        edge count, which a runtime graph's real edges (and a dedup
        layout's level 2) never pass (``core.dataflow.
        transposed_capacity``) -- so the layouts of two graphs of one
        bucket have equal shapes and a graph captured over one replays
        over the other."""
        tile = self.agg_tile
        if not tile:
            raise ValueError("runtime layouts serve cuda-tier plans; this "
                             "plan aggregates on the torch tier")
        v = self.g.num_vertices
        emax = edges = None
        if max_in_deg is not None:
            emax = -(-tile * int(max_in_deg) // 8) * 8
            edges = self.g.num_edges
        return block_graph_arrays(
            src, dst, v, tile, device=self.device, emax=emax,
            transpose_rows=(v if num_rows is None else int(num_rows))
            if transposed else None, transpose_cap=TRANSPOSE_CAP,
            max_edges=edges)

    def with_transposed(self, bg: BlockedGraph,
                        num_rows: Optional[int] = None) -> BlockedGraph:
        """``bg``, a layout this plan owns, with the transposed layout K1's
        backward runs over (``num_rows`` rows of the gathered matrix,
        default V) attached: the capped form (``core.dataflow.
        TRANSPOSE_CAP``, as the halos' backward layouts: a hub source's row
        would make the uncapped layout's blocks as long as the hub), built
        on the host on first need and kept by the plan, so it goes with the
        plan (``clear_plan_cache``)."""
        rows = self.g.num_vertices if num_rows is None else int(num_rows)
        key = (id(bg), rows)
        t = self._transposed.get(key)
        if t is None:
            from repro_torch.core.dataflow import transposed_layout
            t = self._transposed[key] = transposed_layout(bg, rows,
                                                          TRANSPOSE_CAP)
        return bg._replace(transposed=t)

    @property
    def compile_supported(self) -> bool:
        """True when every ``cuda`` layer owns its plan-built layouts --
        a local layer its ``agg_layout``, a distributed one the plan's
        shard layouts -- so the forward does no host work and can be
        captured (``compile_supported``, :183).  Plans built by the public
        entry points always qualify; False for hand-built plans missing
        them."""
        if self.distributed:
            return self.shard_layouts is not None
        return all(lp.backend != CUDA or lp.agg_layout is not None
                   for lp in self.layers)

    @staticmethod
    def _split_params(lp: LayerPlan, params: Dict):
        """Conv param subtree -> (weights list, post-aggregation bias)."""
        if "lin" in params:
            return [(params["lin"]["w"], None)], params["lin"]["b"]
        weights = []
        j = 1
        while f"mlp{j}" in params:
            weights.append((params[f"mlp{j}"]["w"], params[f"mlp{j}"]["b"]))
            j += 1
        return weights, None

    def run_layer(self, params: Dict, x: torch.Tensor, *, layer: int = 0,
                  _probe=None, graph: Optional[Graph] = None,
                  graph_layout: Optional[BlockedGraph] = None,
                  dedup_layout=None) -> torch.Tensor:
        """One planned layer from its conv param subtree ({"lin": ...} or
        {"mlp1": ..., "mlp2": ...}), in the plan's execution layout (on a
        reordered plan, rows in the renumbered order; ``run_model`` does
        the permutations).  ``graph`` overrides the plan's graph for this
        dispatch (the dynamic mode of ``compile(dynamic=True)``): a
        torch-tier layer reads its edge arrays, a cuda-tier layer the
        graph's blocked layout, ``graph_layout`` (``runtime_layout``).
        ``dedup_layout`` likewise replaces the plan's own two-level layout,
        which never applies to an overriding graph.  A cuda-tier layer
        whose result needs a gradient runs over the plan's layouts with
        their transposed ones (``with_transposed``).  On a distributed
        plan ``x`` is the padded partition layout (``_ingress``) and so is
        the result."""
        lp = self.layers[layer]
        weights, bias_post = self._split_params(lp, params)
        if self.distributed:
            if graph is not None or dedup_layout is not None:
                self._check_dynamic_ok()
            shards = self._run_distributed(lp, self._split(x), weights,
                                           bias_post, probe=_probe)
            return self._assemble(shards)
        if graph is None and dedup_layout is None and \
                self.dedup_pad is not None:
            raise ValueError(
                "this plan was built with dedup_pad= for runtime dispatch: "
                "its own dedup layout is padded with sink edges, so it "
                "takes a graph (graph=) and that graph's dedup layout "
                "(dedup_layout=) on every forward")
        dedup = dedup_layout if graph is not None or \
            dedup_layout is not None else self.dedup_layout
        layout = None
        if graph is not None and lp.backend == CUDA:
            if graph_layout is None:
                raise ValueError(
                    "a graph dispatched at run time on the cuda tier brings "
                    "its own blocked layout: graph_layout="
                    "plan.runtime_layout(src, dst)")
            layout = graph_layout
        elif graph is None and lp.backend == CUDA and \
                lp.agg_layout is not None and torch.is_grad_enabled() and \
                (x.requires_grad or any(t.requires_grad
                                        for _, t in _leaves(params))):
            layout = self.with_transposed(lp.agg_layout)
            if dedup is self.dedup_layout and dedup is not None and \
                    dedup.blocked is not None:
                dedup = dedup._replace(blocked=self.with_transposed(
                    dedup.blocked, self.g.num_vertices + dedup.num_pairs))
        return _execute_layer(self.g if graph is None else graph, lp, x,
                              weights, bias_post=bias_post, probe=_probe,
                              dtype=self.dtype, dedup=dedup, layout=layout)

    def _permute_in(self, x: torch.Tensor, *, _probe=None) -> torch.Tensor:
        """The planned renumbering, ``x_new = x[inv]``."""
        if self.inv is None:
            return x
        if x.shape[0] != self.g.num_vertices:
            raise ValueError(
                f"reordered plans take features in the natural (V, F) "
                f"layout; got {tuple(x.shape)} for V={self.g.num_vertices}")
        if _probe is not None:
            _probe.note_reorder()
        return x[self.inv]

    def _ingress(self, x: torch.Tensor, *, _probe=None) -> torch.Tensor:
        """Natural (V, F) features -> the execution layout: the planned
        renumbering, then on a distributed plan the partition padding
        (rows; on a 2-D partition feature columns too) (``_ingress``,
        :251)."""
        x = self._permute_in(x, _probe=_probe)
        if self.distributed and x.shape[0] == self.g.num_vertices:
            from repro_torch.core import distributed as dist
            if self.partition_kind == "2d":
                return dist.pad_features_2d(x, self.partition)
            return dist.pad_features(x, self.partition.block_size,
                                     self.partition.num_shards)
        return x

    def _egress(self, h: torch.Tensor) -> torch.Tensor:
        """Execution layout -> natural order: the partition padding
        trimmed, then ``out_old = h[perm]`` (``_egress``, :274)."""
        if self.distributed:
            h = h[:self.g.num_vertices]
            if self.partition_kind == "2d":
                h = h[:, :self.layers[-1].dout]
        return h if self.perm is None else h[self.perm]

    def _dist_axes(self):
        """(node axis, feature axis or None) of the plan's mesh."""
        if self.partition_kind == "2d":
            return self.axes[0], self.axes[1]
        return self.axis, None

    def _split(self, x: torch.Tensor) -> list:
        """The held shards' slabs of ``x`` (natural or padded layout)."""
        from repro_torch.core.distributed import split_shards
        node_ax, feat_ax = self._dist_axes()
        # natural F columns or the padded Q * fb: either way fb columns
        fb = self.partition.feature_block(x.shape[1]) if feat_ax else None
        return split_shards(self.mesh, x, self._node_partition.block_size,
                            node_axis=node_ax, feat_axis=feat_ax,
                            feature_block=fb)

    def _assemble(self, shards) -> torch.Tensor:
        """The padded global tensor of every shard's slab."""
        from repro_torch.core.distributed import assemble_shards
        node_ax, feat_ax = self._dist_axes()
        return assemble_shards(self.mesh, shards, node_axis=node_ax,
                               feat_axis=feat_ax)

    def run_model(self, params: Dict, x: torch.Tensor, *, _probe=None,
                  compiled: bool = False, graph: Optional[Graph] = None,
                  graph_layout: Optional[BlockedGraph] = None,
                  dedup_layout=None) -> torch.Tensor:
        """Full forward: planned layers with ReLU between them.

        Takes ``x`` and returns the logits in the natural vertex order; a
        reordered plan permutes the rows at ingress and back at egress.
        ``compiled=True`` routes through ``plan.compile()`` (or
        ``compile(dynamic=True)`` with ``graph=``) instead of the eager
        per-phase loop.  ``graph=`` substitutes another graph's edge arrays
        for this dispatch while replaying the same planned decisions; only
        unfused unreordered plans accept it, ``x`` rows must match it, a
        cuda-tier plan needs the graph's own blocked layout
        (``graph_layout``, ``runtime_layout``) and a dedup plan that
        graph's own ``dedup_layout``.  A plan built with ``dedup_pad=``
        serves runtime dispatch only.  The eager forward is differentiable
        on both tiers (K1's backward on the cuda tier).  A distributed
        plan splits ``x`` into its shards' slabs, runs every layer over
        them and assembles the logits (a process group gathers them on
        every rank); under autograd each replicated parameter's gradient
        comes out summed over the mesh, on every rank
        (``core.distributed``'s adjoints).
        """
        if compiled:
            if _probe is not None:
                raise ValueError(
                    "per-phase instrumentation needs eager phase "
                    "boundaries; InstrumentedPlan times the compiled "
                    "path separately (run_model(..., compiled=True))")
            if graph is not None:
                return self.compile(dynamic=True)(
                    params, x, graph, dedup=dedup_layout,
                    layout=graph_layout)
            return self.compile()(params, x)
        if graph is not None:
            self._check_dynamic_ok()
            if self.dedup == "pairs" and dedup_layout is None:
                raise ValueError(
                    "this plan's dedup='pairs' layout was matched on its own "
                    "graph; dispatch over a substitute graph needs that "
                    "graph's layout (dedup_layout=)")
        if self.distributed:
            shards = self._split(self._permute_in(x, _probe=_probe))
            for i in range(self.num_layers):
                lp = self.layers[i]
                weights, bias_post = self._split_params(
                    lp, params[f"conv{i}"])
                shards = self._run_distributed(lp, shards, weights,
                                               bias_post, probe=_probe)
                if i < self.num_layers - 1:
                    shards = [torch.relu(s) for s in shards]
            return self._egress(self._assemble(shards))
        h = self._ingress(x, _probe=_probe)
        for i in range(self.num_layers):
            h = self.run_layer(params[f"conv{i}"], h, layer=i, _probe=_probe,
                               graph=graph, graph_layout=graph_layout,
                               dedup_layout=dedup_layout)
            if i < self.num_layers - 1:
                h = torch.relu(h)
        return self._egress(h)

    def _check_dynamic_ok(self) -> None:
        """Dynamic (graph-as-argument) dispatch needs a forward over what
        the runtime graph brings: torch-tier unfused layers read its edge
        arrays, cuda-tier unfused layers its blocked layout.  Fused layers
        run over the fused tile's layout of the plan's own graph and a
        reordered plan over a permutation of it, so they are refused
        (``_check_dynamic_ok``, :334)."""
        problems = []
        if self.distributed:
            problems.append("partitioned plans bake edge-derived shards")
        if self.perm is not None:
            problems.append("the plan is reordered (an edge-derived "
                            "permutation of its own graph)")
        problems += [f"layer {lp.index} is fused over its own graph's "
                     f"blocked layout" for lp in self.layers if lp.fused]
        if problems:
            raise ValueError(
                "dynamic graph dispatch needs a forward over the runtime "
                "graph's arrays: " + "; ".join(problems) + " (build the "
                "bucket plan with fused=False, reorder='none')")

    def compile(self, *, donate: bool = False, layer: Optional[int] = None,
                dynamic: bool = False) -> "CompiledPlan":
        """The planned forward as ONE callable (``compile``, :358).

        On a CUDA plan, ``CompiledPlan`` captures the forward as a
        ``torch.cuda.CUDAGraph`` per input signature and replays it; on a
        CPU plan it runs the eager forward under the same caching,
        signature and retrace contract.  Eager and compiled results are
        equal bit for bit on the CPU and on the ``cuda`` tier (no atomics);
        the ``torch`` tier on a card aggregates with float atomics
        (``index_add_``), so there they agree within the f32 band.

        Args:
          donate: the caller gives up each result at the next call: on a
            card the result IS the graph's static output buffer, which the
            next replay overwrites (no copy); without it every call returns
            a fresh clone.  On the CPU every call returns a fresh tensor.
          layer: compile one planned layer, ``(conv_params, h) -> h'``,
            instead of the full model (per-layer compiled timing).
          dynamic: the graph becomes a runtime argument, ``(params, x,
            graph, dedup=, layout=)``: any ``Graph`` whose ``src``/``dst``/
            ``in_deg`` shapes match the plan's -- on the cuda tier with its
            blocked layout at a fixed capacity (``layout=runtime_layout(
            ..., max_in_deg=)``), whose shape joins the signature -- and,
            for a dedup plan, the block's dedup layout padded to the plan's
            ``dedup_pad`` (``graph.dedup.pad_dedup_arrays``; on the cuda
            tier with its level-2 ``blocked`` layout); edge content varies
            per call with no recapture.  Unfused unreordered plans only;
            not with ``layer=``.  A plan built with ``dedup_pad=`` compiles
            only this mode.

        Reorder, bf16, int8-agg and dedup plans capture like any other: the
        permutation gathers, the casts and the pair partials are device
        work inside the forward.  So do distributed plans: the shard
        slabs, the halos' copies on a ``LocalMesh``'s communication stream
        (forked from and joined back to the captured stream by events) and
        a ``ProcessGroupMesh``'s NCCL collectives are device work, and the
        mesh's byte counters, which run on the host, move at the capture
        only (``CompiledPlan.capture_collectives``); ``layer=i`` takes and
        returns the padded partition layout, as ``run_layer``.

        Under autograd -- grad mode on and a params leaf or ``x`` requiring
        a gradient -- the call is differentiable in them, as ``jax.grad``
        of the reference's jitted forward: on a card the signature gets a
        forward graph that keeps the activations and a backward graph over
        a static output gradient (K1's backward, the halos' adjoints), one
        ``torch.autograd.Function`` replaying each.  With
        ``dynamic=True`` a cuda-tier call then takes each runtime layout
        with its capped transposed layout at a fixed capacity
        (``runtime_layout(..., max_in_deg=, transposed=True)``), which
        K1's backward folds: the graphs' static inputs, copied in at each
        call, their capacity in the signature.

        Cached per (donate, layer, dynamic) on the plan::

            >>> fwd = plan.compile()
            >>> out = fwd(params, x)          # captures once
            >>> out = fwd(params, x)          # replays
            >>> fwd.num_traces, fwd.num_replays
            (1, 1)
        """
        if not self.compile_supported:
            raise ValueError(
                "plan.compile() needs every cuda layer to own its plan-built "
                "blocked layout (build plans through build_plan/plan_for_* "
                "rather than by hand)")
        if not dynamic and self.dedup_pad is not None:
            raise ValueError("a plan built with dedup_pad= serves runtime "
                             "dispatch only: compile(dynamic=True)")
        if dynamic:
            if layer is not None:
                raise ValueError("dynamic compilation covers the full "
                                 "forward; layer= is incompatible")
            self._check_dynamic_ok()
        key = (bool(donate), layer, bool(dynamic))
        fn = self._compiled.get(key)
        if fn is None:
            fn = self._compiled[key] = CompiledPlan(
                self, donate=donate, layer=layer, dynamic=dynamic)
        return fn

    def run_phases(self, x: torch.Tensor, weights, *, layer: int = 0,
                   edge_weight=None, activation: str = "relu",
                   bias_post=None, _probe=None) -> torch.Tensor:
        """Raw weight-list execution (the ``phase_ordered_layer`` entry):
        ``weights`` is a list of (W, b) with biases applied inside the MLP;
        ``bias_post`` is added after aggregation.  Takes and returns the
        natural vertex order; a reordered plan refuses ``edge_weight``,
        which is indexed by the caller's edge order (``run_phases``,
        :433-455)."""
        if self.perm is not None:
            if edge_weight is not None:
                raise ValueError(
                    "edge_weight is indexed by the caller's edge order, "
                    "which a reordered plan re-sorts; use reorder='none'")
            x = self._ingress(x, _probe=_probe)
        h = _execute_layer(self.g, self.layers[layer], x, weights,
                           edge_weight=edge_weight, activation=activation,
                           bias_post=bias_post, probe=_probe,
                           dtype=self.dtype, dedup=self.dedup_layout)
        return self._egress(h)

    def _run_distributed(self, lp: LayerPlan, shards, weights, bias_post, *,
                         probe=None) -> list:
        """One layer over the held shards' slabs (``_run_distributed``,
        :457): the 1-D or 2-D layer of ``core.distributed`` with the plan's
        strategy, schedule and dtype, each shard's sums in K1 over the
        plan's shard layouts."""
        from repro_torch.core import distributed as dist
        (w, b_inline), = weights  # build_plan admits single-matmul layers
        bias = bias_post if bias_post is not None else b_inline
        if bias is None:
            bias = torch.zeros((w.shape[1],), dtype=w.dtype, device=w.device)
        node_ax, feat_ax = self._dist_axes()
        pg = self._node_partition
        rdeg = dist._rdeg(self.g.in_deg, shards[0].dtype,
                          pg.block_size * pg.num_shards)
        rdegs = dist.split_shards(self.mesh, rdeg, pg.block_size,
                                  node_axis=node_ax)
        lays = dist._held_layouts(self.mesh, self.shard_layouts, node_ax)
        tlays = dist._held_layouts(self.mesh, self.shard_transposed(),
                                   node_ax) \
            if dist._grad_wanted(w, bias, *shards) else None
        kw = dict(order=lp.order, strategy=self.strategy,
                  overlap=self.overlap, dtype=self.dtype,
                  backend=lp.backend, tlayouts=tlays)
        if feat_ax is not None:
            thunk = lambda: dist.gcn_layer_2d_shards(  # noqa: E731
                self.mesh, shards, w, bias, rdegs, lays, p2=self.partition,
                axes=self.axes, **kw)
        else:
            thunk = lambda: dist.gcn_layer_shards(  # noqa: E731
                self.mesh, shards, w, bias, rdegs, lays, axis=self.axis,
                **kw)
        # the width the exchange moves under this ordering; the schedule
        # rides along so the probe prices what dispatched; a reduced
        # plan's quantization error is the layer input's
        agg_len = lp.din if lp.order == AGGREGATE_FIRST else lp.dout
        qerr = 0.0
        if probe is not None and self.dtype != "f32":
            qerr = max(_quant_err(s, dist._reduce_wire(s, self.dtype))
                       for s in shards)
        return _phase(probe, "distributed", thunk, lp=lp,
                      feature_len=agg_len, overlap=self.overlap,
                      quant_error=qerr)

    def shard_transposed(self) -> Dict[int, list]:
        """The halos' backward layouts of the held node shards
        (``core.distributed.shard_transposed_layouts``): built on the host
        on first need, then cached with the shard layouts, so no backward
        builds one."""
        node_ax, _ = self._dist_axes()
        nodes = tuple(sorted({self.mesh.index(c, node_ax)
                              for c in self.mesh.coords}))
        return _shard_transposed_for(self.g, self._node_partition, nodes)

    def instrument(self, machine=None, warmup: int = 0):
        """Wrap this plan for characterization (``instrument``, :488).

        Returns a ``profile.instrument.InstrumentedPlan`` whose ``run_*``
        execute this plan's own dispatch while recording per-layer,
        per-phase FLOPs / bytes / wall time into a ``WorkloadReport``.
        ``machine`` is a ``Machine`` or registry name; default the plan's
        (``H100`` unless the plan was built for another)::

            >>> report = plan.instrument().run_model(params, x)
            >>> print(report.to_markdown())    # Table-3/4-style breakdown
        """
        from repro_torch.profile.instrument import InstrumentedPlan
        if machine is not None:
            machine = get_machine(machine)
        return InstrumentedPlan(self, machine=machine, warmup=warmup)

    def describe(self) -> List[Dict]:
        """One dict per layer: every planned decision + modeled agg cost.
        The keys are the reference's: ``dtype``/``reorder``/``dedup``/
        ``overlap`` are the resolved decisions (never "auto"),
        ``distributed``/``partition`` the shard partition, ``interpret``
        is always False, and ``compiled`` whether ``plan.compile()`` works
        (``compile_supported``: always for plans built by the public entry
        points)."""
        out = []
        compiled_ok = self.compile_supported
        for lp in self.layers:
            oc = ordering_cost(self.g, lp.din, lp.dout, lp.order)
            out.append({
                "layer": lp.index, "kind": lp.kind,
                "din": lp.din, "dout": lp.dout,
                "order": lp.order, "backend": lp.backend,
                "fused": lp.fused, "tile_m": lp.tile_m,
                "interpret": False, "distributed": self.distributed,
                "partition": self.partition_kind, "overlap": self.overlap,
                "dtype": self.dtype, "reorder": self.reorder,
                "compiled": compiled_ok, "dedup": self.dedup,
                "agg_bytes": oc.agg_bytes, "agg_flops": oc.agg_flops,
            })
        return out

    def layer_costs(self, layer: int = 0) -> Dict:
        """Analytic per-phase costs of one planned layer (Tables 3/4;
        ``layer_costs``, :548)."""
        lp = self.layers[layer]
        agg_len = lp.din if lp.order == AGGREGATE_FIRST else lp.dout
        return {
            "order": lp.order,
            "aggregation": phases.aggregate_cost(self.g, agg_len),
            "combination": phases.combine_cost(self.g.num_vertices, lp.dims),
            "ordering_cost": ordering_cost(self.g, lp.din, lp.dout, lp.order),
        }


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()):
    """(path, tensor) leaves of a nested params dict, in key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _tree(leaves) -> Dict:
    """The nested dict back from its ``_leaves``."""
    tree: Dict = {}
    for path, t in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


class _Counted:
    """What the kernels' launch counters and a mesh's byte counters
    (``Mesh.collective_bytes``) moved since this object was made: both run
    on the host, so they move while a graph is captured and never when it
    replays."""

    def __init__(self, mesh):
        from repro_torch.kernels.ops import launch_counts
        self.mesh = mesh
        self.launches0 = launch_counts()
        self.bytes0 = None if mesh is None else mesh.collective_bytes()

    def since(self) -> Tuple[Dict[str, int], Dict]:
        from repro_torch.kernels.ops import launch_counts
        launches = {k: n - self.launches0[k]
                    for k, n in launch_counts().items()}
        if self.mesh is None:
            return launches, {}
        now, b = self.mesh.collective_bytes(), self.bytes0
        moved = {k: v - b[k] for k, v in now.items() if k != "counts"}
        moved["counts"] = {k: v - b["counts"][k]
                           for k, v in now["counts"].items()}
        return launches, moved


def _count_sum(a: Dict, b: Dict) -> Dict:
    """``a + b`` of two ``Mesh.collective_bytes()`` dicts (``{}``: zero)."""
    if not a or not b:
        return dict(a or b)
    out = {k: v + b[k] for k, v in a.items() if k != "counts"}
    out["counts"] = {k: v + b["counts"][k] for k, v in a["counts"].items()}
    return out


@contextlib.contextmanager
def capture_graph(graph, pool=None):
    """``torch.cuda.graph(graph, pool=pool)`` with Python's cyclic garbage
    collector paused for the capture.  A dead reference cycle can hold an
    earlier capture's graph (a plan dropped from the cache keeps its
    ``CompiledPlan``, and so its graphs, through plan <-> CompiledPlan);
    if the collector ran mid-capture it would destroy that graph, which a
    capturing stream does not permit, and the capture would be lost.
    The cycle is freed at the collector's next run after the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        if enabled:
            gc.enable()


class _Captured:
    """One input signature's CUDA graphs: static buffers for the params
    leaves and the array arguments, the forward graph and its static
    output, and, when the signature wants a gradient (``wants``: a flag a
    leaf, then an array), the backward graph over a static output
    gradient, whose static results are the wanted inputs' gradients.

    Built by the first call of a signature: the inputs are copied into the
    static buffers, one warm-up forward -- and backward, when a gradient is
    wanted -- runs on a side stream (it builds and loads the kernels, sets
    their attributes, creates the mesh's stream and a process group's
    communicators, and builds the layouts a backward folds on the host,
    none of which may happen under capture), then the forward is captured
    once and the backward once, into the forward graph's memory pool.
    Without a gradient the warm-up's result answers that first call.
    ``launches`` counts each kernel's launches recorded into the graphs,
    ``collectives`` the bytes the plan's mesh counted while they were
    captured (``{}`` without a mesh); a replay moves no counter.
    ``calls`` numbers the grad replays and ``backed`` is the last one
    whose backward ran: the graphs hold one call's activations at a time.
    """

    def __init__(self, fn, leaves, arrays, device: torch.device, *,
                 wants: Optional[Tuple[bool, ...]] = None, mesh=None):
        # plain tensors even when the caller is in inference mode: later
        # calls copy into them from anywhere
        grad = wants is not None
        with torch.inference_mode(False):
            self.leaves = [(p, torch.empty_like(t)) for p, t in leaves]
            self.arrays = [torch.empty_like(a) for a in arrays]
            self.load(leaves, arrays)
            inputs = [t for _, t in self.leaves] + self.arrays
            if grad:
                for t, w in zip(inputs, wants):
                    t.requires_grad_(w)
            wanted = [t for t in inputs if t.requires_grad]
            with torch.set_grad_enabled(grad):
                cur = torch.cuda.current_stream(device)
                side = torch.cuda.Stream(device)
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    first = fn(_tree(self.leaves), *self.arrays)
                    if grad:
                        torch.autograd.grad(first, wanted,
                                            torch.zeros_like(first),
                                            allow_unused=True)
                        first = None
                cur.wait_stream(side)
                if first is not None:
                    first.record_stream(cur)
                self.first = first
                counted = _Counted(mesh)
                self.graph = torch.cuda.CUDAGraph()
                with capture_graph(self.graph):
                    self.out = fn(_tree(self.leaves), *self.arrays)
                self.backward_graph, self.grads = None, ()
                if grad:
                    self.gout = torch.zeros_like(self.out,
                                                 requires_grad=False)
                    self.backward_graph = torch.cuda.CUDAGraph()
                    with capture_graph(self.backward_graph,
                                       pool=self.graph.pool()):
                        gs = iter(torch.autograd.grad(
                            self.out, wanted, self.gout, allow_unused=True))
                    self.grads = tuple(next(gs) if t.requires_grad else None
                                       for t in inputs)
                self.launches, self.collectives = counted.since()
        self.calls = self.backed = 0

    def load(self, leaves, arrays) -> None:
        with torch.no_grad():
            for (_, dst), (_, src) in zip(self.leaves, leaves):
                dst.copy_(src)
            for dst, src in zip(self.arrays, arrays):
                dst.copy_(src)


class _Replay(torch.autograd.Function):
    """A grad capture's replay, ``(cap, donate, *leaves, *arrays) ->
    logits``, differentiable in the caller's tensors: the forward copies
    them in and replays the forward graph; the backward copies the output
    gradient in, replays the backward graph and returns clones of the
    static gradients.  The graphs hold the activations of the signature's
    latest call only, so the backward of an older call, or a second
    backward of one call, raises instead of reading another call's
    buffers."""

    @staticmethod
    def forward(ctx, cap, donate, *inputs):
        n = len(cap.leaves)
        cap.load([(None, t) for t in inputs[:n]], inputs[n:])
        cap.graph.replay()
        cap.calls += 1
        ctx.cap, ctx.call = cap, cap.calls
        out = cap.out.detach()
        return out if donate else out.clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        cap = ctx.cap
        if ctx.call != cap.calls:
            raise RuntimeError(
                "backward of a compiled call after a newer call of the same "
                "signature: the graphs now hold the newer call's "
                "activations; take each call's backward before the next "
                "call")
        if cap.backed == ctx.call:
            raise RuntimeError("a second backward of one compiled call: its "
                               "graph's buffers are single-use")
        cap.backed = ctx.call
        cap.gout.copy_(gout)
        cap.backward_graph.replay()
        return (None, None) + tuple(None if g is None else g.clone()
                                    for g in cap.grads)


class CompiledPlan:
    """A plan's forward as one callable, with a retrace guard
    (``CompiledPlan``, :560).

    The first call per input signature -- shapes and dtypes of ``x``, of
    the params leaves and, in dynamic mode, of ``src``/``dst``/``in_deg``,
    the dedup arrays and, on the cuda tier, the runtime layouts (under
    autograd with their transposed layouts, whose capacity -- rows and
    scratch rows -- joins it), and which of them want a gradient --
    traces: on a card it captures a CUDA graph
    (``_Captured``; under autograd a forward and a backward graph), on the
    CPU it runs the eager forward.  Later calls of that signature replay:
    on a card they copy the inputs into the static buffers (so new
    parameter values take effect, as with ``jax.jit``), replay the graph
    and clone its output (``donate=True``: no clone, see
    ``plan.compile``); on the CPU they run the eager forward again, under
    autograd when a gradient is wanted.  ``num_traces`` counts traces,
    ``num_replays`` the calls served by an existing trace; a trace for a
    signature already traced raises ``RuntimeError``.  Under autograd on a
    card each call's result is an ``autograd.Function``'s (``_Replay``),
    whose backward replays the backward graph once, before the
    signature's next call.

    The graph binds the plan's layouts and the static buffers by address,
    so it lives as long as this object (cached on the plan).  A capture or
    replay that fails raises; nothing falls back to eager execution.
    """

    def __init__(self, plan: GraphExecutionPlan, *, donate: bool = False,
                 layer: Optional[int] = None, dynamic: bool = False):
        self.plan = plan
        self.donate = donate
        self.layer = layer
        self.dynamic = dynamic
        self._num_traces = 0
        self._num_replays = 0
        self._seen = set()
        #: signature -> _Captured on a card, None on the CPU
        self._traces: Dict = {}

    @property
    def num_traces(self) -> int:
        """Captures (CPU: first calls) made so far."""
        return self._num_traces

    @property
    def num_replays(self) -> int:
        """Calls served by a capture made earlier."""
        return self._num_replays

    @property
    def capture_launches(self) -> Dict[str, int]:
        """Kernel launches recorded into the graphs, summed over
        signatures (``{}`` on the CPU)."""
        out: Dict[str, int] = {}
        for c in self._traces.values():
            for k, n in (c.launches if c is not None else {}).items():
                out[k] = out.get(k, 0) + n
        return out

    @property
    def capture_collectives(self) -> Dict:
        """The bytes the plan's mesh counted while the graphs were
        captured, summed over signatures, in ``Mesh.collective_bytes()``'s
        form: what each replay moves (``{}`` on the CPU and for a local
        plan)."""
        out: Dict = {}
        for c in self._traces.values():
            if c is not None:
                out = _count_sum(out, c.collectives)
        return out

    @property
    def _on_cuda_tier(self) -> bool:
        return self.plan.agg_tile > 0

    def _layout(self, arrays, meta) -> BlockedGraph:
        """A runtime layout from its static buffers: (src, dstl, mask), and
        with ``meta`` -- (rows, scratch rows) of its transposed layout --
        the transposed layout's (src, dstl, mask, eidx, out_rows) and its
        fold-back's (src, dstl, mask, out_rows) after them."""
        tile = self.plan.agg_tile
        bg = BlockedGraph(*arrays[:3], tile, self.plan.g.num_vertices)
        if meta is None:
            return bg
        rows, scratch = meta
        fold = BlockedGraph(*arrays[8:11], tile, scratch,
                            out_rows=arrays[11])
        return bg._replace(transposed=BlockedGraph(
            *arrays[3:6], tile, rows, eidx=arrays[6], out_rows=arrays[7],
            fold=fold))

    def _forward(self, params, x, *graph_arrays, meta=(None, None)):
        """The forward over static buffers: ``graph_arrays`` in dynamic
        mode (``_graph_args`` then ``_dedup_args``), their layouts rebuilt
        with ``meta`` (the two layouts' ``_layout_args`` meta)."""
        if graph_arrays:
            src, dst, in_deg = graph_arrays[:3]
            g = self.plan.g._replace(src=src, dst=dst, in_deg=in_deg,
                                     row_ptr=None)
            rest, glay, lay = graph_arrays[3:], None, None
            if self._on_cuda_tier:
                n = 3 if meta[0] is None else 12
                glay, rest = self._layout(rest[:n], meta[0]), rest[n:]
            if rest:
                pl, pr, s2, d2 = rest[:4]
                lay = self.plan.dedup_layout._replace(
                    pair_left=pl, pair_right=pr, src2=s2, dst2=d2,
                    blocked=self._layout(rest[4:], meta[1])
                    if rest[4:] else None)
            return self.plan.run_model(params, x, graph=g,
                                       graph_layout=glay, dedup_layout=lay)
        if self.layer is None:
            return self.plan.run_model(params, x)
        return self.plan.run_layer(params, x, layer=self.layer)

    @staticmethod
    def _signature(leaves, arrays):
        return (tuple((tuple(a.shape), a.dtype, a.device) for a in arrays),
                tuple(p for p, _ in leaves),
                tuple((tuple(t.shape), t.dtype) for _, t in leaves))

    def _layout_args(self, lay, what: str, grad: bool):
        """A runtime layout's arrays, checked against the plan's tile, and
        the meta ``_layout`` rebuilds it with: under autograd (``grad``)
        with its transposed layout's at a fixed capacity, else None."""
        if lay is None:
            raise ValueError(f"a cuda-tier dynamic plan takes the {what}'s "
                             f"blocked layout (plan.runtime_layout(..., "
                             f"max_in_deg=))")
        if (lay.tile_m, lay.num_vertices) != (self.plan.agg_tile,
                                               self.plan.g.num_vertices):
            raise ValueError(
                f"the {what}'s layout has tile {lay.tile_m} over "
                f"{lay.num_vertices} rows; the plan's is {self.plan.agg_tile}"
                f" over {self.plan.g.num_vertices}")
        arrays = (lay.src, lay.dstl, lay.mask)
        if not grad:
            return arrays, None
        t = lay.transposed
        if t is None or t.out_rows is None or t.fold is None:
            raise ValueError(
                f"a cuda-tier dynamic plan under autograd takes the {what}'s "
                f"layout with its capped transposed layout at a fixed "
                f"capacity, which K1's backward folds "
                f"(plan.runtime_layout(..., max_in_deg=, transposed=True))")
        f = t.fold
        return arrays + (t.src, t.dstl, t.mask, t.eidx, t.out_rows, f.src,
                         f.dstl, f.mask, f.out_rows), \
            (t.num_vertices, f.num_vertices)

    def _graph_args(self, graph: Graph, layout, grad: bool):
        """Validate a runtime graph (and, on the cuda tier, its blocked
        ``layout``) for the dynamic mode: a shape mismatch raises here,
        never silently absorbed by a recapture.  Returns its arrays and
        the layout's meta (``_layout_args``)."""
        t = self.plan.g
        if graph.num_vertices != t.num_vertices or \
                graph.src.shape != t.src.shape or \
                graph.in_deg.shape != t.in_deg.shape:
            raise ValueError(
                f"dynamic graph shape {graph.num_vertices}V/"
                f"{graph.src.shape[0]}E does not match the bucket template "
                f"{t.num_vertices}V/{t.src.shape[0]}E -- pad the block "
                "into the bucket before dispatch")
        if graph.device != t.device:
            raise ValueError(f"dynamic graph on {graph.device}, plan on "
                             f"{t.device}")
        arrays, meta = (graph.src, graph.dst, graph.in_deg), None
        if self._on_cuda_tier:
            lay, meta = self._layout_args(layout, "graph", grad)
            arrays += lay
        return arrays, meta

    def _dedup_args(self, dedup, grad: bool):
        """Validate runtime dedup arrays (a ``DedupLayout`` or its
        ``(pair_left, pair_right, src2, dst2)``) padded to the plan's
        ``dedup_pad`` (``_dedup_args``, :636); on the cuda tier the layout
        also brings its level-2 ``blocked`` layout (under autograd with
        its transposed layout).  Returns the arrays and the meta."""
        t = self.plan.dedup_layout
        blocked = getattr(dedup, "blocked", None)
        if hasattr(dedup, "pair_left"):
            dedup = (dedup.pair_left, dedup.pair_right, dedup.src2,
                     dedup.dst2)
        pl, pr, s2, d2 = dedup
        if pl.shape[0] != t.num_pairs or s2.shape[0] != t.num_edges2:
            raise ValueError(
                f"dynamic dedup shapes {pl.shape[0]}P/{s2.shape[0]}E2 do "
                f"not match the bucket template {t.num_pairs}P/"
                f"{t.num_edges2}E2 -- pad via graph.dedup.pad_dedup_arrays")
        arrays, meta = (pl, pr, s2, d2), None
        if self._on_cuda_tier:
            lay, meta = self._layout_args(blocked, "dedup layout", grad)
            arrays += lay
        return arrays, meta

    def __call__(self, params, x, graph: Optional[Graph] = None,
                 dedup=None, layout: Optional[BlockedGraph] = None):
        leaves = _leaves(params)
        meta = (None, None)
        if self.dynamic:
            if graph is None:
                raise ValueError("dynamic compiled plans take (params, x, "
                                 "graph)")
            grad = _grad_wanted(leaves, (x,)) is not None
            more, gmeta = self._graph_args(graph, layout, grad)
            arrays, dmeta = (x,) + more, None
            if self.plan.dedup == "pairs":
                if dedup is None:
                    raise ValueError(
                        "this dynamic plan was compiled with dedup='pairs'; "
                        "pass the block's padded dedup layout (dedup=)")
                more, dmeta = self._dedup_args(dedup, grad)
                arrays += more
            elif dedup is not None:
                raise ValueError("dedup arrays passed to a dedup='none' "
                                 "compiled plan")
            meta = (gmeta, dmeta)
        else:
            if graph is not None:
                raise ValueError("this compiled plan is static; build it "
                                 "with plan.compile(dynamic=True) to pass "
                                 "a runtime graph")
            arrays = (x,)
        wants = _grad_wanted(leaves, arrays)
        sig = self._signature(leaves, arrays) + (wants, meta)
        if sig in self._traces:
            self._num_replays += 1
            return self._run(self._traces[sig], params, leaves, arrays,
                             wants, meta)
        self._num_traces += 1
        if sig in self._seen:
            raise RuntimeError(
                "plan.compile() retraced for an input signature it already "
                "captured -- something dropped the capture cache")
        cap = None
        if self.plan.device.type == "cuda":
            cap = _Captured(functools.partial(self._forward, meta=meta),
                            leaves, arrays, self.plan.device, wants=wants,
                            mesh=self.plan.mesh)
        self._traces[sig] = cap
        self._seen.add(sig)
        if cap is not None and wants is None:
            out, cap.first = cap.first, None
            return out
        return self._run(cap, params, leaves, arrays, wants, meta)

    def _run(self, cap, params, leaves, arrays, wants, meta):
        """One call served by the signature's trace: the eager forward on
        the CPU (under autograd when a gradient is wanted), else a
        replay."""
        if cap is None:
            with torch.set_grad_enabled(wants is not None):
                return self._forward(params, *arrays, meta=meta)
        if wants is not None:
            return _Replay.apply(cap, self.donate,
                                 *[t for _, t in leaves], *arrays)
        cap.load(leaves, arrays)
        cap.graph.replay()
        return cap.out if self.donate else cap.out.clone()


def _grad_wanted(leaves, arrays) -> Optional[Tuple[bool, ...]]:
    """Which inputs (params leaves, then arrays) want a gradient, or None
    when none does (grad mode off, or nothing requires one)."""
    if not torch.is_grad_enabled():
        return None
    flags = tuple(t.requires_grad for _, t in leaves) + \
        tuple(a.requires_grad for a in arrays)
    return flags if any(flags) else None


# ---------------------------------------------------------------------------
# Layer execution core (the ONE place ordering x backend x fusion composes)
# ---------------------------------------------------------------------------


def _fused_agg_op(lp: LayerPlan) -> Optional[str]:
    """Map a layer's aggregation onto fused_gcn_layer's modes (:690)."""
    if lp.agg_op == "mean":
        return "mean" if lp.include_self else None
    if lp.agg_op == "sum":
        return "sum_self" if lp.include_self else "sum"
    return None  # max: non-linear, cannot fuse


def _can_fuse(lp: LayerPlan, weights, edge_weight) -> bool:
    """Fusion applies (:699-708) unless there is an edge weight, the
    aggregation is not linear, or an inline bias would not commute with
    the reduction."""
    if not (lp.fused and lp.blocked is not None and edge_weight is None):
        return False
    if _fused_agg_op(lp) is None:
        return False
    b0 = weights[0][1]
    return b0 is None or lp.order == AGGREGATE_FIRST or lp.agg_op == "mean"


def _phase(probe, name: str, thunk, *, lp: LayerPlan, **meta):
    """Run one phase, observed by an instrumentation probe when one is set
    (``_phase``, :711).  ``probe`` is ``profile.instrument._Probe``; with
    None (production) the thunk runs directly, so reports describe the
    dispatch path that actually ran."""
    if probe is None:
        return thunk()
    return probe.run(name, thunk, lp=lp, **meta)


def _round(h: torch.Tensor, dtype: str) -> torch.Tensor:
    """A phase output back to the plan dtype's storage (``_round``, :725):
    bf16 for "bf16", unchanged for "f32" and "int8-agg"."""
    return h.to(torch.bfloat16) if dtype == "bf16" else h


def _quant_err(orig: torch.Tensor, reduced: torch.Tensor) -> float:
    """Largest absolute error a precision reduction introduced
    (``_quant_err``, :739).  Reads the result on the host, so only the
    instrumentation probe calls it."""
    return float((orig.float() - reduced.float()).abs().max().item())


def _dedup_fused_inputs(dedup, xa: torch.Tensor) -> torch.Tensor:
    """The (V + P)-row gather source of a fused dedup layer
    (``_dedup_fused_inputs``, :748): the features cast to f32 (exact), each
    matched pair's partial added once, stacked under them."""
    xf = xa if xa.dtype == torch.float32 else xa.float()
    partials = xf[dedup.pair_left.long()] + xf[dedup.pair_right.long()]
    return torch.cat([xf, partials], dim=0)


def _execute_layer(g: Graph, lp: LayerPlan, x: torch.Tensor, weights, *,
                   edge_weight=None, activation: str = "relu",
                   bias_post=None, probe=None, dtype: str = "f32",
                   dedup=None, layout=None) -> torch.Tensor:
    """Execute one layer per its plan: fusion > ordering > backend
    (``_execute_layer``, :762-878).  Each phase goes through ``_phase``
    where the reference records one.

    ``dtype`` is the plan's resolved precision.  "f32" takes the plain
    path: every cast below is guarded, so f32 plans are unchanged.  "bf16"
    casts x, the weights and biases once at entry and rounds each phase
    output back to bf16; the phases accumulate in f32.  "int8-agg"
    fake-quantizes only the aggregation operand; the combination stays f32.
    ``dedup`` (a ``graph.dedup.DedupLayout`` or None) goes to
    ``phases.aggregate`` on the unfused paths; a fused layer swaps its
    blocked layout for the layout's level-2 blocking and gathers from
    ``[x ; partials]``.  ``layout`` replaces ``lp.agg_layout`` (a runtime
    graph's, on the cuda tier).
    """
    agg_layout = lp.agg_layout if layout is None else layout
    entry_err = 0.0
    if dtype == "bf16":
        xr = x.to(torch.bfloat16)
        if probe is not None:
            entry_err = _quant_err(x, xr)
        x = xr
        weights = [(w.to(torch.bfloat16),
                    None if b is None else b.to(torch.bfloat16))
                   for (w, b) in weights]
        if bias_post is not None:
            bias_post = bias_post.to(torch.bfloat16)
    mlp_dims = tuple([int(w.shape[0]) for (w, _) in weights] +
                     [int(weights[-1][0].shape[1])])
    if _can_fuse(lp, weights, edge_weight):
        w0, b0 = weights[0]
        fused_dims = (int(w0.shape[0]), int(w0.shape[1]))
        xa, agg_err = x, entry_err
        if dtype == "int8-agg":
            xa = phases.quantize_int8(x)
            if probe is not None:
                agg_err = _quant_err(x, xa)
        fbg, fx = lp.blocked, xa
        if dedup is not None and dedup.num_pairs > 0 \
                and dedup.blocked is not None:
            fbg, fx = dedup.blocked, _dedup_fused_inputs(dedup, xa)
        if len(weights) == 1:
            # whole layer fused; an inline b0 is exact post-aggregation
            # here (what _can_fuse admitted), so fold it into the bias
            bias = b0 if bias_post is None else (
                bias_post if b0 is None else b0 + bias_post)
            h = _phase(
                probe, "fused_agg_combine",
                lambda: fused_gcn_layer(fbg, fx, w0, bias,
                                        agg_op=_fused_agg_op(lp),
                                        in_deg=g.in_deg, backend=lp.backend),
                lp=lp, dims=fused_dims, quant_error=agg_err)
            return _round(h, dtype)
        # multi-layer MLP (GIN): fuse aggregation with the FIRST matmul --
        # exact because the aggregation is linear and the interior
        # nonlinearity only applies after that matmul
        h = _phase(
            probe, "fused_agg_combine",
            lambda: fused_gcn_layer(fbg, fx, w0, b0,
                                    agg_op=_fused_agg_op(lp),
                                    in_deg=g.in_deg, backend=lp.backend),
            lp=lp, dims=fused_dims, quant_error=agg_err)
        h = _round(phases._act(activation)(h), dtype)
        h = _phase(probe, "combine",
                   lambda hh=h: phases.combine(hh, weights[1:],
                                               activation=activation),
                   lp=lp, dims=mlp_dims[1:])
        h = _round(h, dtype)
    elif lp.order == COMBINE_FIRST:
        h = _phase(probe, "combine",
                   lambda: phases.combine(x, weights, activation=activation),
                   lp=lp, dims=mlp_dims, quant_error=entry_err)
        h = _round(h, dtype)
        ha, agg_err = h, 0.0
        if dtype == "int8-agg":
            ha = phases.quantize_int8(h)
            if probe is not None:
                agg_err = _quant_err(h, ha)
        h = _phase(probe, "aggregate",
                   lambda hh=ha: phases.aggregate(
                       g, hh, op=lp.agg_op, edge_weight=edge_weight,
                       include_self=lp.include_self, backend=lp.backend,
                       layout=agg_layout, dedup=dedup),
                   lp=lp, feature_len=int(h.shape[-1]), quant_error=agg_err)
        h = _round(h, dtype)
    else:
        xa, agg_err = x, entry_err
        if dtype == "int8-agg":
            xa = phases.quantize_int8(x)
            if probe is not None:
                agg_err = _quant_err(x, xa)
        h = _phase(probe, "aggregate",
                   lambda: phases.aggregate(
                       g, xa, op=lp.agg_op, edge_weight=edge_weight,
                       include_self=lp.include_self, backend=lp.backend,
                       layout=agg_layout, dedup=dedup),
                   lp=lp, feature_len=int(x.shape[-1]), quant_error=agg_err)
        h = _round(h, dtype)
        h = _phase(probe, "combine",
                   lambda hh=h: phases.combine(hh, weights,
                                               activation=activation),
                   lp=lp, dims=mlp_dims)
        h = _round(h, dtype)
    if bias_post is not None:
        h = h + bias_post
    return h


# ---------------------------------------------------------------------------
# Plan construction + caching
# ---------------------------------------------------------------------------

_PLAN_CACHE: Dict = {}      # (graph_key, spec_key) -> (src_ref, plan)
_BLOCKED_CACHE: Dict = {}   # (graph_key, tile_m)   -> (src_ref, BlockedGraph)
_REORDER_CACHE: Dict = {}   # graph_key -> (src_ref, reordered Graph, perm)
#: (graph_key, shards, strategy, held nodes, device) -> (src_ref, layouts);
#: (graph_key, shards, "transposed", held nodes, device, cap) -> (src_ref,
#: the halos' backward layouts)
_SHARD_CACHE: Dict = {}
_CACHE_LIMIT = 64

#: hits/misses count ``_cached_plan`` lookups; evictions count entries
#: dropped by FIFO aging or by ``clear_plan_cache(keep=...)``
_PLAN_CACHE_STATS: Dict[str, int] = {"hits": 0, "misses": 0, "evictions": 0}


def plan_cache_stats() -> Dict[str, int]:
    """``{size, limit, blocked_size, reorder_size, hits, misses,
    evictions}``.  The graph serving engine polls ``size`` to decide when
    to sweep its transient per-request plans."""
    return {"size": len(_PLAN_CACHE), "limit": _CACHE_LIMIT,
            "blocked_size": len(_BLOCKED_CACHE),
            "reorder_size": len(_REORDER_CACHE), **_PLAN_CACHE_STATS}


def clear_plan_cache(keep=None) -> int:
    """Drop cached plans and their blocked layouts, shard layouts and
    reordered graphs (``clear_plan_cache``, :917).  Returns the number of
    plans dropped.

    ``keep=None`` drops everything and resets the counters.
    ``keep=<plans>`` is the serving engine's sweep: every cached plan not
    in ``keep`` goes, while the kept plans -- and so the CUDA graphs they
    hold -- and the blocked layouts and reordered graphs of their graphs
    stay.  Each dropped line counts as an eviction, plans and layouts
    alike, and the hit and miss counters go on accumulating."""
    if keep is None:
        n = len(_PLAN_CACHE)
        _PLAN_CACHE.clear()
        _BLOCKED_CACHE.clear()
        _REORDER_CACHE.clear()
        _SHARD_CACHE.clear()
        _PLAN_CACHE_STATS.update(hits=0, misses=0, evictions=0)
        return n
    keep_ids = {id(p) for p in keep}
    # a kept plan's graphs: the one it was cached under and the one it
    # runs over (its degree-reordered twin on a reordered plan)
    keep_graphs = {k[0] for k, (_, p) in _PLAN_CACHE.items()
                   if id(p) in keep_ids} | {_graph_key(p.g) for p in keep}
    drop = [k for k, (_, p) in _PLAN_CACHE.items() if id(p) not in keep_ids]
    blocked = [k for k in _BLOCKED_CACHE if k[0] not in keep_graphs]
    reorder = [k for k in _REORDER_CACHE if k not in keep_graphs]
    shards = [k for k in _SHARD_CACHE if k[0] not in keep_graphs]
    for cache, keys in ((_PLAN_CACHE, drop), (_BLOCKED_CACHE, blocked),
                        (_REORDER_CACHE, reorder), (_SHARD_CACHE, shards)):
        for k in keys:
            del cache[k]
    _PLAN_CACHE_STATS["evictions"] += len(drop) + len(blocked) + \
        len(reorder) + len(shards)
    return len(drop)


def _graph_key(g: Graph):
    """Cache key of a graph: the identity of its ``src`` tensor plus its
    sizes.  Lookups also check ``cached_src is g.src``, because an id can
    be reused once the tensor it named is freed."""
    return (id(g.src), int(g.num_vertices), int(g.src.shape[0]))


def _evict_oldest(cache: Dict) -> None:
    """FIFO eviction: transient graphs age out one at a time."""
    while len(cache) >= _CACHE_LIMIT:
        cache.pop(next(iter(cache)))
        _PLAN_CACHE_STATS["evictions"] += 1


def _blocked_for(g: Graph, tile_m: int) -> BlockedGraph:
    """Build (or reuse) the BlockedGraph for (graph, tile_m): the O(E) host
    regroup runs once per graph and tile."""
    key = (_graph_key(g), tile_m)
    hit = _BLOCKED_CACHE.get(key)
    if hit is not None and hit[0] is g.src:
        return hit[1]
    _evict_oldest(_BLOCKED_CACHE)
    bg = block_graph(g, tile_m)
    _BLOCKED_CACHE[key] = (g.src, bg)
    return bg


def _shard_layouts_for(g: Graph, pg, strategy: str, nodes: Tuple[int, ...]):
    """K1's layouts of the node shards ``nodes`` of ``g``'s uniform
    partition ``pg`` (``core.distributed.shard_layouts``), built once per
    graph, shard count, strategy and device: every plan of the graph that
    shares them (the ring's schedules, its dtypes) reuses them."""
    from repro_torch.core.distributed import shard_layouts
    key = (_graph_key(g), pg.num_shards, strategy, nodes, str(g.device))
    hit = _SHARD_CACHE.get(key)
    if hit is not None and hit[0] is g.src:
        return hit[1]
    _evict_oldest(_SHARD_CACHE)
    lays = shard_layouts(pg, strategy, nodes=nodes, device=g.device)
    _SHARD_CACHE[key] = (g.src, lays)
    return lays


def _shard_transposed_for(g: Graph, pg, nodes: Tuple[int, ...]):
    """The capped transposed shard sub-layouts of owners ``nodes``
    (``core.distributed.shard_transposed_layouts``), built once per graph,
    shard count and device, beside the shard layouts in ``_SHARD_CACHE``:
    both strategies' backwards fold the same ones."""
    from repro_torch.core.distributed import (TRANSPOSE_CAP,
                                              shard_transposed_layouts)
    key = (_graph_key(g), pg.num_shards, "transposed", nodes,
           str(g.device), TRANSPOSE_CAP)
    hit = _SHARD_CACHE.get(key)
    if hit is not None and hit[0] is g.src:
        return hit[1]
    _evict_oldest(_SHARD_CACHE)
    lays = shard_transposed_layouts(pg, nodes=nodes, device=g.device)
    _SHARD_CACHE[key] = (g.src, lays)
    return lays


def _reordered_for(g: Graph):
    """The degree-reordered twin of ``g`` and its perm, cached per graph
    (``_reordered_for``, :992): every plan of the graph shares one
    renumbering, and so one blocked layout per tile."""
    key = _graph_key(g)
    hit = _REORDER_CACHE.get(key)
    if hit is not None and hit[0] is g.src:
        return hit[1], hit[2]
    from repro_torch.graph.reorder import degree_reorder
    _evict_oldest(_REORDER_CACHE)
    g2, perm = degree_reorder(g)
    _REORDER_CACHE[key] = (g.src, g2, perm)
    return g2, perm


def _cached_plan(g: Graph, spec_key, builder):
    key = (_graph_key(g), spec_key)
    hit = _PLAN_CACHE.get(key)
    if hit is not None and hit[0] is g.src:
        _PLAN_CACHE_STATS["hits"] += 1
        return hit[1]
    _PLAN_CACHE_STATS["misses"] += 1
    _evict_oldest(_PLAN_CACHE)
    plan = builder()
    _PLAN_CACHE[key] = (g.src, plan)
    return plan


def _plan_layer(g: Graph, index: int, kind: str, dims: Tuple[int, ...], *,
                agg_op: str, ordering: str, backend: str, fused: bool,
                include_self: bool = True, machine=None,
                dtype: str = "f32", local: bool = True) -> LayerPlan:
    """Resolve one layer's ordering / tier / fusion (``_plan_layer``,
    :1021), priced on ``machine`` (default ``H100``).  The fused tile is
    sized at the width the gathered rows are stored in: 2 bytes for a
    resolved "bf16", else 4 (int8-agg carries its operand as f32).

    Plans only: a ``cuda`` layer may be planned over a graph on the CPU
    (nothing launches here); running it there raises.  A layer of a
    distributed plan (``local=False``) aggregates over the plan's shard
    layouts and owns no layout of its own.
    """
    machine = get_machine(machine)
    semantic = AGGREGATE_FIRST if len(dims) > 2 else COMBINE_FIRST
    if ordering in (COMBINE_FIRST, AGGREGATE_FIRST):
        order = ordering if len(dims) <= 2 else AGGREGATE_FIRST  # GIN pinned
    else:
        order = choose_ordering(g, dims[0], dims[-1], agg_op=agg_op,
                                n_mlp_layers=len(dims) - 1,
                                semantic_order=semantic, machine=machine)
    backend = resolve_backend(backend, g.device)
    fused = bool(fused) and agg_op in ("sum", "mean")
    tile_m, blocked = 0, None
    align = 32 if backend == CUDA else 8
    if fused:
        avg_deg = g.num_edges / max(1, g.num_vertices)
        tile_m = suggest_tile_m(dims[0], dims[1], avg_deg,
                                dtype_bytes=2 if dtype == "bf16" else 4,
                                machine=machine)
        # a tile larger than the graph only pads: clamp to |V| rounded up,
        # keeping the tier's alignment (warp rows on cuda)
        tile_m = max(align, min(tile_m, -(-g.num_vertices // align) * align))
        blocked = _blocked_for(g, tile_m)
    agg_layout = None
    if backend == CUDA and local:
        atile = max(align, min(128, -(-g.num_vertices // align) * align))
        agg_layout = _blocked_for(g, atile)
    return LayerPlan(index=index, kind=kind, dims=tuple(int(d) for d in dims),
                     agg_op=agg_op, include_self=include_self, order=order,
                     backend=backend, fused=fused, tile_m=tile_m,
                     blocked=blocked, agg_layout=agg_layout)


def _check_graph_device(g: Graph, device) -> torch.device:
    dev = resolve_device(device)
    if g.device != dev:
        raise ValueError(f"the graph lives on {g.device} but the plan runs "
                         f"on {dev}; move it with g.to({str(dev)!r})")
    return dev


def _mesh_key(mesh):
    """Cache key of a mesh: its identity plus its axis names and shape, so
    an address reused by another mesh never aliases a cached plan
    (``_mesh_key``, :1083)."""
    from repro_torch.core.distributed import Mesh
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a core.distributed LocalMesh or "
                        f"ProcessGroupMesh; got {type(mesh).__name__}")
    return (id(mesh), tuple(mesh.axis_names), tuple(mesh.shape.values()))


def _mesh_partition(g: Graph, mesh, num_shards: int, axis: str, dev):
    """(partition, axes) of a mesh plan: two named axes give the 2-D
    partition over (node, feature), one the uniform 1-D partition of
    ``num_shards`` (default the axis's size) blocks."""
    from repro_torch.graph.partition import partition_1d, partition_2d
    if mesh.device != dev:
        raise ValueError(f"the mesh computes on {mesh.device} but the plan "
                         f"runs on {dev}")
    names = mesh.axis_names
    if len(names) == 2:
        return (partition_2d(g, mesh.shape[names[0]], mesh.shape[names[1]],
                             device=dev), names)
    if len(names) != 1:
        raise ValueError(f"a mesh plan takes one axis (1-D) or two (node, "
                         f"feature); got {names}")
    size = mesh.axis_size(axis)
    shards = num_shards or size
    if shards != size:
        raise ValueError(f"num_shards={num_shards} on a mesh axis {axis!r} "
                         f"of {size} shards")
    return partition_1d(g, shards, edge_balanced=False, device=dev), \
        ("node", "feat")


def build_plan(g: Graph, cfg, in_dim: int, num_classes: int, *,
               backend: str = AUTO, fused: Optional[bool] = None,
               ordering: Optional[str] = None, machine=None,
               device="cuda", mesh=None, num_shards: int = 0,
               strategy: str = "ring", axis: str = "data",
               overlap: str = "none", reorder: str = "none",
               dtype: str = "f32", dedup: str = "none",
               dedup_pad: Optional[tuple] = None) -> GraphExecutionPlan:
    """Plan a full model (``GCNModelConfig``) over one graph
    (``build_plan``, :1092).

    ``device`` is where the plan runs (default ``"cuda"``, which raises
    without a card); the graph must already live there.  ``backend``
    "auto" resolves to ``cuda`` on a CUDA device and ``torch`` on the CPU;
    "cuda" on the CPU raises.  ``fused`` / ``ordering`` default from
    ``cfg``; ``machine`` (a ``Machine`` or registry name, default
    ``H100``) prices the ordering, the fused tile and every "auto" below.
    Plans are cached per (graph, arguments).

    The three planned decisions, each resolved once here (reorder first,
    then the dtype -- priced before the layers, whose fused tiles depend on
    it -- then dedup) and reported by ``describe()``:

      * ``reorder``: "none"; "degree" (``graph.reorder.degree_reorder``,
        applied once and cached per graph; the forward permutes x at
        ingress and the logits back at egress); "auto"
        (``choose_reorder``: the gather stream's LRU hit ratio at the
        machine's on-chip rows of ``in_dim`` floats).
      * ``dtype``: "f32"; "bf16" (bf16 storage at phase boundaries, f32
        accumulation); "int8-agg" (the aggregation operand fake-quantized
        per row, the combination in f32; never chosen by "auto"); "auto"
        (``choose_dtype`` on the widest layer).
      * ``dedup``: "none"; "pairs" (``graph.dedup.dedup_layout_for_graph``
        matched once: two-level aggregation, equal to the naive fold bit
        for bit in f32 wherever the fold runs in order); "auto"
        (``choose_dedup`` on the widest layer).  Max aggregation and a
        graph with no matched pair resolve to "none".
        ``dedup_pad=(num_pairs, num_edges2)`` is the bucket form: the
        template's layout padded to those static capacities with sink
        no-ops on the last vertex row (``graph.dedup.pad_dedup_arrays``),
        so one ``compile(dynamic=True)`` callable, or one eager bucket
        dispatch, takes any block's runtime dedup arrays padded the same
        way.  ``num_edges2`` is normally the bucket's edge capacity and
        ``num_pairs`` its ``num_edges // 4`` (a kept pair needs two
        matched destinations of two edges each).  Only with dedup
        "pairs" or "auto".  Such a plan serves runtime dispatch only:
        its own padded layout would add the sink edges' copies into the
        last row, so a forward without ``graph=`` and ``dedup_layout=``
        raises, and it has no level-2 blocking of its own (each
        dispatch brings one on the cuda tier).

    ``mesh`` (a ``core.distributed.LocalMesh`` or ``ProcessGroupMesh``
    computing on ``device``) plans distributed execution; the partition is
    built from the mesh shape (``build_plan``, :1209-1220):

      * one named axis: the uniform 1-D vertex partition
        (``partition_1d(..., edge_balanced=False)``) of ``num_shards``
        blocks (default, and at most, the size of the mesh axis ``axis``);
      * two named axes (node, feature), e.g. ``LocalMesh((4, 2), ("node",
        "feat"))``: the 2-D partition (``partition_2d``); ``num_shards``
        and ``axis`` are not used.

    ``strategy`` ("ring" | "allgather") picks the node-axis halo;
    ``overlap`` the ring's schedule: "none" (single-buffered), "pipelined"
    (each hop's send in flight under its partial combine; bit for bit
    equal, ring only) or "auto" (``core.distributed.choose_overlap`` on
    the layers' exchanged widths, priced on ``machine``); a local plan
    resolves it to "none".  As in the reference, a mesh plan runs its
    layers unfused (``fused`` is coerced to False) with dedup "none", on
    single-matmul convs only (GIN raises); reorder and every dtype apply.
    Its layers run each shard's sums through K1 on the cuda tier (its
    plain version on the torch tier) over layouts built once here
    (``core.distributed.shard_layouts``).  Its forward is differentiable
    and compiles, under autograd too (``compile``).

    Example (CPU)::

        >>> spec = reduced_graph(CORA, 220, 24)
        >>> g = make_synthetic_graph(spec, device="cpu")
        >>> plan = build_plan(g, PAPER_MODELS["gcn"], spec.feature_len,
        ...                   spec.num_classes, device="cpu", dtype="bf16")
        >>> plan.describe()[0]["backend"], plan.describe()[0]["dtype"]
        ('torch', 'bf16')
    """
    if reorder not in ("none", "degree", "auto"):
        raise ValueError(f"unknown reorder {reorder!r}; expected "
                         "'none' | 'degree' | 'auto'")
    if dtype not in ("f32", "bf16", "int8-agg", "auto"):
        raise ValueError(f"unknown dtype {dtype!r}; expected "
                         "'f32' | 'bf16' | 'int8-agg' | 'auto'")
    if dedup not in ("none", "pairs", "auto"):
        raise ValueError(f"unknown dedup {dedup!r}; expected "
                         "'none' | 'pairs' | 'auto'")
    if overlap not in ("none", "pipelined", "auto"):
        raise ValueError(f"unknown overlap {overlap!r}; expected "
                         "'none' | 'pipelined' | 'auto'")
    if overlap == "pipelined" and mesh is not None and strategy != "ring":
        raise ValueError("overlap='pipelined' requires strategy='ring'; "
                         "the all-gather halo has no per-hop structure "
                         "to pipeline")
    if mesh is not None and strategy not in ("ring", "allgather"):
        raise ValueError(f"unknown strategy {strategy!r}; expected "
                         "'ring' | 'allgather'")
    if dedup_pad is not None:
        if dedup == "none":
            raise ValueError("dedup_pad= is only meaningful with "
                             "dedup='pairs'/'auto'")
        dedup_pad = (int(dedup_pad[0]), int(dedup_pad[1]))
    dev = _check_graph_device(g, device)
    machine = get_machine(machine)
    agg = cfg.aggregator
    use_fused = cfg.fused if fused is None else bool(fused)
    req_order = cfg.ordering if ordering is None else ordering
    tier = resolve_backend(backend, dev)
    require_device(tier, dev)
    spec_key = (cfg.name, cfg.conv, agg, tuple(cfg.hidden_dims),
                cfg.num_layers, int(in_dim), int(num_classes), tier,
                use_fused, req_order, machine.name, reorder, dtype, dedup,
                dedup_pad, _mesh_key(mesh), num_shards, strategy, axis,
                overlap)

    def builder():
        # -- locality reorder, before anything that depends on the vertex
        #    numbering (the blocked layouts, the dedup matching)
        g_exec, perm, decision = g, None, reorder
        if decision != "none":
            g2, p = _reordered_for(g)
            if decision == "auto":
                from repro_torch.graph.reorder import choose_reorder
                decision = choose_reorder(g, g2, p, int(in_dim), machine)
            if decision == "degree":
                g_exec, perm = g2, p

        partition, axes = None, ("node", "feat")
        if mesh is not None:
            if cfg.conv == "gin":
                raise ValueError(
                    "distributed plans support single-matmul convs "
                    "(gcn/sage); GIN's interior nonlinearity needs the "
                    "local path")
            partition, axes = _mesh_partition(g_exec, mesh, num_shards,
                                              axis, dev)

        hid = cfg.hidden_dims[0]
        dims_list = []
        d = in_dim
        for i in range(cfg.num_layers):
            dout = hid if i < cfg.num_layers - 1 else num_classes
            dims_list.append((d, cfg.hidden_dims[-1], dout)
                             if cfg.conv == "gin" else (d, dout))
            d = dout
        # the widest layer, whose bytes dominate, prices the dtype and dedup
        widest = max(dims_list, key=lambda ds: ds[0] * ds[-1])

        # -- execution dtype, before the layers: the fused tile is sized at
        #    the resolved dtype's width
        dt = dtype
        if dt == "auto":
            from repro_torch.profile.machine import choose_dtype
            shards = 1 if partition is None else \
                getattr(partition, "nodes", partition).num_shards
            dt = choose_dtype(g_exec.num_vertices, g_exec.num_edges,
                              widest[0], widest[-1], machine=machine,
                              num_shards=int(shards))
        layers = [
            _plan_layer(g_exec, i, cfg.conv, dims, agg_op=agg,
                        ordering=req_order, backend=tier,
                        fused=use_fused and partition is None,
                        machine=machine, dtype=dt, local=partition is None)
            for i, dims in enumerate(dims_list)]

        # -- pair dedup: the host matching runs once, here (a distributed
        #    plan folds per shard, max has no shareable adds: "none")
        dd, dlayout = ("none" if agg == "max" or partition is not None
                       else dedup), None
        if dd != "none":
            from repro_torch.graph import dedup as gdedup
            lay = gdedup.dedup_layout_for_graph(g_exec)
            if dd == "auto":
                from repro_torch.profile.machine import choose_dedup
                dd = choose_dedup(g_exec.num_vertices, g_exec.num_edges,
                                  widest[0], num_pairs=lay.num_pairs,
                                  num_edges2=lay.num_edges2, machine=machine,
                                  dtype=dt)
            if dd == "pairs" and lay.num_pairs == 0:
                dd = "none"             # nothing matched: the naive plan
            if dd == "pairs" and dedup_pad is not None:
                # the bucket form: the template's arrays padded to the
                # static capacities with sink no-ops on the last row
                pcap, ecap = dedup_pad
                arrays = gdedup.pad_dedup_arrays(
                    lay, pcap, ecap, g_exec.num_vertices - 1)
                pl_, pr_, s2_, d2_ = (torch.from_numpy(a).to(dev)
                                      for a in arrays)
                lay = lay._replace(pair_left=pl_, pair_right=pr_, src2=s2_,
                                   dst2=d2_, num_pairs=pcap, num_edges2=ecap)
            # a bucket plan's level-2 blocking comes with each dispatch
            if dd == "pairs" and dedup_pad is None:
                if any(lp.fused and lp.blocked is not None for lp in layers) \
                        or tier == CUDA:
                    tiles = [lp.blocked.tile_m for lp in layers
                             if lp.fused and lp.blocked is not None]
                    align = 32 if tier == CUDA else 8
                    atile = tiles[0] if tiles else max(
                        align, min(128, -(-g_exec.num_vertices // align)
                                   * align))
                    lay = gdedup.attach_blocked(lay, atile)
            if dd == "pairs":
                dlayout = lay

        # -- the halo schedule, resolved here so describe(), instrument()
        #    and the cache state what dispatch runs; a local plan has no
        #    collective to schedule
        ov, lays = (overlap if partition is not None else "none"), None
        if partition is not None:
            from repro_torch.core.distributed import choose_overlap
            pg = getattr(partition, "nodes", partition)
            width = partition.feature_block \
                if isinstance(partition, Partition2D) else (lambda f: f)
            if ov == "auto":
                # one schedule per plan, priced on what each layer's
                # exchange moves (dout combine-first, din otherwise; the
                # F/Q column slice on a 2-D partition)
                lens = [width(lp.din if lp.order == AGGREGATE_FIRST
                              else lp.dout) for lp in layers]
                ov = choose_overlap(pg, lens, machine, strategy=strategy)
            node_ax = axes[0] if isinstance(partition, Partition2D) \
                else axis
            nodes = tuple(sorted({mesh.index(c, node_ax)
                                  for c in mesh.coords}))
            lays = _shard_layouts_for(g_exec, pg, strategy, nodes)
        return GraphExecutionPlan(
            g_exec, layers, machine=machine, reorder=decision, perm=perm,
            dtype=dt, dedup=dd, dedup_layout=dlayout,
            dedup_pad=dedup_pad if dd == "pairs" else None, mesh=mesh,
            partition=partition, strategy=strategy, axis=axis, axes=axes,
            overlap=ov, shard_layouts=lays)

    return _cached_plan(g, spec_key, builder)


def plan_for_conv(conv, g: Graph, *, machine=None) -> GraphExecutionPlan:
    """Single-layer plan for a standalone conv (``plan_for_conv``, :1429):
    the conv's ``ordering`` / ``backend`` / ``fused`` are the requested
    decisions; the plan runs on the graph's device."""
    kind = type(conv).__name__.replace("Conv", "").lower()
    dims = (conv.din, conv.hidden, conv.dout) if kind == "gin" \
        else (conv.din, conv.dout)
    agg_op = "sum" if kind == "gin" else "mean"
    machine = get_machine(machine)
    tier = resolve_backend(conv.backend, g.device)
    require_device(tier, g.device)
    spec_key = ("conv", kind, dims, conv.ordering, tier, bool(conv.fused),
                machine.name)

    def builder():
        lp = _plan_layer(g, 0, kind, dims, agg_op=agg_op,
                         ordering=conv.ordering, backend=tier,
                         fused=conv.fused, machine=machine)
        return GraphExecutionPlan(g, [lp], machine=machine)

    return _cached_plan(g, spec_key, builder)


def plan_for_phases(g: Graph, weights, *, order: Optional[str] = None,
                    agg_op: str = "mean", backend: str = AUTO,
                    fused: bool = False, machine=None) -> GraphExecutionPlan:
    """Single-layer plan for a raw weight list (``plan_for_phases``,
    :1473); dims are inferred from the weight shapes and ``order=None``
    lets the cost model decide."""
    dims = tuple([int(w.shape[0]) for (w, _) in weights] +
                 [int(weights[-1][0].shape[1])])
    machine = get_machine(machine)
    tier = resolve_backend(backend, g.device)
    require_device(tier, g.device)
    spec_key = ("phase", dims, order, agg_op, tier, fused, machine.name)

    def builder():
        lp = _plan_layer(g, 0, "phase", dims, agg_op=agg_op,
                         ordering=order or AUTO, backend=tier, fused=fused,
                         machine=machine)
        return GraphExecutionPlan(g, [lp], machine=machine)

    return _cached_plan(g, spec_key, builder)
