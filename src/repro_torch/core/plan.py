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
  * **Compiled execution.**  ``plan.compile()`` is the forward as a
    ``CompiledPlan``: on a card one CUDA graph per input signature, on the
    CPU the eager forward under the same caching and retrace guard.

This is the local, f32 subset of the reference.  ``build_plan`` raises
``NotImplementedError`` for what is not ported yet -- ``mesh=``,
``reorder`` other than "none", ``dtype`` other than "f32", ``dedup`` other
than "none"; nothing is silently ignored.

Public surface::

  build_plan(g, cfg, in_dim, num_classes, ...)  -> GraphExecutionPlan
  plan.run_model(params, x)       full forward through all planned layers
  plan.run_layer(params_i, x, layer=i)
  plan.run_phases(x, weights, ...)
  plan.compile(donate=, layer=, dynamic=)       -> CompiledPlan
  plan.instrument(machine=)       -> profile.instrument.InstrumentedPlan
  plan.describe()                 decisions + modeled aggregation cost
  plan.layer_costs(layer)         analytic per-phase costs (Tables 3/4)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import phases
from repro_torch.core.backend import (AUTO, CUDA, require_device,
                                      resolve_backend, resolve_device)
from repro_torch.core.dataflow import (BlockedGraph, block_graph,
                                       fused_gcn_layer, suggest_tile_m)
from repro_torch.core.scheduler import (AGGREGATE_FIRST, COMBINE_FIRST,
                                        choose_ordering, ordering_cost)
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
                 machine: Machine):
        self.g = g
        self.layers: Tuple[LayerPlan, ...] = tuple(layers)
        self.machine = machine
        self._compiled: Dict = {}    # (donate, layer, dynamic) -> CompiledPlan

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def device(self) -> torch.device:
        return self.g.device

    @property
    def compile_supported(self) -> bool:
        """True when every ``cuda`` layer owns its plan-built blocked
        layout, so the forward does no host work and can be captured.
        Plans built by the public entry points always qualify; False only
        for hand-built plans missing ``agg_layout``."""
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
                  _probe=None, graph: Optional[Graph] = None) -> torch.Tensor:
        """One planned layer from its conv param subtree ({"lin": ...} or
        {"mlp1": ..., "mlp2": ...}).  ``graph`` overrides the plan's graph
        for this dispatch (the dynamic mode of ``compile(dynamic=True)``);
        only torch-tier unfused plans read nothing but its edge arrays."""
        lp = self.layers[layer]
        weights, bias_post = self._split_params(lp, params)
        return _execute_layer(self.g if graph is None else graph, lp, x,
                              weights, bias_post=bias_post, probe=_probe)

    def run_model(self, params: Dict, x: torch.Tensor, *, _probe=None,
                  compiled: bool = False,
                  graph: Optional[Graph] = None) -> torch.Tensor:
        """Full forward: planned layers with ReLU between them.

        ``compiled=True`` routes through ``plan.compile()`` (or
        ``compile(dynamic=True)`` with ``graph=``) instead of the eager
        per-phase loop.  ``graph=`` substitutes another graph's edge arrays
        for this dispatch while replaying the same planned decisions; only
        torch-tier unfused plans accept it, and ``x`` rows must match it.
        """
        if compiled:
            if _probe is not None:
                raise ValueError(
                    "per-phase instrumentation needs eager phase "
                    "boundaries; InstrumentedPlan times the compiled "
                    "path separately (run_model(..., compiled=True))")
            if graph is not None:
                return self.compile(dynamic=True)(params, x, graph)
            return self.compile()(params, x)
        if graph is not None:
            self._check_dynamic_ok()
        h = x
        for i in range(self.num_layers):
            h = self.run_layer(params[f"conv{i}"], h, layer=i, _probe=_probe,
                               graph=graph)
            if i < self.num_layers - 1:
                h = torch.relu(h)
        return h

    def _check_dynamic_ok(self) -> None:
        """Dynamic (graph-as-argument) dispatch needs a forward that reads
        the edge arrays as data: torch-tier unfused layers do; ``cuda`` and
        fused layers run over host-built blocked layouts of the plan's own
        graph, so they are refused (``_check_dynamic_ok``, :334)."""
        problems = [
            f"layer {lp.index} ({lp.backend}{', fused' if lp.fused else ''})"
            f" runs over a host-built blocked layout"
            for lp in self.layers if lp.backend == CUDA or lp.fused]
        if problems:
            raise ValueError(
                "dynamic graph dispatch needs a forward that reads the edge "
                "arrays as data: " + "; ".join(problems) + " (build the "
                "bucket plan with backend='torch', fused=False)")

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
            graph)``: any ``Graph`` whose ``src``/``dst``/``in_deg`` shapes
            match the plan's; edge content varies per call with no
            recapture.  Torch-tier unfused plans only; not with ``layer=``.

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
        ``bias_post`` is added after aggregation."""
        return _execute_layer(self.g, self.layers[layer], x, weights,
                              edge_weight=edge_weight, activation=activation,
                              bias_post=bias_post, probe=_probe)

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
        The keys are the reference's; ``dtype``/``reorder``/``dedup``/
        ``interpret``/``distributed``/``partition``/``overlap`` state the
        only values the port takes, and ``compiled`` whether
        ``plan.compile()`` works (always, for plans built by the public
        entry points)."""
        out = []
        compiled_ok = self.compile_supported
        for lp in self.layers:
            oc = ordering_cost(self.g, lp.din, lp.dout, lp.order)
            out.append({
                "layer": lp.index, "kind": lp.kind,
                "din": lp.din, "dout": lp.dout,
                "order": lp.order, "backend": lp.backend,
                "fused": lp.fused, "tile_m": lp.tile_m,
                "interpret": False, "distributed": False,
                "partition": "none", "overlap": "none",
                "dtype": "f32", "reorder": "none", "compiled": compiled_ok,
                "dedup": "none",
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


class _Captured:
    """One input signature's CUDA graph: static buffers for the params
    leaves and the array arguments, the graph, and its static output.

    Built by the first call of a signature: the inputs are copied into the
    static buffers, one warm-up forward runs on a side stream (it builds
    and loads the kernels and sets their attributes, none of which may
    happen under capture), then the forward is captured once.  The
    warm-up's result answers that first call.  ``launches`` counts each
    kernel's launches recorded into the graph; a replay moves no counter.
    """

    def __init__(self, fn, leaves, arrays, device: torch.device):
        from repro_torch.kernels.ops import launch_counts
        # plain tensors even when the caller is in inference mode: later
        # calls copy into them from anywhere
        with torch.inference_mode(False), torch.no_grad():
            self.leaves = [(p, torch.empty_like(t)) for p, t in leaves]
            self.arrays = [torch.empty_like(a) for a in arrays]
            self.load(leaves, arrays)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                first = fn(_tree(self.leaves), *self.arrays)
            torch.cuda.current_stream(device).wait_stream(side)
            first.record_stream(torch.cuda.current_stream(device))
            self.first = first
            self.graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.cuda.graph(self.graph):
                self.out = fn(_tree(self.leaves), *self.arrays)
            self.launches = {k: n - before[k]
                             for k, n in launch_counts().items()}

    def load(self, leaves, arrays) -> None:
        for (_, dst), (_, src) in zip(self.leaves, leaves):
            dst.copy_(src)
        for dst, src in zip(self.arrays, arrays):
            dst.copy_(src)


class CompiledPlan:
    """A plan's forward as one callable, with a retrace guard
    (``CompiledPlan``, :560).

    The first call per input signature -- shapes and dtypes of ``x``, of
    the params leaves and, in dynamic mode, of ``src``/``dst``/``in_deg``
    -- traces: on a card it captures a CUDA graph (``_Captured``), on the
    CPU it runs the eager forward.  Later calls of that signature replay:
    on a card they copy the inputs into the static buffers (so new
    parameter values take effect, as with ``jax.jit``), replay the graph
    and clone its output (``donate=True``: no clone, see
    ``plan.compile``); on the CPU they run the eager forward again.
    ``num_traces`` counts traces, ``num_replays`` the calls served by an
    existing trace; a trace for a signature already traced raises
    ``RuntimeError``.  Inference only: the forward runs under
    ``torch.no_grad()``.

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

    def _forward(self, params, x, *graph_arrays):
        if graph_arrays:
            src, dst, in_deg = graph_arrays
            g = self.plan.g._replace(src=src, dst=dst, in_deg=in_deg,
                                     row_ptr=None)
            return self.plan.run_model(params, x, graph=g)
        if self.layer is None:
            return self.plan.run_model(params, x)
        return self.plan.run_layer(params, x, layer=self.layer)

    @staticmethod
    def _signature(leaves, arrays):
        return (tuple((tuple(a.shape), a.dtype, a.device) for a in arrays),
                tuple(p for p, _ in leaves),
                tuple((tuple(t.shape), t.dtype) for _, t in leaves))

    def _graph_args(self, graph: Graph):
        """Validate a runtime graph for the dynamic mode: a shape mismatch
        raises here, never silently absorbed by a recapture."""
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
        return (graph.src, graph.dst, graph.in_deg)

    def __call__(self, params, x, graph: Optional[Graph] = None):
        if self.dynamic:
            if graph is None:
                raise ValueError("dynamic compiled plans take (params, x, "
                                 "graph)")
            arrays = (x,) + self._graph_args(graph)
        else:
            if graph is not None:
                raise ValueError("this compiled plan is static; build it "
                                 "with plan.compile(dynamic=True) to pass "
                                 "a runtime graph")
            arrays = (x,)
        leaves = _leaves(params)
        sig = self._signature(leaves, arrays)
        on_card = self.plan.device.type == "cuda"
        if sig in self._traces:
            self._num_replays += 1
            cap = self._traces[sig]
            if cap is None:
                with torch.no_grad():
                    return self._forward(params, *arrays)
            with torch.no_grad():
                cap.load(leaves, arrays)
            cap.graph.replay()
            return cap.out if self.donate else cap.out.clone()
        self._num_traces += 1
        if sig in self._seen:
            raise RuntimeError(
                "plan.compile() retraced for an input signature it already "
                "captured -- something dropped the capture cache")
        if on_card:
            cap = _Captured(self._forward, leaves, arrays, self.plan.device)
            out = cap.first
            cap.first = None
        else:
            cap = None
            with torch.no_grad():
                out = self._forward(params, *arrays)
        self._traces[sig] = cap
        self._seen.add(sig)
        return out


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


def _execute_layer(g: Graph, lp: LayerPlan, x: torch.Tensor, weights, *,
                   edge_weight=None, activation: str = "relu",
                   bias_post=None, probe=None) -> torch.Tensor:
    """Execute one layer per its plan: fusion > ordering > backend
    (``_execute_layer``, :762-878, f32 branch).  Each phase goes through
    ``_phase`` where the reference records one."""
    mlp_dims = tuple([int(w.shape[0]) for (w, _) in weights] +
                     [int(weights[-1][0].shape[1])])
    if _can_fuse(lp, weights, edge_weight):
        w0, b0 = weights[0]
        fused_dims = (int(w0.shape[0]), int(w0.shape[1]))
        if len(weights) == 1:
            # whole layer fused; an inline b0 is exact post-aggregation
            # here (what _can_fuse admitted), so fold it into the bias
            bias = b0 if bias_post is None else (
                bias_post if b0 is None else b0 + bias_post)
            return _phase(
                probe, "fused_agg_combine",
                lambda: fused_gcn_layer(lp.blocked, x, w0, bias,
                                        agg_op=_fused_agg_op(lp),
                                        in_deg=g.in_deg, backend=lp.backend),
                lp=lp, dims=fused_dims)
        # multi-layer MLP (GIN): fuse aggregation with the FIRST matmul --
        # exact because the aggregation is linear and the interior
        # nonlinearity only applies after that matmul
        h = _phase(
            probe, "fused_agg_combine",
            lambda: fused_gcn_layer(lp.blocked, x, w0, b0,
                                    agg_op=_fused_agg_op(lp),
                                    in_deg=g.in_deg, backend=lp.backend),
            lp=lp, dims=fused_dims)
        h = phases._act(activation)(h)
        h = _phase(probe, "combine",
                   lambda: phases.combine(h, weights[1:],
                                          activation=activation),
                   lp=lp, dims=mlp_dims[1:])
    elif lp.order == COMBINE_FIRST:
        h = _phase(probe, "combine",
                   lambda: phases.combine(x, weights, activation=activation),
                   lp=lp, dims=mlp_dims)
        h = _phase(probe, "aggregate",
                   lambda: phases.aggregate(
                       g, h, op=lp.agg_op, edge_weight=edge_weight,
                       include_self=lp.include_self, backend=lp.backend,
                       layout=lp.agg_layout),
                   lp=lp, feature_len=int(h.shape[-1]))
    else:
        h = _phase(probe, "aggregate",
                   lambda: phases.aggregate(
                       g, x, op=lp.agg_op, edge_weight=edge_weight,
                       include_self=lp.include_self, backend=lp.backend,
                       layout=lp.agg_layout),
                   lp=lp, feature_len=int(x.shape[-1]))
        h = _phase(probe, "combine",
                   lambda: phases.combine(h, weights, activation=activation),
                   lp=lp, dims=mlp_dims)
    if bias_post is not None:
        h = h + bias_post
    return h


# ---------------------------------------------------------------------------
# Plan construction + caching
# ---------------------------------------------------------------------------

_PLAN_CACHE: Dict = {}      # (graph_key, spec_key) -> (src_ref, plan)
_BLOCKED_CACHE: Dict = {}   # (graph_key, tile_m)   -> (src_ref, BlockedGraph)
_CACHE_LIMIT = 64

#: hits/misses count ``_cached_plan`` lookups; evictions count entries
#: dropped by FIFO aging
_PLAN_CACHE_STATS: Dict[str, int] = {"hits": 0, "misses": 0, "evictions": 0}


def plan_cache_stats() -> Dict[str, int]:
    """``{size, limit, blocked_size, hits, misses, evictions}``."""
    return {"size": len(_PLAN_CACHE), "limit": _CACHE_LIMIT,
            "blocked_size": len(_BLOCKED_CACHE), **_PLAN_CACHE_STATS}


def clear_plan_cache() -> int:
    """Drop every cached plan and blocked layout and reset the counters.
    Returns the number of plans dropped."""
    n = len(_PLAN_CACHE)
    _PLAN_CACHE.clear()
    _BLOCKED_CACHE.clear()
    _PLAN_CACHE_STATS.update(hits=0, misses=0, evictions=0)
    return n


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
                include_self: bool = True, machine=None) -> LayerPlan:
    """Resolve one layer's ordering / tier / fusion (``_plan_layer``,
    :1021), priced on ``machine`` (default ``H100``).

    Plans only: a ``cuda`` layer may be planned over a graph on the CPU
    (nothing launches here); running it there raises.
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
        tile_m = suggest_tile_m(dims[0], dims[1], avg_deg, machine=machine)
        # a tile larger than the graph only pads: clamp to |V| rounded up,
        # keeping the tier's alignment (warp rows on cuda)
        tile_m = max(align, min(tile_m, -(-g.num_vertices // align) * align))
        blocked = _blocked_for(g, tile_m)
    agg_layout = None
    if backend == CUDA:
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


def build_plan(g: Graph, cfg, in_dim: int, num_classes: int, *,
               backend: str = AUTO, fused: Optional[bool] = None,
               ordering: Optional[str] = None, machine=None,
               device="cuda", mesh=None, reorder: str = "none",
               dtype: str = "f32", dedup: str = "none") -> GraphExecutionPlan:
    """Plan a full model (``GCNModelConfig``) over one graph
    (``build_plan``, :1092).

    ``device`` is where the plan runs (default ``"cuda"``, which raises
    without a card); the graph must already live there.  ``backend``
    "auto" resolves to ``cuda`` on a CUDA device and ``torch`` on the CPU;
    "cuda" on the CPU raises.  ``fused`` / ``ordering`` default from
    ``cfg``; ``machine`` (a ``Machine`` or registry name, default
    ``H100``) prices the ordering and the fused tile.  Plans are cached
    per (graph, arguments).

    Not ported yet, and raising ``NotImplementedError`` rather than being
    ignored: ``mesh``, ``reorder`` other than "none", ``dtype`` other than
    "f32" and ``dedup`` other than "none".

    Example (CPU)::

        >>> spec = reduced_graph(CORA, 220, 24)
        >>> g = make_synthetic_graph(spec, device="cpu")
        >>> plan = build_plan(g, PAPER_MODELS["gcn"], spec.feature_len,
        ...                   spec.num_classes, device="cpu")
        >>> plan.describe()[0]["backend"]
        'torch'
    """
    for name, value, default in (("mesh", mesh, None),
                                 ("reorder", reorder, "none"),
                                 ("dtype", dtype, "f32"),
                                 ("dedup", dedup, "none")):
        if value != default:
            raise NotImplementedError(
                f"build_plan({name}={value!r}) is not ported yet; the port "
                f"plans local f32 execution only")
    dev = _check_graph_device(g, device)
    machine = get_machine(machine)
    agg = cfg.aggregator
    use_fused = cfg.fused if fused is None else bool(fused)
    req_order = cfg.ordering if ordering is None else ordering
    tier = resolve_backend(backend, dev)
    require_device(tier, dev)
    spec_key = (cfg.name, cfg.conv, agg, tuple(cfg.hidden_dims),
                cfg.num_layers, int(in_dim), int(num_classes), tier,
                use_fused, req_order, machine.name)

    def builder():
        hid = cfg.hidden_dims[0]
        dims_list = []
        d = in_dim
        for i in range(cfg.num_layers):
            dout = hid if i < cfg.num_layers - 1 else num_classes
            dims_list.append((d, cfg.hidden_dims[-1], dout)
                             if cfg.conv == "gin" else (d, dout))
            d = dout
        layers = [
            _plan_layer(g, i, cfg.conv, dims, agg_op=agg, ordering=req_order,
                        backend=tier, fused=use_fused, machine=machine)
            for i, dims in enumerate(dims_list)]
        return GraphExecutionPlan(g, layers, machine=machine)

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
