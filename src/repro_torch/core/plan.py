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

This is the local, f32 subset of the reference.  ``build_plan`` raises
``NotImplementedError`` for what is not ported yet -- ``mesh=``,
``reorder`` other than "none", ``dtype`` other than "f32", ``dedup`` other
than "none" -- and so does ``plan.compile()``; nothing is silently ignored.

Public surface::

  build_plan(g, cfg, in_dim, num_classes, ...)  -> GraphExecutionPlan
  plan.run_model(params, x)       full forward through all planned layers
  plan.run_layer(params_i, x, layer=i)
  plan.run_phases(x, weights, ...)
  plan.describe()                 decisions + modeled aggregation cost
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

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def device(self) -> torch.device:
        return self.g.device

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

    def run_layer(self, params: Dict, x: torch.Tensor, *,
                  layer: int = 0) -> torch.Tensor:
        """One planned layer from its conv param subtree ({"lin": ...} or
        {"mlp1": ..., "mlp2": ...})."""
        lp = self.layers[layer]
        weights, bias_post = self._split_params(lp, params)
        return _execute_layer(self.g, lp, x, weights, bias_post=bias_post)

    def run_model(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """Full forward: planned layers with ReLU between them."""
        h = x
        for i in range(self.num_layers):
            h = self.run_layer(params[f"conv{i}"], h, layer=i)
            if i < self.num_layers - 1:
                h = torch.relu(h)
        return h

    def run_phases(self, x: torch.Tensor, weights, *, layer: int = 0,
                   edge_weight=None, activation: str = "relu",
                   bias_post=None) -> torch.Tensor:
        """Raw weight-list execution: ``weights`` is a list of (W, b) with
        biases applied inside the MLP; ``bias_post`` is added after
        aggregation."""
        return _execute_layer(self.g, self.layers[layer], x, weights,
                              edge_weight=edge_weight, activation=activation,
                              bias_post=bias_post)

    def compile(self, **_):
        raise NotImplementedError(
            "compiled execution (plan.compile) is not ported yet; the port "
            "runs eagerly")

    def describe(self) -> List[Dict]:
        """One dict per layer: every planned decision + modeled agg cost.
        The keys are the reference's, less those of features not ported
        (``dtype``/``reorder``/``dedup`` state the only values the port
        takes)."""
        out = []
        for lp in self.layers:
            oc = ordering_cost(self.g, lp.din, lp.dout, lp.order)
            out.append({
                "layer": lp.index, "kind": lp.kind,
                "din": lp.din, "dout": lp.dout,
                "order": lp.order, "backend": lp.backend,
                "fused": lp.fused, "tile_m": lp.tile_m,
                "dtype": "f32", "reorder": "none", "dedup": "none",
                "agg_bytes": oc.agg_bytes, "agg_flops": oc.agg_flops,
            })
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


def _execute_layer(g: Graph, lp: LayerPlan, x: torch.Tensor, weights, *,
                   edge_weight=None, activation: str = "relu",
                   bias_post=None) -> torch.Tensor:
    """Execute one layer per its plan: fusion > ordering > backend
    (``_execute_layer``, :762-878, f32 branch)."""
    if _can_fuse(lp, weights, edge_weight):
        w0, b0 = weights[0]
        if len(weights) == 1:
            # whole layer fused; an inline b0 is exact post-aggregation
            # here (what _can_fuse admitted), so fold it into the bias
            bias = b0 if bias_post is None else (
                bias_post if b0 is None else b0 + bias_post)
            return fused_gcn_layer(lp.blocked, x, w0, bias,
                                   agg_op=_fused_agg_op(lp), in_deg=g.in_deg,
                                   backend=lp.backend)
        # multi-layer MLP (GIN): fuse aggregation with the FIRST matmul --
        # exact because the aggregation is linear and the interior
        # nonlinearity only applies after that matmul
        h = fused_gcn_layer(lp.blocked, x, w0, b0, agg_op=_fused_agg_op(lp),
                            in_deg=g.in_deg, backend=lp.backend)
        h = phases._act(activation)(h)
        h = phases.combine(h, weights[1:], activation=activation)
    elif lp.order == COMBINE_FIRST:
        h = phases.combine(x, weights, activation=activation)
        h = phases.aggregate(g, h, op=lp.agg_op, edge_weight=edge_weight,
                             include_self=lp.include_self, backend=lp.backend,
                             layout=lp.agg_layout)
    else:
        h = phases.aggregate(g, x, op=lp.agg_op, edge_weight=edge_weight,
                             include_self=lp.include_self, backend=lp.backend,
                             layout=lp.agg_layout)
        h = phases.combine(h, weights, activation=activation)
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
