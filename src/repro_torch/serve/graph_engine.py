"""GraphServeEngine: GCN node-prediction serving through bucketed compiled
plans (``repro/serve/graph_engine.py``).

The paper characterizes GCN *inference*; this engine serves it to a stream
of node-prediction requests.  It instantiates the shared serving core
(``serve.core.SlotServeCore``) for graph traffic as ``ServeEngine`` does
for LM decode:

  * **Admission** (host): each request samples its 2-hop frontier
    (``graph.sampling.two_hop_batch``, the paper's SAG setting) from one
    long-lived RNG, merges both hops into one destination-sorted union
    block (``union_two_hop``) and picks the smallest shape bucket that
    fits.
  * **Dispatch** (device): every bucket ``(num_seeds, num_inputs,
    num_edges)`` owns ONE ``plan.compile(dynamic=True, donate=True)``
    callable -- on a card one CUDA graph, captured by ``warmup()``.  The
    block is padded into the bucket's static shapes (zero feature rows,
    sink self-edges on the last row, zero in-degrees) and replayed with
    its edge arrays and, on the cuda tier, its blocked layout at the
    bucket's fixed capacity as runtime data, so any block that fits
    replays the same graph with no recapture.  The features stay on the
    device; the frontier's rows are gathered there into the padded x.
  * **Lifecycle and stats**: slots bound the requests in flight and are
    reused on completion; latency percentiles, throughput and the bucket
    counters report through ``WorkloadReport`` (``workload_report()``).

Exactness.  Pad edges touch only the sink row and stay out of the blocked
layout, so every real row aggregates exactly the real edges in the real
order, and K1 folds each row in slot order without atomics.  A replay
equals the bucket plan's eager forward over the same padded block bit for
bit (``run_eager(prep, padded=True)``).  Against the eager forward over
the unpadded block (``run_eager(prep)``, the reference's oracle) the
combination's matmuls run over other row counts, which a BLAS may split
differently, so the two agree within the f32 band.

Requests too large for every bucket are *bucket misses*: served through a
per-request eager plan and counted.  Those plans (and, on the cuda tier,
their host-built blocked layouts) grow the plan cache until the engine
sweeps it with ``core.plan.clear_plan_cache(keep=<bucket plans>)``, which
never drops a bucket plan or the CUDA graph it holds.

Example (CPU)::

    engine = GraphServeEngine(g, PAPER_MODELS["gcn"], None, x,
                              num_classes=7, fanouts=(5, 5), device="cpu")
    engine.params = engine.init_params(torch.Generator().manual_seed(0))
    engine.warmup()                      # one capture per bucket, warm path
    engine.submit(GraphRequest(rid=0, seeds=np.array([3, 17, 401])))
    done = engine.run()
    done[0].logits                       # (3, 7) seed logits, numpy
    print(engine.workload_report().to_markdown())
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.backend import AUTO, resolve_device
from repro_torch.core.dataflow import block_graph_arrays
from repro_torch.core.plan import (build_plan, clear_plan_cache,
                                   plan_cache_stats)
from repro_torch.graph.sampling import SampledBlock, two_hop_batch
from repro_torch.graph.structure import Graph, graph_from_coo
from repro_torch.models.gcn import GCNModel
from repro_torch.serve.core import SlotServeCore

#: host stages of a request served through its bucket (``stats()``'s
#: ``host_ms``): sampling, the union block, padding its arrays, the cuda
#: tier's blocked layout, the feature gather (enqueued on the device), and
#: the replay with the seed rows' readback (which waits for the device)
STAGES = ("sample", "union", "pad", "layouts", "gather", "replay")


class Bucket(NamedTuple):
    """One shape bucket; every field is a static dimension (``Bucket``,
    :62): seeds per request, padded frontier rows, padded union edges."""

    num_seeds: int
    num_inputs: int
    num_edges: int

    def fits(self, seeds: int, inputs: int, edges: int) -> bool:
        """True iff a block of these real sizes pads into this bucket.
        Pad edges are sink self-loops on the last row, so when any edge
        padding is needed the frontier must leave that row free."""
        if seeds > self.num_seeds or edges > self.num_edges:
            return False
        limit = self.num_inputs if edges == self.num_edges \
            else self.num_inputs - 1
        return inputs <= limit


def default_buckets(fanouts: Tuple[int, int],
                    seed_levels: Sequence[int] = (4, 16, 64),
                    max_inputs: Optional[int] = None) -> Tuple[Bucket, ...]:
    """The worst-case bucket ladder of ``two_hop_batch`` sampling
    (``default_buckets``, :89): per seed level s, hop-1 inputs
    ``s (1 + f1)``, union frontier ``s (1 + f1)(1 + f2)`` (capped at
    ``max_inputs``) plus one sink row, union edges
    ``s f1 + s (1 + f1) f2``."""
    f1, f2 = int(fanouts[0]), int(fanouts[1])
    out = []
    for s in sorted(int(v) for v in seed_levels):
        n1 = s * (1 + f1)
        frontier = n1 * (1 + f2)
        if max_inputs is not None:
            frontier = min(frontier, int(max_inputs))
        out.append(Bucket(num_seeds=s, num_inputs=frontier + 1,
                          num_edges=s * f1 + n1 * f2))
    return tuple(out)


def _bucket_template_graph(n: int, e: int, paired: bool, *,
                           device="cuda") -> Graph:
    """A deterministic graph with a bucket's static shapes
    (``_template_graph``, :221, and the trainer's
    ``_bucket_template_graph``, ``repro/models/sage_minibatch.py:111``).
    Only its shapes matter: every dispatch brings a runtime graph.
    ``paired`` plants one matched leading pair (destinations 0 and 1 both
    drawing from sources {0, 1}) so ``build_plan(dedup="pairs")`` does not
    resolve to "none"; the pair capacity comes from ``dedup_pad``.  Filler
    edges are self-loops."""
    if not paired:
        idx = np.arange(e, dtype=np.int32) % n
        return graph_from_coo(idx, idx, n, device=device)
    if n < 4 or e < 4:
        raise ValueError("bucket too small for a paired template")
    fill = np.arange(e - 4, dtype=np.int32) % (n - 2) + 2
    src = np.concatenate([np.array([0, 1, 0, 1], np.int32), fill])
    dst = np.concatenate([np.array([0, 0, 1, 1], np.int32), fill])
    return graph_from_coo(src, dst, n, device=device)


@dataclasses.dataclass
class GraphRequest:
    """One node-prediction request: logits for a batch of seed vertices
    (``GraphRequest``, :114)."""

    rid: int
    seeds: np.ndarray                     # (s,) global vertex ids
    # filled by the engine
    logits: Optional[np.ndarray] = None   # (s, num_classes), on the host
    bucket: Optional[Bucket] = None       # None => served as a bucket miss
    frontier_size: int = 0                # real union-frontier rows
    edge_count: int = 0                   # real union edges
    done: bool = False
    enqueue_t: float = 0.0
    finish_t: float = 0.0
    prep: Any = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class PreparedBlock:
    """The host's admission product: the sampled union block, bucketed
    (``PreparedBlock``, :131)."""

    frontier: np.ndarray                  # (n,) global frontier vertex ids
    graph: Graph                          # unpadded union graph, on the CPU
    seed_pos: np.ndarray                  # (s,) seed rows within frontier
    bucket: Optional[Bucket]              # None = no bucket fits (miss)


def _index_of(haystack: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """Positions of ``needles`` inside the sorted unique ``haystack``
    (``_index_of``, :140); raises when one is missing."""
    haystack = np.asarray(haystack)
    needles = np.asarray(needles)
    pos = np.searchsorted(haystack, needles)
    if not (pos < len(haystack)).all() or \
            not (haystack[np.minimum(pos, len(haystack) - 1)]
                 == needles).all():
        raise ValueError("the frontier must cover the needles")
    return pos.astype(np.int32)


def union_two_hop(hop2: SampledBlock, hop1: SampledBlock,
                  seeds: np.ndarray, *, device="cuda"
                  ) -> Tuple[np.ndarray, Graph, np.ndarray]:
    """Merge a (hop2, hop1) sampled pair into one union block
    (``union_two_hop``, :148): both hops' edges renumbered into the hop-2
    input frontier and concatenated into one destination-sorted
    multigraph over ``len(frontier)`` vertices, on ``device``.  A 2-layer
    forward over it gives the seed logits at ``seed_pos``.  Returns
    (frontier, graph, seed_pos)."""
    frontier = np.asarray(hop2.input_ids)
    pos_h1 = _index_of(frontier, hop1.input_ids)
    seed_pos = _index_of(frontier, seeds)
    src = np.concatenate([hop2.graph.src.cpu().numpy(),
                          pos_h1[hop1.graph.src.cpu().numpy()]])
    dst = np.concatenate([pos_h1[hop2.graph.dst.cpu().numpy()],
                          seed_pos[hop1.graph.dst.cpu().numpy()]])
    g = graph_from_coo(src, dst, len(frontier), device=device)
    return frontier, g, seed_pos


class GraphServeEngine(SlotServeCore):
    """Continuous-batching GCN inference on the shared serving core
    (``GraphServeEngine``, :172).

    ``g`` is sampled on the host (a graph on the card is copied to the CPU
    once, here); ``features`` (V, F) go to ``device`` (default
    ``"cuda"``, which raises without a card) and stay there; ``params``
    is the model's tree (``init_params``), which the caller may set after
    construction, before ``warmup``.  ``backend`` picks the bucket plans'
    tier as ``build_plan`` does: "auto" is the cuda tier (K1) on a card
    and the torch tier on the CPU.  ``seed`` seeds the one sampling RNG.
    See the module docstring for the serving contract.
    """

    def __init__(self, g: Graph, cfg, params, features, num_classes: int, *,
                 buckets: Optional[Sequence[Tuple[int, int, int]]] = None,
                 fanouts: Tuple[int, int] = (5, 5), max_batch: int = 8,
                 seed: int = 0, machine=None, ordering: Optional[str] = None,
                 plan_cache_watermark: int = 32, donate: bool = True,
                 device="cuda", backend: str = AUTO):
        super().__init__(max_batch)
        self.device = resolve_device(device)
        self.g = g
        self._host_g = g if g.device.type == "cpu" else g.to("cpu")
        self.cfg = cfg
        self.params = params
        if not isinstance(features, torch.Tensor):
            features = torch.from_numpy(np.array(features, np.float32))
        self.features = features.to(device=self.device, dtype=torch.float32)
        self.in_dim = int(self.features.shape[1])
        self.num_classes = int(num_classes)
        self.fanouts = (int(fanouts[0]), int(fanouts[1]))
        self.machine = machine
        self.ordering = ordering
        self.backend = backend
        self.plan_cache_watermark = int(plan_cache_watermark)
        # the caller gives up each bucket call's result at the next call:
        # on a card the replay's output buffer is returned without a copy,
        # and run_prepared copies the seed rows out before the next replay
        self.donate = bool(donate)
        self.rng = np.random.default_rng(seed)
        if buckets is None:
            buckets = default_buckets(self.fanouts,
                                      max_inputs=g.num_vertices)
        # selection order: smallest padded frontier, then edges, then seeds
        self.buckets: Tuple[Bucket, ...] = tuple(sorted(
            (Bucket(*b) for b in buckets),
            key=lambda b: (b.num_inputs, b.num_edges, b.num_seeds)))
        self._plans: Dict[Bucket, Any] = {}      # bucket -> plan
        self._fns: Dict[Bucket, Any] = {}        # bucket -> CompiledPlan
        self._bucket_hits: Dict[Bucket, int] = {b: 0 for b in self.buckets}
        self._bucket_misses = 0
        self._cache_sweeps = 0
        self._warmed = False
        #: host ms of each stage of the last request (``STAGES``)
        self.stage_ms: Dict[str, float] = {}
        self._stage_total = {k: 0.0 for k in STAGES}
        self._timed = 0                          # bucket hits timed

    # ----------------------------------------------------------- bucket mgmt

    def _template_graph(self, bucket: Bucket) -> Graph:
        """The bucket plan's graph: the bucket's static shapes on the
        engine's device (only shapes and the cost model's |V|, |E|
        matter; each dispatch brings its own edges)."""
        return _bucket_template_graph(bucket.num_inputs, bucket.num_edges,
                                      paired=False, device=self.device)

    def _capacity(self, bucket: Bucket) -> int:
        """Slots a destination row of the bucket's runtime layout holds: a
        union row has at most f1 + f2 edges (a seed is also a hop-1
        input); the template may pack more into a hand-made bucket."""
        return max(sum(self.fanouts),
                   -(-bucket.num_edges // bucket.num_inputs))

    def _bucket_plan(self, bucket: Bucket):
        plan = self._plans.get(bucket)
        if plan is None:
            plan = build_plan(self._template_graph(bucket), self.cfg,
                              self.in_dim, self.num_classes,
                              backend=self.backend, fused=False,
                              ordering=self.ordering, machine=self.machine,
                              device=self.device)
            self._plans[bucket] = plan
            self._fns[bucket] = plan.compile(dynamic=True,
                                             donate=self.donate)
        return plan, self._fns[bucket]

    def _layout(self, plan, bucket: Bucket, src: np.ndarray, dst: np.ndarray,
                num_vertices: Optional[int] = None):
        """The cuda tier's blocked layout of a block's real edges (None on
        the torch tier): over the bucket's rows at its fixed capacity, the
        capture's static shape, or fitted to an unpadded block's
        ``num_vertices`` rows for an eager forward over it."""
        if not plan.agg_tile:
            return None
        if num_vertices is None:
            return plan.runtime_layout(src, dst,
                                       max_in_deg=self._capacity(bucket))
        return block_graph_arrays(src, dst, num_vertices, plan.agg_tile,
                                  device=plan.device)

    def select_bucket(self, num_seeds: int, num_inputs: int,
                      num_edges: int) -> Optional[Bucket]:
        """Smallest fitting bucket (selection order: padded frontier rows,
        then edges, then seeds); None when every bucket is too small --
        a bucket miss, served eagerly and counted in ``stats()``."""
        for b in self.buckets:
            if b.fits(num_seeds, num_inputs, num_edges):
                return b
        return None

    def warmup(self) -> Dict[str, int]:
        """Capture every bucket before admission, pin the bucket plans,
        and drive the request path once per bucket.

        Runs each bucket's callable once on its template (so the first
        request pays no capture), sweeps the plan cache down to the bucket
        plans (``clear_plan_cache(keep=...)``) and runs the garbage
        collector: a swept plan and its compiled callable form a reference
        cycle that holds device memory and CUDA graphs, and the captures
        ran with the collector paused (``core.plan.capture_graph``), so
        that collection is paid here, not by the first request.  Then --
        on the first call -- one template request per bucket through what
        a real request runs: ``prepare`` (from a throwaway RNG, so the
        engine's own draws are untouched), ``_pad_into`` with the capacity
        layout, the feature gather, the replay and ``_seed_rows``.  That
        pays the process's first-use costs of those stages here, and,
        coming after the sweep and the collection (which walk every
        object and free what the captures left), it leaves the request
        path's code and memory as a served request leaves them, so
        first-request latency is honest; none of it counts in the stats
        (stage times, latencies, hits, misses) or as a trace.  Idempotent;
        returns ``{bucket-name: num_traces}``, every value 1 after a
        warm-up and through serving (the zero-retrace contract)."""
        self._capture_buckets()
        clear_plan_cache(keep=list(self._plans.values()))
        gc.collect()
        self._cache_sweeps += 1
        if not self._warmed:
            rng = np.random.default_rng(0)
            for b in self.buckets:
                self._warm_request(b, rng)
            self.stage_ms = {}
        self._warmed = True
        return {self._bucket_name(b): self._fns[b].num_traces
                for b in self.buckets}

    def _capture_buckets(self) -> None:
        """Each bucket's callable run once on its template: one capture."""
        for b in self.buckets:
            plan, fn = self._bucket_plan(b)
            if fn.num_traces == 0:
                t = plan.g
                x = torch.zeros((b.num_inputs, self.in_dim),
                                dtype=torch.float32, device=self.device)
                # the template's edges regrouped on the host, before its
                # capture  # analysis: allow(host-in-trace)
                src, dst = t.src.cpu().numpy(), t.dst.cpu().numpy()
                layout = self._layout(plan, b, src, dst)
                with torch.no_grad():
                    fn(self.params, x, t, layout=layout)

    def _warm_request(self, bucket: Bucket, rng: np.random.Generator
                      ) -> None:
        """One request of ``bucket.num_seeds`` seeds drawn from ``rng``,
        sampled with ``rng`` and served through ``bucket`` -- the request
        path of ``run_prepared`` without its stats -- when its block fits
        the bucket (a hand-made bucket may fit none)."""
        seeds = rng.choice(self.g.num_vertices,
                           size=min(bucket.num_seeds, self.g.num_vertices),
                           replace=False)
        prep = self.prepare(seeds, rng=rng)
        if not bucket.fits(len(seeds), len(prep.frontier),
                           prep.graph.num_edges):
            return
        prep.bucket = bucket
        _, fn = self._bucket_plan(bucket)
        x, g, layout = self._pad_into(prep, bucket)
        with torch.no_grad():
            self._seed_rows(fn(self.params, x, g, layout=layout), prep)

    @staticmethod
    def _bucket_name(b: Bucket) -> str:
        return f"s{b.num_seeds}/v{b.num_inputs}/e{b.num_edges}"

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Dict:
        """The model's parameter tree on the engine's device, drawn from
        ``generator`` (a CPU ``torch.Generator``; the reference takes a
        JAX key): ``GCNModel``'s, whose shapes depend only on (cfg,
        in_dim, classes)."""
        return GCNModel(self.cfg, self.in_dim, self.num_classes,
                        device=self.device, generator=generator).tree()

    # ----------------------------------------------------------- preparation

    def prepare(self, seeds: np.ndarray,
                rng: Optional[np.random.Generator] = None) -> PreparedBlock:
        """Host admission work for one request: sample the 2-hop frontier
        (fresh draws from ``rng``, by default the engine's long-lived RNG,
        in the reference's order), merge it into the union block, select
        the bucket."""
        t0 = time.perf_counter()
        seeds = np.asarray(seeds, np.int32)
        hop2, hop1 = two_hop_batch(self._host_g, seeds, self.fanouts,
                                   rng=self.rng if rng is None else rng,
                                   device="cpu")
        t1 = time.perf_counter()
        frontier, ug, seed_pos = union_two_hop(hop2, hop1, seeds,
                                               device="cpu")
        bucket = self.select_bucket(len(seeds), len(frontier), ug.num_edges)
        self.stage_ms.update(sample=(t1 - t0) * 1e3,
                             union=(time.perf_counter() - t1) * 1e3)
        return PreparedBlock(frontier=frontier, graph=ug, seed_pos=seed_pos,
                             bucket=bucket)

    def _gather(self, frontier: np.ndarray,
                rows: Optional[int] = None) -> torch.Tensor:
        """The frontier's feature rows, gathered on the device; with
        ``rows``, into a zeroed (rows, F) buffer (the pad rows stay 0)."""
        idx = torch.from_numpy(np.asarray(frontier, np.int64)).to(
            self.device)
        got = self.features.index_select(0, idx)
        if rows is None:
            return got
        x = torch.zeros((rows, self.in_dim), dtype=torch.float32,
                        device=self.device)
        x[: len(frontier)] = got
        return x

    def _pad_into(self, prep: PreparedBlock, bucket: Bucket
                  ) -> Tuple[torch.Tensor, Graph, Any]:
        """Pad the union block into the bucket's static shapes: (x, graph,
        blocked layout or None) on the device (``_pad_into``, :296).

        Pad feature rows are zero, pad edges are sink self-loops on the
        last row (keeping the destination sort), pad in-degrees are zero;
        the cuda tier's layout holds only the real edges, at the bucket's
        capacity.  So every real row sees exactly the real edge set in
        the real order."""
        t0 = time.perf_counter()
        plan, _ = self._bucket_plan(bucket)
        n, e = len(prep.frontier), prep.graph.num_edges
        pad_e = bucket.num_edges - e
        sink = bucket.num_inputs - 1
        src_r, dst_r = prep.graph.src.numpy(), prep.graph.dst.numpy()
        src = np.concatenate([src_r, np.full(pad_e, sink, np.int32)])
        dst = np.concatenate([dst_r, np.full(pad_e, sink, np.int32)])
        in_deg = np.zeros(bucket.num_inputs, np.int32)
        in_deg[:n] = prep.graph.in_deg.numpy()
        dev = self.device
        deg = torch.from_numpy(in_deg).to(dev)
        g = Graph(src=torch.from_numpy(src).to(dev),
                  dst=torch.from_numpy(dst).to(dev), in_deg=deg,
                  out_deg=deg, num_vertices=bucket.num_inputs)
        t1 = time.perf_counter()
        layout = self._layout(plan, bucket, src_r, dst_r)
        t2 = time.perf_counter()
        x = self._gather(prep.frontier, bucket.num_inputs)
        self.stage_ms.update(pad=(t1 - t0) * 1e3, layouts=(t2 - t1) * 1e3,
                             gather=(time.perf_counter() - t2) * 1e3)
        return x, g, layout

    # ------------------------------------------------------------- execution

    def _seed_rows(self, out: torch.Tensor, prep: PreparedBlock
                   ) -> np.ndarray:
        """The seed rows of a forward's output, copied to the host."""
        idx = torch.from_numpy(prep.seed_pos.astype(np.int64)).to(out.device)
        return out.index_select(0, idx).cpu().numpy()

    def run_prepared(self, prep: PreparedBlock) -> np.ndarray:
        """Serve one prepared block through its bucket's compiled callable
        (the production path); a miss goes to ``run_eager``.  With
        ``donate`` the replay's output is the capture's own buffer, so the
        seed rows are copied out (an index and a host copy) before the next
        replay can overwrite it."""
        if prep.bucket is None:
            return self.run_eager(prep)
        _, fn = self._bucket_plan(prep.bucket)
        x, g, layout = self._pad_into(prep, prep.bucket)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = self._seed_rows(fn(self.params, x, g, layout=layout),
                                     prep)
        self.stage_ms["replay"] = (time.perf_counter() - t0) * 1e3
        for k in STAGES:
            self._stage_total[k] += self.stage_ms[k]
        self._timed += 1
        return logits

    def run_eager(self, prep: PreparedBlock, *,
                  padded: bool = False) -> np.ndarray:
        """Eager forward of a prepared block, the oracles of the compiled
        path (``run_eager``, :334).

        With a bucket, the bucket plan replays its planned decisions
        eagerly (``run_model(graph=, graph_layout=)``): over the unpadded
        union block by default, the reference's oracle, which the replay
        matches within the f32 band; with ``padded``, over the padded block
        the replay ran, which it matches bit for bit.  Without a bucket (a
        miss), a plan is built for the union graph -- host planning work
        per request, and on the cuda tier a blocked layout built on the
        host; these transient plans are what the cache sweep drops."""
        b = prep.bucket
        with torch.no_grad():
            if b is None:
                g = prep.graph.to(self.device)
                plan = build_plan(g, self.cfg, self.in_dim, self.num_classes,
                                  backend=self.backend, fused=False,
                                  ordering=self.ordering,
                                  machine=self.machine, device=self.device)
                out = plan.run_model(self.params, self._gather(prep.frontier))
            elif padded:
                plan, _ = self._bucket_plan(b)
                x, g, layout = self._pad_into(prep, b)
                out = plan.run_model(self.params, x, graph=g,
                                     graph_layout=layout)
            else:
                plan, _ = self._bucket_plan(b)
                ug = prep.graph
                layout = self._layout(plan, b, ug.src.numpy(),
                                      ug.dst.numpy(), ug.num_vertices)
                out = plan.run_model(self.params,
                                     self._gather(prep.frontier),
                                     graph=ug.to(self.device),
                                     graph_layout=layout)
        return self._seed_rows(out, prep)

    # ------------------------------------------------------------ core hooks

    def _admit_into_slot(self, slot: int, req: GraphRequest) -> bool:
        req.prep = self.prepare(req.seeds)
        req.bucket = req.prep.bucket
        req.frontier_size = len(req.prep.frontier)
        req.edge_count = req.prep.graph.num_edges
        if req.bucket is None:
            self._bucket_misses += 1
        return False                       # always needs a dispatch step

    def _step(self) -> List[GraphRequest]:
        if not self._active:
            return []
        finished = []
        for slot in sorted(self._active):
            req = self._active[slot]
            req.logits = self.run_prepared(req.prep)
            if req.bucket is not None:
                self._bucket_hits[req.bucket] += 1
            finished.append(self._complete(slot))
        self._steps += 1
        self._maybe_sweep_plan_cache()
        return finished

    def _maybe_sweep_plan_cache(self) -> None:
        """The eviction policy: whenever transient per-request plans push
        the plan cache past the watermark, sweep everything but the
        pinned bucket plans."""
        if self._plans and \
                plan_cache_stats()["size"] > self.plan_cache_watermark:
            clear_plan_cache(keep=list(self._plans.values()))
            self._cache_sweeps += 1

    # ---------------------------------------------------------------- stats

    def retraces(self) -> int:
        """Captures beyond the one each bucket is allowed (> 0 means the
        zero-retrace serving contract was violated)."""
        return sum(max(0, fn.num_traces - 1) for fn in self._fns.values())

    def stats(self) -> Dict[str, Any]:
        """Core serving stats plus the bucket and cache view, and
        ``host_ms``: the mean host ms per bucket-served request of each
        stage (``STAGES``)."""
        out = super().stats()
        out.update(
            warmed=self._warmed,
            bucket_hits=sum(self._bucket_hits.values()),
            bucket_misses=self._bucket_misses,
            retraces=self.retraces(),
            cache_sweeps=self._cache_sweeps,
            plan_cache=plan_cache_stats(),
            buckets=[{"num_seeds": b.num_seeds, "num_inputs": b.num_inputs,
                      "num_edges": b.num_edges,
                      "hits": self._bucket_hits[b],
                      "compiled": self._fns[b].num_traces
                      if b in self._fns else 0}
                     for b in self.buckets],
            host_ms={k: v / max(1, self._timed)
                     for k, v in self._stage_total.items()})
        return out

    def serving_summary(self) -> Dict[str, Any]:
        """The ``WorkloadReport.serving`` section: request count, latency
        percentiles, throughput, and the bucket and retrace counters."""
        s = self.stats()
        return {"requests": s["served"],
                "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"],
                "p99_ms": s["p99_ms"],
                "throughput_rps": s["throughput_rps"],
                "bucket_misses": s["bucket_misses"],
                "retraces": s["retraces"],
                "buckets": s["buckets"]}

    def workload_report(self, machine=None):
        """One validated ``WorkloadReport`` for the serving run: the
        per-phase records of an instrumented eager forward over the
        busiest bucket's template (the dispatch path its capture
        recorded), with ``serving_summary()`` as ``report.serving``."""
        busiest = max(self.buckets,
                      key=lambda b: (self._bucket_hits[b], -b.num_inputs))
        plan, _ = self._bucket_plan(busiest)
        x = torch.zeros((busiest.num_inputs, self.in_dim),
                        dtype=torch.float32, device=self.device)
        report = plan.instrument(machine=machine or self.machine) \
            .run_model(self.params, x)
        report.serving = self.serving_summary()
        return report.validate()
