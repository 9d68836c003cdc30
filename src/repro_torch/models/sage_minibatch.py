"""GraphSAGE minibatch training (``repro/models/sage_minibatch.py``; paper
§2: "GraphSAGE only updates a batch of vertexes along with their 2-hop
neighbors in an iteration").

Two training paths:

  * ``SageMiniBatchModel`` / ``train_minibatch_sage`` -- the per-block
    demo: each sampled block gets its own plan (``plan_for_conv``, cached
    per block graph), so the planner re-decides the phase order per block.
  * ``PlannedSageTrainer`` / ``train_minibatch_planned`` -- the production
    loop: ONE worst-case shape bucket and ONE cached bucket plan.  Every
    ``data.pipeline.GraphPipeline`` block is padded into the bucket (sink
    no-ops) and dispatched as a runtime graph -- with, on ``dedup="pairs"``
    plans, the block's two-level pair layout -- and checkpoint-resume is
    exact because the pipeline state IS the step counter.

A step is the forward, the mean NLL at the seeds, the backward and the
SGD update ``p - lr * g`` of the parameters in place -- the port of the
reference's ``jax.jit`` of its step (``_make_step``): on a card ONE CUDA
graph per bucket, captured at the first step and replayed at every step
after (``_CapturedStep``), its static inputs the padded block's arrays,
layouts, features (gathered straight into the graph's buffer), seed
positions and labels; on the CPU the same step eagerly.  Only the host
stages run outside the graph: sampling, union and padding, the layouts,
dedup matching.  On the cuda tier K1 carries the aggregation both ways:
the forward over the block's blocked layout, the backward over its capped
transposed layout (``kernels.seg_agg.SegAgg``), both built on the host at
the bucket's fixed capacity, so every block of the bucket launches the
same kernels.  K1 folds without atomics, so on the card, as on the CPU, a
replayed step equals the eager one (``loss_and_grads``, ``_sgd``) bit for
bit, and a resumed run the uninterrupted one.  The trainer runs unfused:
K2 has no backward.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import GCNModelConfig, GraphSpec
from repro_torch.core.backend import AUTO, resolve_device
from repro_torch.core.plan import (CompiledPlan, _leaves, _tree, build_plan,
                                   capture_graph, plan_for_conv)
from repro_torch.graph.sampling import SampledBlock, two_hop_batch
from repro_torch.graph.structure import Graph
from repro_torch.data.pipeline import GraphPipeline
from repro_torch.graph.dedup import build_dedup_layout, pad_dedup_arrays
from repro_torch.models.gcn import GCNModel
from repro_torch.optim.optimizer import adamw_update
from repro_torch.profile.machine import choose_dedup, get_machine
from repro_torch.serve.graph_engine import (_bucket_template_graph,
                                            _index_of, default_buckets,
                                            union_two_hop)


def _sage_cfg(hidden: int) -> GCNModelConfig:
    return GCNModelConfig(name=f"sage-mb-h{hidden}", conv="sage",
                          aggregator="mean", hidden_dims=(int(hidden),),
                          ordering="auto", num_layers=2)


def _on(a, device, dtype=None) -> torch.Tensor:
    """``a`` (a tensor or an array) as a tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        arr = np.asarray(a)
        a = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return a.to(device=device, dtype=dtype)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels``."""
    ll = torch.log_softmax(logits, dim=-1)
    return -ll.gather(-1, labels.long()[:, None]).mean()


def _sgd(leaves, grads, lr: float) -> None:
    """``p <- p - lr * g`` in place, rounded as the reference rounds it
    (``lr * g`` first)."""
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.copy_(p - lr * g)


class SageMiniBatchModel:
    """Two SAGE-mean convolutions, in_dim -> hidden -> num_classes, each
    planned per sampled block (``SageMiniBatchModel``, :37).  Parameters
    are the reference's tree ``{"l1": {"lin": ...}, "l2": ...}`` of the
    ``GCNModel`` underneath, drawn from ``generator``."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        self.net = GCNModel(_sage_cfg(hidden), in_dim, num_classes,
                            device=device, generator=generator)
        self.layer1, self.layer2 = self.net.conv0, self.net.conv1

    def init(self) -> Dict:
        """The parameter tree (the modules' own tensors)."""
        return {"l1": self.layer1.tree(), "l2": self.layer2.tree()}

    def load_reference(self, tree: Dict) -> Dict:
        """Load the reference's ``{"l1": ..., "l2": ...}`` tree (numpy
        leaves) through ``GCNModel.params_from_reference``; returns
        ``init()``."""
        self.net.params_from_reference({"conv0": tree["l1"],
                                        "conv1": tree["l2"]})
        return self.init()

    def apply(self, params, hop2: SampledBlock, hop1: SampledBlock,
              x_inputs: torch.Tensor) -> torch.Tensor:
        """Logits of ``hop1.seed_ids`` from ``x_inputs``, the features of
        ``hop2.input_ids`` (``apply``, :46)."""
        p1 = plan_for_conv(self.layer1, hop2.graph)
        p2 = plan_for_conv(self.layer2, hop1.graph)
        h = torch.relu(p1.run_layer(params["l1"], x_inputs))
        rows = _index_of(hop2.input_ids, hop1.input_ids)
        h1_inputs = h[torch.from_numpy(rows).to(h.device).long()]
        out = p2.run_layer(params["l2"], h1_inputs)
        return out[: len(hop1.seed_ids)]

    def loss(self, params, hop2, hop1, x_inputs, labels) -> torch.Tensor:
        return _nll(self.apply(params, hop2, hop1, x_inputs), labels)

    def orderings(self, hop2: SampledBlock, hop1: SampledBlock
                  ) -> Tuple[str, str]:
        return (self.layer1.resolve_order(hop2.graph),
                self.layer2.resolve_order(hop1.graph))


def train_minibatch_sage(graph, spec: GraphSpec, features, labels, *,
                         steps: int = 20, batch_size: int = 32,
                         fanouts=(5, 5), lr: float = 0.1, seed: int = 0,
                         device="cuda", params: Optional[Dict] = None):
    """The per-block minibatch loop (``train_minibatch_sage``, :81):
    sampling on the host, one plan per block on ``device``.  ``params``
    (the reference's tree, numpy leaves) replaces the seeded initial
    weights.  Returns (params, losses, model)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = SageMiniBatchModel(spec.feature_len, 128, spec.num_classes,
                               device=dev,
                               generator=torch.Generator().manual_seed(seed))
    tree = model.init() if params is None else model.load_reference(params)
    host_graph = graph if graph.device.type == "cpu" else graph.to("cpu")
    feats = _on(features, dev, torch.float32)
    labs = _on(labels, dev, torch.long)
    losses = []
    for step in range(steps):
        seeds = rng.choice(spec.num_vertices, size=batch_size,
                           replace=False).astype(np.int32)
        hop2, hop1 = two_hop_batch(host_graph, seeds, fanouts,
                                   seed=seed * 1000 + step, device=dev)
        x_in = feats[torch.from_numpy(hop2.input_ids).to(dev).long()]
        y = labs[torch.from_numpy(hop1.seed_ids).to(dev).long()]
        leaves = [t for _, t in _leaves(tree)]
        loss = model.loss(tree, hop2, hop1, x_in, y)
        _sgd(leaves, torch.autograd.grad(loss, leaves), lr)
        losses.append(float(loss.detach()))
    return tree, losses, model


def make_sage_train_step(model: SageMiniBatchModel, features, labels,
                         opt_cfg):
    """``step_fn(state, batch) -> (state, metrics)`` for
    ``train.trainer.Trainer``: the per-block SAGE loss on a
    ``GraphPipeline`` batch, then an AdamW update (``optim.optimizer``) of
    the ``TrainState`` whose params are ``model.init()``'s tree.  Metrics:
    loss, lr, grad_norm."""
    dev = model.net.device
    feats = _on(features, dev, torch.float32)
    labs = _on(labels, dev, torch.long)

    def step_fn(state, batch):
        hop2, hop1 = batch["hop2"], batch["hop1"]
        x_in = feats[torch.from_numpy(hop2.input_ids).to(dev).long()]
        y = labs[torch.from_numpy(hop1.seed_ids).to(dev).long()]
        leaves = [(p, t.detach().requires_grad_())
                  for p, t in _leaves(state.params)]
        params = _tree(leaves)
        loss = model.loss(params, hop2, hop1, x_in, y)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        state, metrics = adamw_update(
            state._replace(params=_tree([(p, t.detach())
                                         for p, t in leaves])),
            _tree([(p, g) for (p, _), g in zip(leaves, grads)]), opt_cfg)
        metrics["loss"] = loss.detach()
        return state, metrics

    return step_fn


# ---------------------------------------------------------------------------
# Bucketed minibatch training (the production loop)
# ---------------------------------------------------------------------------


class _CapturedStep:
    """One bucket's training step as a CUDA graph: ``body()`` -- the loss
    and the parameters' gradients over static input buffers -- then the
    SGD update of ``leaves`` in place, captured once and replayed.

    A warm-up forward and backward (no update) runs on a side stream
    first: it builds and loads the kernels and sets their attributes,
    none of which may happen under capture.  The capture itself runs
    nothing, so the parameters are untouched until the first replay.
    ``loss`` is the graph's static loss; ``launches`` the kernels' launch
    counts recorded into the graph (a replay moves no counter)."""

    def __init__(self, body, statics, leaves, lr: float,
                 device: torch.device):
        from repro_torch.kernels.ops import launch_counts
        self.statics = statics
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with capture_graph(self.graph):
            loss, grads = body()
            _sgd(leaves, grads, lr)
            self.loss = loss.detach()
        self.launches = {k: n - before[k] for k, n in launch_counts().items()}

    def replay(self, arrays) -> torch.Tensor:
        """Copy ``arrays`` into the static buffers, replay, and return the
        static loss."""
        with torch.no_grad():
            for dst, src in zip(self.statics, arrays):
                dst.copy_(src)
        self.graph.replay()
        return self.loss


class PlannedSageTrainer:
    """Steady-state minibatch training through ONE bucketed plan
    (``PlannedSageTrainer``, :133).

    Set-up, once: the worst-case bucket of (batch_size, fanouts)
    (``serve.graph_engine.default_buckets``), the ``dedup`` decision --
    ``"auto"`` prices the step-0 block's pair statistics at the bucket's
    shapes on ``machine`` (default ``H100``) -- and the bucket plan on
    ``device`` (``build_plan(..., fused=False, dedup=, dedup_pad=)``; the
    tier is ``backend``, by default the device's), its
    ``compile(dynamic=True, donate=)`` forward for ``predict`` and the
    model (``GCNModel``, drawn from ``generator`` or the seed).

    A step: ``GraphPipeline.batch_at(step)`` samples on the host, the
    union block is padded into the bucket, on the cuda tier its forward
    and capped transposed layouts are built on the host at the bucket's
    fixed capacity, on a pairs plan its dedup layout is matched and padded
    to the bucket's pair capacity (``pad_dedup_arrays``), the features are
    gathered on the device, and the plan -- re-fetched through
    ``build_plan``, a plan-cache hit -- runs forward and backward and the
    parameters take the SGD update: on a card through the bucket's
    captured step (``_CapturedStep``: its buffers take the block's
    arrays, the feature gather writes into its ``x``), on the CPU eagerly.
    ``stage_ms`` holds the last step's host milliseconds per stage.

    Exactness: the forward (``predict``, and each step's loss) equals
    between ``dedup="pairs"`` and ``"none"`` bit for bit in f32 (the
    leading-pair discipline of graph/dedup.py); their gradients round
    differently, so training agrees within the f32 band.
    """

    def __init__(self, graph: Graph, spec: GraphSpec, features, labels, *,
                 hidden: int = 64, batch_size: int = 8,
                 fanouts: Tuple[int, int] = (3, 3), lr: float = 0.1,
                 seed: int = 0, dedup: str = "auto", donate: bool = False,
                 machine=None, device="cuda", backend: str = AUTO,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.graph, self.spec = graph, spec
        self.features = _on(features, self.device, torch.float32)
        self.labels = np.asarray(labels.cpu() if isinstance(
            labels, torch.Tensor) else labels, np.int64)
        self.in_dim = int(self.features.shape[1])
        self.num_classes = int(spec.num_classes)
        self.lr = float(lr)
        self.fanouts = (int(fanouts[0]), int(fanouts[1]))
        self.pipeline = GraphPipeline(graph, spec, batch_size,
                                      fanouts=self.fanouts, seed=seed,
                                      device="cpu")
        self.bucket = default_buckets(
            self.fanouts, seed_levels=(batch_size,),
            max_inputs=graph.num_vertices)[0]
        self.cfg = _sage_cfg(hidden)
        self.pair_cap = self.bucket.num_edges // 4  # >= any block's pairs
        self.dedup_requested = dedup
        self.machine = get_machine(machine)
        if dedup == "auto":
            # price a REAL block's pair statistics at the bucket's shapes
            lay0 = self._block_layout(
                self._prepare(self.pipeline.batch_at(0)))
            dedup = choose_dedup(
                self.bucket.num_inputs, self.bucket.num_edges, self.in_dim,
                num_pairs=lay0.num_pairs, num_edges2=lay0.num_edges2,
                machine=self.machine)
        self.dedup = dedup
        self._template = _bucket_template_graph(
            self.bucket.num_inputs, self.bucket.num_edges,
            paired=dedup == "pairs", device=self.device)
        self._plan_kwargs = dict(backend=backend, fused=False,
                                 machine=self.machine, dedup=dedup)
        if dedup == "pairs":
            self._plan_kwargs["dedup_pad"] = (self.pair_cap,
                                              self.bucket.num_edges)
        self._rebuilds = 0
        self.plan = self._plan()
        self.model = GCNModel(
            self.cfg, self.in_dim, self.num_classes, device=self.device,
            generator=generator or torch.Generator().manual_seed(seed))
        #: compiled inference forward over the same bucket (``predict``)
        self.fwd = self.plan.compile(dynamic=True, donate=donate)
        #: the training step's traces: per input signature its
        #: ``_CapturedStep`` (None on the CPU, whose steps run eagerly);
        #: the features' buffer its graphs read
        self._steps: Dict = {}
        self._step_traces = 0
        self._x: Optional[torch.Tensor] = None
        self.losses: list = []
        self.last_pairs = 0   # matched pairs of the most recent block
        self.stage_ms: Dict[str, float] = {}

    @property
    def params(self) -> Dict:
        """The parameter tree ``{"conv0": {"lin": ...}, "conv1": ...}``."""
        return self.model.tree()

    # ------------------------------------------------------------- planning

    def _plan(self):
        """The bucket plan, through the global plan cache (each step
        re-resolves it here: a cache hit, never a rebuild)."""
        plan = build_plan(self._template, self.cfg, self.in_dim,
                          self.num_classes, device=self.device,
                          **self._plan_kwargs)
        if getattr(self, "plan", plan) is not plan:
            self._rebuilds += 1
        return plan

    @property
    def retraces(self) -> int:
        """Bucket-plan rebuilds after set-up, plus training-step traces
        beyond the first (the reference's ``retraces``: on a card step
        captures, on the CPU new step signatures), plus ``predict``
        captures beyond the first (0 = steady state)."""
        return self._rebuilds + max(0, self._step_traces - 1) + \
            max(0, self.fwd.num_traces - 1)

    # ---------------------------------------------------------- block prep

    def _prepare(self, batch) -> Dict:
        """Union the sampled hops and pad them into the bucket's static
        shapes on the host (sink no-ops: sink self-loop edges after the
        real ones, zero in-degrees; the features' pad rows are zero)."""
        frontier, ug, seed_pos = union_two_hop(
            batch["hop2"], batch["hop1"], batch["seeds"], device="cpu")
        b = self.bucket
        n, e = len(frontier), ug.num_edges
        if not b.fits(len(batch["seeds"]), n, e):
            raise RuntimeError("sampled block exceeds its worst-case bucket")
        sink = b.num_inputs - 1
        pad_e = b.num_edges - e
        src = np.concatenate([ug.src.numpy(), np.full(pad_e, sink, np.int32)])
        dst = np.concatenate([ug.dst.numpy(), np.full(pad_e, sink, np.int32)])
        in_deg = np.zeros(b.num_inputs, np.int32)
        in_deg[:n] = ug.in_deg.numpy()
        return {"frontier": frontier, "src": src, "dst": dst,
                "in_deg": in_deg, "edges": e, "seed_pos": seed_pos,
                "y": self.labels[np.asarray(batch["seeds"])]}

    def _block_layout(self, prep):
        """Host pair matching over the PADDED block, so the partial rows'
        offsets agree with the bucket's vertex count; the sink's pad edges
        are never matched (one destination shares their pair)."""
        return build_dedup_layout(prep["src"], prep["dst"],
                                  self.bucket.num_inputs, device="cpu")

    def _inputs(self, prep, *, backward: bool = True,
                x: Optional[torch.Tensor] = None):
        """(x, graph, graph layout, dedup layout) of a prepared block on
        the device, at the bucket's fixed shapes.  On the cuda tier the
        graph's blocked layout (else None) and the dedup layout's level 2
        are built on the host over the real edges at the fixed ``emax`` of
        ``tile * (f1 + f2)`` slots (a destination row of a union block has
        at most f1 + f2 edges) and, for a step (``backward``; ``predict``
        needs none), with their capped transposed layouts at the capacity
        of the bucket's edge count.  The pairs are padded to the bucket's
        pair capacity.  The features are gathered into ``x`` when given
        (the captured step's buffer), else into a new tensor."""
        t0 = time.perf_counter()
        b, dev = self.bucket, self.device
        cuda = self.plan.agg_tile > 0
        cap = sum(self.fanouts)
        g = Graph(src=_on(prep["src"], dev), dst=_on(prep["dst"], dev),
                  in_deg=_on(prep["in_deg"], dev),
                  out_deg=_on(prep["in_deg"], dev),
                  num_vertices=b.num_inputs)
        e = prep["edges"]
        glay = self.plan.runtime_layout(
            prep["src"][:e], prep["dst"][:e], max_in_deg=cap,
            transposed=backward) if cuda else None
        t1 = time.perf_counter()
        ded = None
        if self.dedup == "pairs":
            lay = self._block_layout(prep)
            self.last_pairs = lay.num_pairs
            arrays = pad_dedup_arrays(lay, self.pair_cap, b.num_edges,
                                      b.num_inputs - 1)
            # the pad pairs' partial rows are read by no level-2 edge, so
            # their gradients are zero rows: pad pair k gathers row k (mod
            # the bucket's rows) rather than the sink, so the gather's
            # backward (an accumulating index_put) adds each zero to a row
            # of its own instead of thousands onto the sink in series
            # (~96 ms a step on the H100, PERF.md section 6); the forward
            # is unchanged
            pad = np.arange(self.pair_cap - lay.num_pairs) % b.num_inputs
            for a in arrays[:2]:
                a[lay.num_pairs:] = pad
            pl, pr, s2, d2 = (_on(a, dev) for a in arrays)
            ded = self.plan.dedup_layout._replace(
                pair_left=pl, pair_right=pr, src2=s2, dst2=d2,
                num_pairs=self.pair_cap, blocked=None)
            if cuda:
                real = lay.num_edges2 - (b.num_edges - e)
                ded = ded._replace(blocked=self.plan.runtime_layout(
                    arrays[2][:real], arrays[3][:real],
                    num_rows=b.num_inputs + self.pair_cap, max_in_deg=cap,
                    transposed=backward))
        t2 = time.perf_counter()
        n = len(prep["frontier"])
        if x is None:
            x = torch.empty((b.num_inputs, self.in_dim),
                            dtype=torch.float32, device=dev)
        torch.index_select(self.features, 0,
                           _on(prep["frontier"], dev).long(), out=x[:n])
        x[n:].zero_()
        self.stage_ms.update(layouts=(t1 - t0) * 1e3,
                             dedup=(t2 - t1) * 1e3,
                             x=(time.perf_counter() - t2) * 1e3)
        return x, g, glay, ded

    def _targets(self, prep) -> Tuple[torch.Tensor, torch.Tensor]:
        """(seed positions, labels) of a prepared block on the device."""
        return (_on(prep["seed_pos"], self.device).long(),
                _on(prep["y"], self.device))

    def _loss_grads(self, forward, seed_pos, y):
        """The loss of ``forward(params)``'s logits at the seeds and the
        gradients of the parameters (in ``model.parameters()`` order)."""
        leaves = list(self.model.parameters())
        loss = _nll(forward(self.model.tree())[seed_pos], y)
        return loss, torch.autograd.grad(loss, leaves)

    def loss_and_grads(self, prep):
        """The eager step's loss of a prepared block and the gradients of
        the parameters (in ``model.parameters()`` order): what a captured
        step computes, before its update."""
        x, g, glay, ded = self._inputs(prep)
        return self._loss_grads(
            lambda p: self.plan.run_model(p, x, graph=g, graph_layout=glay,
                                          dedup_layout=ded),
            *self._targets(prep))

    # ------------------------------------------------------------- training

    def _run_step(self, prep) -> torch.Tensor:
        """The step over a prepared block: the loss, the parameters
        updated.  Its arrays go through the bucket forward's argument
        form (``CompiledPlan``), and each signature -- one per bucket --
        is traced once: on a card captured (``_CapturedStep``) and
        replayed after, its buffers taking each block's arrays; on the CPU
        run eagerly."""
        fwd = self.fwd
        leaves = list(self.model.parameters())
        x, g, glay, ded = self._inputs(prep, x=self._x)
        arrays, gmeta = fwd._graph_args(g, glay, True)
        dmeta = None
        if self.dedup == "pairs":
            more, dmeta = fwd._dedup_args(ded, True)
            arrays += more
        arrays += self._targets(prep)
        meta = (gmeta, dmeta)

        def body(ins):
            return self._loss_grads(
                lambda p: fwd._forward(p, x, *ins[:-2], meta=meta),
                *ins[-2:])
        sig = (CompiledPlan._signature([], (x,) + arrays), meta)
        if sig not in self._steps:
            self._step_traces += 1
            self._steps[sig] = None
            if self.device.type == "cuda":
                self._x = x
                statics = [a.clone() for a in arrays]
                self._steps[sig] = _CapturedStep(
                    lambda: body(statics), statics, leaves, self.lr,
                    self.device)
        cap = self._steps[sig]
        if cap is not None:
            return cap.replay(arrays)
        loss, grads = body(arrays)
        _sgd(leaves, grads, self.lr)
        return loss.detach()

    def step(self) -> float:
        """One SGD step on the pipeline's next block."""
        t0 = time.perf_counter()
        batch = self.pipeline.batch_at(self.pipeline.step)
        self.pipeline.step += 1
        t1 = time.perf_counter()
        prep = self._prepare(batch)
        t2 = time.perf_counter()
        self.plan = self._plan()
        value = float(self._run_step(prep))
        self.stage_ms.update(sample=(t1 - t0) * 1e3, union=(t2 - t1) * 1e3,
                             step=(time.perf_counter() - t0) * 1e3)
        self.losses.append(value)
        return value

    def train(self, steps: int, *, checkpointer=None,
              checkpoint_every: int = 0) -> list:
        """Run ``steps`` more steps; returns the full loss list.  With
        ``checkpointer`` and ``checkpoint_every=k`` it saves every k
        pipeline steps (restoring one and going on reproduces this run's
        remaining losses and final parameters bit for bit)."""
        for _ in range(int(steps)):
            self.step()
            if checkpointer is not None and checkpoint_every and \
                    self.pipeline.step % checkpoint_every == 0:
                self.save(checkpointer)
        return self.losses

    def predict(self, step: Optional[int] = None) -> np.ndarray:
        """Seed logits of the pipeline block at ``step`` (default: the
        next one) through the bucket's compiled forward
        (``plan.compile(dynamic=True, donate=)``)."""
        batch = self.pipeline.batch_at(
            self.pipeline.step if step is None else int(step))
        prep = self._prepare(batch)
        x, g, glay, ded = self._inputs(prep, backward=False)
        with torch.no_grad():
            out = self.fwd(self.params, x, g, dedup=ded, layout=glay)
        return out[_on(prep["seed_pos"], self.device).long()].cpu().numpy()

    # ---------------------------------------------------- checkpoint/resume

    def save(self, checkpointer, *, blocking: bool = True) -> None:
        """Snapshot (params, pipeline step, loss history) at the current
        pipeline step."""
        checkpointer.save(self.pipeline.step, {"params": self.params},
                          extra={"pipeline": self.pipeline.state_dict(),
                                 "losses": list(self.losses)},
                          blocking=blocking)

    def restore(self, checkpointer, step: Optional[int] = None) -> int:
        """Resume from a checkpoint: the restored parameters and pipeline
        counter regenerate the block stream an uninterrupted run sees."""
        state, at, extra = checkpointer.restore({"params": self.params},
                                                step=step)
        with torch.no_grad():
            for (_, p), (_, q) in zip(_leaves(self.params),
                                      _leaves(state["params"])):
                p.copy_(q)
        self.pipeline.load_state_dict(extra["pipeline"])
        self.losses = list(extra.get("losses", []))
        return at


def train_minibatch_planned(graph, spec: GraphSpec, features, labels, *,
                            steps: int = 20, **kw):
    """Bucketed minibatch training; returns (params, losses, trainer)."""
    trainer = PlannedSageTrainer(graph, spec, features, labels, **kw)
    trainer.train(steps)
    return trainer.params, trainer.losses, trainer
