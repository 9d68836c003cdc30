"""Minibatch GraphSAGE training against the JAX package
(``models/sage_minibatch.py``).

The bucketed ``PlannedSageTrainer`` mirrors ``tests/test_dedup.py``'s
trainer contract: the step-0 ``predict`` and the loss stream against the
reference trainer on the same graph, features, labels and parameters
(loaded through ``GCNModel.params_from_reference``), rtol 1e-4 / atol
1e-5, parameters at the f32 band times 10; pairs against none (forward bit
for bit, training within the band); one cached plan and no retrace in the
steady state; resume bit for bit.  The per-block demo
(``train_minibatch_sage``) mirrors ``tests/test_sage_vlm.py``.

The cuda tier's trainer path -- runtime layouts built on the host, K1's
backward over the transposed layout, the captured ``predict`` over
fixed-capacity layouts -- runs here with the tier's device check lifted
(``cuda_tier_on_cpu``), so each fold takes K1's plain version inside its
autograd Function; it is held against the torch tier.
"""

import jax
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA as JCORA
from repro.config import GraphSpec as JGraphSpec
from repro.config import reduced_graph as jreduced
from repro.graph.datasets import make_features as jfeatures
from repro.graph.datasets import make_labels as jlabels
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.graph.sampling import two_hop_batch as jtwo_hop
from repro.graph.structure import graph_from_coo as jcoo
from repro.models import sage_minibatch as jsm
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config import CORA, GraphSpec, reduced_graph
from repro_torch.core import plan as tplan
from repro_torch.core.dataflow import block_graph_arrays
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.graph.sampling import two_hop_batch
from repro_torch.graph.structure import graph_from_coo
from repro_torch.kernels import ops
from repro_torch.kernels import seg_agg as k1
from repro_torch.models.sage_minibatch import (PlannedSageTrainer,
                                               SageMiniBatchModel, _nll, _sgd,
                                               train_minibatch_planned,
                                               train_minibatch_sage)

torch.set_num_threads(2)

KW = dict(batch_size=4, fanouts=(2, 2), seed=0, machine="h100")


def _hub_edges(v=300, num_hubs=12, seed=0):
    """Every vertex draws exactly two hub in-neighbours (the fixture of
    ``tests/test_dedup.py``: many destinations share a leading pair)."""
    rng = np.random.default_rng(seed)
    pairs = np.array([(a, b) for a in range(num_hubs)
                      for b in range(a + 1, num_hubs)])
    sel = pairs[rng.integers(0, len(pairs), v)]
    return sel.reshape(-1), np.repeat(np.arange(v), 2)


@pytest.fixture(scope="module")
def fixture():
    v, f, c = 300, 10, 5
    src, dst = _hub_edges(v)
    jg = jcoo(src, dst, v)
    tg = graph_from_coo(src, dst, v, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((v, f)).astype(np.float32)
    y = rng.integers(0, c, v)
    jspec = JGraphSpec(name="t", num_vertices=v, feature_len=f,
                       num_edges=len(src), num_classes=c)
    tspec = GraphSpec(name="t", num_vertices=v, feature_len=f,
                      num_edges=len(src), num_classes=c)
    return jg, tg, jspec, tspec, x, y


@pytest.fixture
def cuda_tier_on_cpu(monkeypatch):
    """Plans may take the cuda tier over CPU tensors, whose folds then run
    K1's plain version inside its autograd Function."""
    def check(backend, x):
        assert backend in ("torch", "cuda")
    monkeypatch.setattr(ops, "_check_tier", check)
    monkeypatch.setattr(tplan, "require_device", lambda backend, dev: None)


def _pair(fixture, dedup, **kw):
    jg, tg, jspec, tspec, x, y = fixture
    jt = jsm.PlannedSageTrainer(jg, jspec, x, y, dedup=dedup, **KW)
    tt = PlannedSageTrainer(tg, tspec, x, y, dedup=dedup, device="cpu",
                            **KW, **kw)
    tt.model.params_from_reference(jax.tree.map(np.asarray, jt.params))
    return jt, tt


def _params_close(jparams, tparams, **kw):
    flat = {f"{c}.{d}.{k}": v for c, sub in jparams.items()
            for d, leaf in sub.items() for k, v in leaf.items()}
    mine = {".".join(p): t for p, t in tplan._leaves(tparams)}
    assert sorted(flat) == sorted(mine)
    for name, value in flat.items():
        assert_allclose_dtype(mine[name].detach().numpy(), np.asarray(value),
                              **kw)


@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_trainer_matches_reference(fixture, dedup):
    """Step-0 predict, a 3-step loss stream and the parameters against the
    reference trainer."""
    jt, tt = _pair(fixture, dedup)
    assert tt.bucket == tuple(jt.bucket) and tt.pair_cap == jt.pair_cap
    assert_allclose_dtype(tt.predict(step=0), np.asarray(jt.predict(step=0)))
    np.testing.assert_allclose(tt.train(3), jt.train(3), rtol=1e-4,
                               atol=1e-5)
    _params_close(jt.params, tt.params, scale=10)
    assert tt.last_pairs == jt.last_pairs


@pytest.mark.parametrize("machine", ["h100", "a100", "tpu-v5e"])
def test_auto_dedup_resolves_as_reference(fixture, machine):
    jg, tg, jspec, tspec, x, y = fixture
    kw = dict(KW, machine=machine)
    jt = jsm.PlannedSageTrainer(jg, jspec, x, y, dedup="auto", **kw)
    tt = PlannedSageTrainer(tg, tspec, x, y, dedup="auto", device="cpu",
                            **kw)
    assert tt.dedup == jt.dedup and tt.dedup_requested == "auto"


def test_trainer_steady_state_one_plan_zero_retraces(fixture):
    """One cached plan across the run: plan-cache hits grow per step,
    misses do not; no retrace, and predict captures once."""
    _, tg, _, tspec, x, y = fixture
    tr = PlannedSageTrainer(tg, tspec, x, y, dedup="pairs", device="cpu",
                            **KW)
    s0 = tplan.plan_cache_stats()
    tr.train(5)
    s1 = tplan.plan_cache_stats()
    assert s1["hits"] - s0["hits"] >= 5
    assert s1["misses"] == s0["misses"]
    assert tr._plan() is tr._plan() is tr.plan
    tr.predict()
    tr.predict(step=1)
    assert (tr.fwd.num_traces, tr.fwd.num_replays) == (1, 1)
    assert tr.retraces == 0
    assert len(tr.losses) == 5 and all(np.isfinite(tr.losses))
    assert tr.last_pairs > 0
    assert set(tr.stage_ms) == {"sample", "union", "layouts", "dedup", "x",
                                "step"}


def test_trainer_forward_bitwise_and_training_banded(fixture):
    """dedup='pairs' against 'none': the same forward bits; training
    within the f32 band."""
    _, tg, _, tspec, x, y = fixture
    tp = PlannedSageTrainer(tg, tspec, x, y, dedup="pairs", device="cpu",
                            **KW)
    tn = PlannedSageTrainer(tg, tspec, x, y, dedup="none", device="cpu",
                            **KW)
    assert_allclose_dtype(tp.predict(step=0), tn.predict(step=0),
                          bitwise=True)
    np.testing.assert_allclose(tp.train(4), tn.train(4), rtol=1e-4,
                               atol=1e-5)
    for (_, a), (_, b) in zip(tplan._leaves(tp.params),
                              tplan._leaves(tn.params)):
        assert_allclose_dtype(a.detach().numpy(), b.detach().numpy(),
                              scale=10)


@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_trainer_deterministic_resume(fixture, tmp_path, dedup):
    """Resume at step 3 through the Checkpointer reproduces the
    uninterrupted run: the same losses and parameters, bit for bit."""
    _, tg, _, tspec, x, y = fixture
    kw = dict(KW, dedup=dedup, device="cpu")
    straight = PlannedSageTrainer(tg, tspec, x, y, **kw)
    straight.train(6)
    ck = Checkpointer(str(tmp_path / "ck"))
    a = PlannedSageTrainer(tg, tspec, x, y, **kw)
    a.train(3)
    a.save(ck, blocking=True)
    b = PlannedSageTrainer(tg, tspec, x, y, **kw)
    assert b.restore(ck) == 3 and b.pipeline.step == 3
    b.train(3)
    assert b.losses == straight.losses
    for (_, p), (_, q) in zip(tplan._leaves(b.params),
                              tplan._leaves(straight.params)):
        assert torch.equal(p, q)
    assert b.retraces == 0


@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_cuda_tier_trainer_equals_torch_tier(fixture, cuda_tier_on_cpu,
                                             monkeypatch, dedup):
    """The cuda tier's trainer path (runtime layouts, K1's Function both
    ways) against the torch tier: losses and parameters within the f32
    band, predict's capture over fixed-capacity layouts equal to the eager
    forward over them.  K1 folds once a layer forward, and twice more
    backward for each layer whose operand needs a gradient: the pieces of
    the capped transposed layout at the bucket's capacity, then its
    fold-back, there whether or not a row was cut."""
    _, tg, _, tspec, x, y = fixture
    folds = {"n": 0}
    fold = k1._fold

    def spy(*args, **kw):
        folds["n"] += 1
        return fold(*args, **kw)
    monkeypatch.setattr(k1, "_fold", spy)
    tc = PlannedSageTrainer(tg, tspec, x, y, dedup=dedup, device="cpu",
                            backend="cuda", **KW)
    tt = PlannedSageTrainer(tg, tspec, x, y, dedup=dedup, device="cpu",
                            **KW)
    assert tc.plan.agg_tile > 0 and tt.plan.agg_tile == 0
    assert_allclose_dtype(tc.predict(step=0), tt.predict(step=0))
    folds["n"] = 0
    lc, lt = tc.train(3), tt.train(3)
    np.testing.assert_allclose(lc, lt, rtol=1e-4, atol=1e-5)
    for (_, a), (_, b) in zip(tplan._leaves(tc.params),
                              tplan._leaves(tt.params)):
        assert_allclose_dtype(a.detach().numpy(), b.detach().numpy())
    orders = [lp.order for lp in tc.plan.layers]
    per_step = 2 + 2 * sum(i > 0 or o == "combine_first"
                           for i, o in enumerate(orders))
    assert folds["n"] == 3 * per_step
    # predict: the fixed-capacity layouts, one capture, eager bits
    prep = tc._prepare(tc.pipeline.batch_at(4))
    xx, g, glay, ded = tc._inputs(prep, backward=False)
    assert glay.emax == -(-tc.plan.agg_tile * 4 // 8) * 8
    assert glay.transposed is None
    with torch.no_grad():
        eager = tc.plan.run_model(tc.params, xx, graph=g, graph_layout=glay,
                                  dedup_layout=ded)
    got = tc.predict(step=4)
    assert np.array_equal(got, eager[torch.from_numpy(
        prep["seed_pos"]).long()].numpy())
    tc.predict(step=5)
    assert (tc.fwd.num_traces, tc.fwd.num_replays) == (1, 2)


def test_train_minibatch_planned(fixture):
    _, tg, _, tspec, x, y = fixture
    params, losses, tr = train_minibatch_planned(tg, tspec, x, y, steps=2,
                                                 dedup="none", device="cpu",
                                                 **KW)
    assert len(losses) == 2 and params.keys() == {"conv0", "conv1"}
    assert tr.retraces == 0


# ---------------------------------------------------------------------------
# the per-block demo (tests/test_sage_vlm.py:33-56)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cora():
    jspec = jreduced(JCORA, 256, 32)
    tspec = reduced_graph(CORA, 256, 32)
    x = np.asarray(jfeatures(jspec)).copy()
    y = np.asarray(jlabels(jspec))
    # plant signal so the loss can go down
    x[:, :jspec.num_classes] += 3.0 * np.eye(jspec.num_classes)[y]
    return jspec, tspec, jgraph(jspec), tgraph(tspec, device="cpu"), x, y


def test_minibatch_shapes_and_orderings(cora):
    jspec, tspec, jg, tg, x, y = cora
    seeds = np.arange(16, dtype=np.int32)
    hop2, hop1 = two_hop_batch(tg, seeds, (4, 4), seed=0, device="cpu")
    m = SageMiniBatchModel(tspec.feature_len, 128, tspec.num_classes,
                           device="cpu")
    logits = m.apply(m.init(), hop2, hop1,
                     torch.from_numpy(x[hop2.input_ids]))
    assert logits.shape == (16, tspec.num_classes)
    # layer 1 expands 32 -> 128: aggregate first; layer 2 shrinks 128 -> 7:
    # combine first -- the scheduler re-decides per block
    assert m.orderings(hop2, hop1) == ("aggregate_first", "combine_first")


def test_minibatch_apply_and_grad_match_reference(cora):
    """The per-block model's logits and gradients against the reference's
    on the same block and parameters."""
    jspec, tspec, jg, tg, x, y = cora
    seeds = np.arange(0, 200, 9, dtype=np.int32)
    jh2, jh1 = jtwo_hop(jg, seeds, (4, 3), seed=2)
    th2, th1 = two_hop_batch(tg, seeds, (4, 3), seed=2, device="cpu")
    jm = jsm.SageMiniBatchModel(jspec.feature_len, 128, jspec.num_classes)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = SageMiniBatchModel(tspec.feature_len, 128, tspec.num_classes,
                            device="cpu")
    tp = tm.load_reference(jax.tree.map(np.asarray, jp))
    xin = x[jh2.input_ids]
    assert_allclose_dtype(
        tm.apply(tp, th2, th1, torch.from_numpy(xin)).detach().numpy(),
        np.asarray(jm.apply(jp, jh2, jh1, xin)))
    ys = y[seeds]
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jh2, jh1, xin, ys)
    leaves = [t for _, t in tplan._leaves(tp)]
    loss = tm.loss(tp, th2, th1, torch.from_numpy(xin), torch.from_numpy(ys))
    grads = dict(zip((".".join(p) for p, _ in tplan._leaves(tp)),
                     torch.autograd.grad(loss, leaves)))
    assert_allclose_dtype(loss.item(), float(jloss))
    for layer, sub in jgrads.items():
        for k, v in sub["lin"].items():
            assert_allclose_dtype(grads[f"{layer}.lin.{k}"].numpy(),
                                  np.asarray(v), scale=10)


def test_minibatch_training_matches_reference_and_reduces_loss(cora):
    """The loss stream of ``train_minibatch_sage`` from the reference's
    initial parameters follows the reference's (6 steps: the reference
    compiles a plan per block), and over 25 steps the loss goes down, from
    those parameters and from the port's own."""
    jspec, tspec, jg, tg, x, y = cora
    kw = dict(batch_size=48, lr=0.15)
    _, jlosses, _ = jsm.train_minibatch_sage(jg, jspec, x, y, steps=6, **kw)
    init = jax.tree.map(np.asarray, jsm.SageMiniBatchModel(
        jspec.feature_len, 128, jspec.num_classes).init(
        jax.random.PRNGKey(0)))
    _, losses, _ = train_minibatch_sage(tg, tspec, x, y, steps=25,
                                        device="cpu", params=init, **kw)
    np.testing.assert_allclose(losses[:6], jlosses, rtol=1e-4, atol=1e-5)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    _, own, _ = train_minibatch_sage(tg, tspec, x, y, steps=25,
                                     device="cpu", **kw)
    assert np.mean(own[-5:]) < np.mean(own[:5])


# ---------------------------------------------------------------------------
# the captured step's inputs: capped transposed layouts at the bucket's
# capacity, K1's backward over them, the step's trace count
# ---------------------------------------------------------------------------

#: TRANSPOSE_CAP as shipped, and cut at 8 slots so that the test blocks'
#: hub sources are cut and fold back from scratch rows
CAPS = [None, 8]
#: blocks wide enough for a hub source to have more than 8 out-edges
WIDE = dict(KW, batch_size=32, fanouts=(3, 3))


def _cut_at(monkeypatch, cap):
    if cap is not None:
        monkeypatch.setattr(tplan, "TRANSPOSE_CAP", cap)


def _step_layouts(tr, steps):
    """Each block's forward and transposed layouts as a step takes them
    (the graph's, then a pairs plan's level 2)."""
    out = []
    for s in steps:
        _, _, glay, ded = tr._inputs(tr._prepare(tr.pipeline.batch_at(s)))
        out.append([glay] + ([] if ded is None else [ded.blocked]))
    return out


def _arrays(lay):
    t, f = lay.transposed, lay.transposed.fold
    return [lay.src, lay.dstl, lay.mask, t.src, t.dstl, t.mask, t.eidx,
            t.out_rows, f.src, f.dstl, f.mask, f.out_rows]


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_capacity_transposed_layouts_have_equal_shapes(
        fixture, cuda_tier_on_cpu, monkeypatch, dedup, cap):
    """The step's layouts of several sampled blocks: every tensor of the
    forward layout, its capped transposed layout and the fold-back (there
    for every block, cut row or not) has the same shape and dtype in
    every block, and the counts a layout is rebuilt from (rows, scratch
    rows) agree; each transposed layout holds each real edge once."""
    _cut_at(monkeypatch, cap)
    _, tg, _, tspec, x, y = fixture
    tr = PlannedSageTrainer(tg, tspec, x, y, dedup=dedup, device="cpu",
                            backend="cuda", **WIDE)
    blocks = _step_layouts(tr, range(6))
    first = blocks[0]
    cut = False
    for lays in blocks:
        assert len(lays) == len(first)
        for lay, ref in zip(lays, first):
            assert [(a.shape, a.dtype) for a in _arrays(lay)] == \
                [(a.shape, a.dtype) for a in _arrays(ref)]
            t = lay.transposed
            assert (t.num_vertices, t.fold.num_vertices, t.emax) == \
                (ref.transposed.num_vertices, ref.transposed.fold
                 .num_vertices, tplan.TRANSPOSE_CAP)
            assert int(t.mask.sum()) == int(lay.mask.sum())
            cut |= bool((t.fold.out_rows >= 0).any())
    assert cut == (cap is not None)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_k1_backward_at_capacity_equals_uncapped(fixture, cuda_tier_on_cpu,
                                                 monkeypatch, dedup, cap):
    """K1's plain backward over each block's capacity layout (the pieces,
    then the fold-back) against the uncapped transposed layout of the same
    edges: bit for bit when no row is cut (each row one in-order fold),
    within the f32 band when rows over the cap fold back from pieces."""
    _cut_at(monkeypatch, cap)
    _, tg, _, tspec, x, y = fixture
    tr = PlannedSageTrainer(tg, tspec, x, y, dedup=dedup, device="cpu",
                            backend="cuda", **WIDE)
    rng = np.random.default_rng(11)
    for lays in _step_layouts(tr, range(4)):
        for lay in lays:
            t = lay.transposed
            m = lay.mask.numpy() != 0
            b, j = np.nonzero(m)
            src = lay.src.numpy()[b, j]
            dst = b * lay.tile_m + lay.dstl.numpy()[b, j]
            uncapped = block_graph_arrays(
                src, dst, lay.num_vertices, lay.tile_m,
                transpose_rows=t.num_vertices).transposed
            g = torch.from_numpy(rng.standard_normal(
                (lay.nblocks * lay.tile_m, 6)).astype(np.float32))
            got = ops.seg_agg_transposed(t, g, backend="torch")
            want = ops.seg_agg_transposed(uncapped, g, backend="torch")
            assert got.shape == want.shape
            if cap is None:
                assert torch.equal(got, want)
            else:
                assert_allclose_dtype(got.numpy(), want.numpy())


@pytest.mark.parametrize("cap", CAPS)
def test_capacity_layout_raises_past_its_edges(monkeypatch, cap):
    """A transposed layout at a capacity smaller than its edges raises;
    at the capacity of its own edges it holds them."""
    src, dst = _hub_edges(60)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    c = cap or tplan.TRANSPOSE_CAP
    lay = block_graph_arrays(src, dst, 60, 8, transpose_rows=60,
                             transpose_cap=c, max_edges=len(src))
    assert int(lay.transposed.mask.sum()) == len(src)
    with pytest.raises(ValueError, match="capacity"):
        block_graph_arrays(src, dst, 60, 8, transpose_rows=60,
                           transpose_cap=c, max_edges=len(src) - 1)


@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_trainer_step_equals_eager_step_and_never_retraces(
        fixture, cuda_tier_on_cpu, dedup):
    """The trainer's steps on the cuda tier's path -- through the bucket
    forward's argument form, one trace for the bucket -- against the eager
    step (``loss_and_grads``, ``_sgd``) from the same state on the same
    blocks: losses and parameters bit for bit; ``retraces`` stays 0."""
    _, tg, _, tspec, x, y = fixture
    kw = dict(KW, dedup=dedup, device="cpu", backend="cuda")
    tr = PlannedSageTrainer(tg, tspec, x, y, **kw)
    ref = PlannedSageTrainer(tg, tspec, x, y, **kw)
    for step in range(4):
        got = tr.step()
        loss, grads = ref.loss_and_grads(
            ref._prepare(ref.pipeline.batch_at(step)))
        _sgd(list(ref.model.parameters()), grads, ref.lr)
        assert got == float(loss.detach())
        for p, q in zip(tr.model.parameters(), ref.model.parameters()):
            assert torch.equal(p, q)
    assert tr._step_traces == 1 and tr.retraces == 0


@pytest.mark.parametrize("dedup", ["none", "pairs"])
def test_dynamic_compile_under_grad_takes_capacity_layouts(
        fixture, cuda_tier_on_cpu, dedup):
    """``compile(dynamic=True)`` under autograd on the cuda tier's path:
    the gradients over a block's capacity layouts (transposed ones
    included) equal the eager forward's bit for bit, each block one
    signature; a layout without its transposed layout raises."""
    _, tg, _, tspec, x, y = fixture
    tr = PlannedSageTrainer(tg, tspec, x, y, dedup=dedup, device="cpu",
                            backend="cuda", **KW)
    fn = tplan.CompiledPlan(tr.plan, dynamic=True)
    leaves = list(tr.model.parameters())
    for step in range(3):
        prep = tr._prepare(tr.pipeline.batch_at(step))
        xx, g, glay, ded = tr._inputs(prep)
        pos, lab = tr._targets(prep)
        eager = torch.autograd.grad(_nll(tr.plan.run_model(
            tr.params, xx, graph=g, graph_layout=glay,
            dedup_layout=ded)[pos], lab), leaves)
        got = torch.autograd.grad(_nll(fn(tr.params, xx, g, dedup=ded,
                                          layout=glay)[pos], lab), leaves)
        assert all(torch.equal(a, b) for a, b in zip(got, eager))
    assert (fn.num_traces, fn.num_replays) == (1, 2)
    _, _, bare, ded = tr._inputs(prep, backward=False)
    with pytest.raises(ValueError, match="transposed layout"):
        fn(tr.params, xx, g, dedup=ded, layout=bare)


@pytest.mark.parametrize("n,top", [(0, 1), (7, 3), (5000, 40), (3, 1 << 61)])
def test_stable_order_is_a_stable_argsort(n, top):
    """The capped builder's source order (``core.dataflow._stable_order``)
    is numpy's stable argsort: equal keys keep their edges' order, also
    past the range its packed keys take."""
    from repro_torch.core.dataflow import _stable_order
    keys = np.random.default_rng(n).integers(0, top, n)
    assert np.array_equal(_stable_order(keys),
                          np.argsort(keys, kind="stable"))
