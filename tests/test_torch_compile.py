"""Compiled execution against the JAX package: ``plan.compile()``.

On the CPU a ``CompiledPlan`` runs the eager forward under the capture
contract (one trace per input signature, a retrace guard, caching per
(donate, layer, dynamic)); on a card the same contract holds with a CUDA
graph (``tests/test_torch_cuda.py``).  Every comparison with the reference
is with its EAGER single-device output, within the f32 band of
``tests/tolerance.py``: the reference's own compiled contract does not hold
bit for bit on this tree.  Inside the port, eager and compiled are equal
bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.config import CORA, reduced_graph
from repro.core.plan import build_plan as jbuild_plan
from repro.graph.datasets import make_features as jfeatures
from repro.graph.datasets import make_synthetic_graph as jgraph
from repro.models.gcn import PAPER_MODELS as JMODELS
from repro.models.gcn import GCNModel as JGCNModel
from repro_torch import config as tconfig
from repro_torch.core import plan as tplan
from repro_torch.graph.datasets import make_features as tfeatures
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.models.gcn import PAPER_MODELS, GCNModel, make_paper_model
from repro_torch.profile.machine import H100

torch.set_num_threads(2)

JSPEC = reduced_graph(CORA, 512, 64)
TSPEC = tconfig.reduced_graph(tconfig.CORA, 512, 64)
JG, TG = jgraph(JSPEC), tgraph(TSPEC, device="cpu")
JX, TX = jfeatures(JSPEC), tfeatures(TSPEC, device="cpu")
#: a second graph of the same V and E (another seed): the dynamic mode's
#: substitute
JG2, TG2 = jgraph(JSPEC, seed=7), tgraph(TSPEC, seed=7, device="cpu")
ORDERS = ["combine_first", "aggregate_first", "auto"]
CALLS = 4


def _models(name, seed=3):
    jm = JGCNModel(JMODELS[name], JSPEC.feature_len, JSPEC.num_classes)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GCNModel(PAPER_MODELS[name], TSPEC.feature_len, TSPEC.num_classes,
                  device="cpu")
    tm.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
    return params, tm


def _jplan(name, **kw):
    return jbuild_plan(JG, JMODELS[name], JSPEC.feature_len,
                       JSPEC.num_classes, backend="xla", machine="h100", **kw)


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("order", ORDERS)
def test_compiled_matches_reference_eager(name, fused, order):
    """compile() within the f32 band of the reference's eager forward, bit
    for bit the port's eager forward on every call, one trace."""
    params, tm = _models(name)
    plan = tm.plan_for(TG, fused=fused, ordering=order)
    want = np.asarray(_jplan(name, fused=fused, ordering=order)
                      .run_model(params, JX))
    with torch.no_grad():
        eager = plan.run_model(tm.tree(), TX)
    fn = plan.compile()
    for _ in range(CALLS):
        got = fn(tm.tree(), TX)
        assert torch.equal(got, eager)
        assert_allclose_dtype(got.detach().numpy(), want)
    assert (fn.num_traces, fn.num_replays) == (1, CALLS - 1)
    assert fn.capture_launches == {}      # nothing is captured on the CPU


def test_compile_is_cached_per_key():
    plan = make_paper_model("gcn", TSPEC, device="cpu").plan_for(TG)
    assert plan.compile() is plan.compile()
    assert plan.compile(layer=0) is plan.compile(layer=0)
    assert plan.compile(layer=0) is not plan.compile()
    assert plan.compile(donate=True) is not plan.compile()
    assert plan.compile(dynamic=True) is plan.compile(dynamic=True)
    assert plan.compile(dynamic=True) is not plan.compile()


def test_retrace_guard_fires_when_capture_cache_cleared():
    """The guard is not vacuous: dropping the per-signature captures (the
    stand-in for anything that busts the cache) makes the next call trace
    a signature already seen, which raises (``tests/test_compile.py``)."""
    m = make_paper_model("gcn", TSPEC, device="cpu")
    plan = m.plan_for(TG)
    fn = tplan.CompiledPlan(plan)           # fresh, bypasses the plan cache
    fn(m.tree(), TX)
    fn._traces.clear()
    with pytest.raises(RuntimeError, match="retraced"):
        fn(m.tree(), TX)
    assert fn.num_traces == 2


@pytest.mark.parametrize("name", ["gcn", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_layer_compile_matches_run_layer(name, fused):
    params, tm = _models(name)
    plan = tm.plan_for(TG, fused=fused)
    tree = tm.tree()
    h = TX
    for i in range(plan.num_layers):
        fl = plan.compile(layer=i)
        with torch.no_grad():
            want = plan.run_layer(tree[f"conv{i}"], h, layer=i)
        for _ in range(2):
            assert torch.equal(fl(tree[f"conv{i}"], h), want)
        assert (fl.num_traces, fl.num_replays) == (1, 1)
        h = torch.relu(want)
    with torch.no_grad():
        assert torch.equal(h, torch.relu(plan.run_model(tree, TX)))


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
def test_dynamic_substitute_graph(name):
    """compile(dynamic=True): the graph is a runtime argument.  A second
    graph of the same V and E runs with no new trace and matches the port's
    eager forward over it bit for bit and the reference's eager forward
    over it within the band; the template graph still gives its own
    result."""
    params, tm = _models(name)
    plan = tm.plan_for(TG, fused=False)
    fn = plan.compile(dynamic=True)
    tree = tm.tree()
    want2 = np.asarray(_jplan(name, fused=False).run_model(params, JX,
                                                           graph=JG2))
    with torch.no_grad():
        eager1 = plan.run_model(tree, TX)
        eager2 = plan.run_model(tree, TX, graph=TG2)
        assert torch.equal(fn(tree, TX, TG), eager1)
        got2 = fn(tree, TX, TG2)
        assert torch.equal(got2, eager2)
        assert_allclose_dtype(got2.numpy(), want2)
        assert not torch.equal(got2, eager1)
        assert torch.equal(plan.run_model(tree, TX, compiled=True,
                                          graph=TG2), eager2)
    assert (fn.num_traces, fn.num_replays) == (1, 2)


def test_dynamic_refuses_other_shapes_and_layouts():
    m = make_paper_model("gcn", TSPEC, device="cpu")
    fn = m.plan_for(TG, fused=False).compile(dynamic=True)
    other = tgraph(tconfig.reduced_graph(tconfig.CORA, 400, 64), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        fn(m.tree(), TX, other)
    with pytest.raises(ValueError, match="take"):
        fn(m.tree(), TX)
    with pytest.raises(ValueError, match="blocked layout"):
        m.plan_for(TG, fused=True).compile(dynamic=True)
    with pytest.raises(ValueError, match="blocked layout"):
        m.plan_for(TG, fused=True).run_model(m.tree(), TX, graph=TG2)
    # a cuda-tier plan (planned over CPU tensors; planning launches
    # nothing) compiles, and a runtime graph must bring its blocked layout
    lp = tplan._plan_layer(TG, 0, "gcn", (TSPEC.feature_len, 7),
                           agg_op="mean", ordering="auto", backend="cuda",
                           fused=False)
    cuda_plan = tplan.GraphExecutionPlan(TG, [lp], machine=H100)
    with pytest.raises(ValueError, match="blocked layout"):
        cuda_plan.compile(dynamic=True)(m.tree(), TX, TG2)


def test_new_parameter_values_take_effect():
    """A compiled call with other parameter values of the same shapes uses
    them, with no new trace (the graph copies them into its buffers)."""
    m = make_paper_model("sage", TSPEC, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    plan = m.plan_for(TG)
    fn = plan.compile()
    first = fn(m.tree(), TX)
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(-0.5).add_(0.01)
        want = plan.run_model(m.tree(), TX)
    got = fn(m.tree(), TX)
    assert torch.equal(got, want) and not torch.equal(got, first)
    assert fn.num_traces == 1


def test_donate_returns_results_the_caller_gives_up():
    """donate=True is its own cached callable with the same results; on
    the CPU each call still returns a fresh tensor (on a card it returns
    the graph's output buffer, see tests/test_torch_cuda.py)."""
    m = make_paper_model("gin", TSPEC, device="cpu")
    plan = m.plan_for(TG)
    fd = plan.compile(donate=True)
    assert fd.donate and not plan.compile().donate
    a, b = fd(m.tree(), TX), fd(m.tree(), TX)
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert torch.equal(a, plan.compile()(m.tree(), TX))


def test_compiled_sugar_and_probe_refusal():
    m = make_paper_model("gcn", TSPEC, device="cpu")
    plan = m.plan_for(TG)
    with torch.no_grad():
        eager = plan.run_model(m.tree(), TX)
    assert torch.equal(plan.run_model(m.tree(), TX, compiled=True), eager)
    assert plan.compile().num_traces == 1
    with pytest.raises(ValueError, match="eager phase"):
        plan.run_model(m.tree(), TX, compiled=True, _probe=object())


def test_compile_unsupported_without_layout():
    """A hand-built cuda layer without its plan-owned layout is reported
    compiled=False and refused by compile()."""
    from dataclasses import replace
    lp = tplan._plan_layer(TG, 0, "gcn", (TSPEC.feature_len, 7),
                           agg_op="mean", ordering="auto", backend="cuda",
                           fused=False)
    good = tplan.GraphExecutionPlan(TG, [lp], machine=H100)
    assert good.compile_supported and good.describe()[0]["compiled"]
    bad = tplan.GraphExecutionPlan(TG, [replace(lp, agg_layout=None)],
                                   machine=H100)
    assert not bad.compile_supported
    assert bad.describe()[0]["compiled"] is False
    with pytest.raises(ValueError, match="blocked layout"):
        bad.compile()


@pytest.mark.parametrize("name", ["gcn", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_describe_layer_keys_match_reference(name, fused):
    """The layer keys the golden report schema requires, as the reference
    states them for the same local f32 plan; ``interpret`` is the port's
    own (it has no interpret mode, where the reference's CPU plans
    interpret their Pallas kernels)."""
    jrows = _jplan(name, fused=fused).describe()
    trows = make_paper_model(name, TSPEC, device="cpu",
                             fused=fused).plan_for(TG).describe()
    keys = ("compiled", "distributed", "partition", "overlap", "dtype",
            "reorder", "dedup")
    for t, j in zip(trows, jrows):
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
        assert t["interpret"] is False


# ---------------------------------------------------------------------------
# training: the gradient flows through the compiled callable
# ---------------------------------------------------------------------------

#: the reference's grad-through-compile test graph (``tests/test_compile.py``
#: fixture ``data``)
JSPEC_S = reduced_graph(CORA, 220, 24)
TSPEC_S = tconfig.reduced_graph(tconfig.CORA, 220, 24)
JG_S, TG_S = jgraph(JSPEC_S), tgraph(TSPEC_S, device="cpu")
JX_S, TX_S = jfeatures(JSPEC_S), tfeatures(TSPEC_S, device="cpu")
LABELS_S = np.random.default_rng(0).integers(0, JSPEC_S.num_classes,
                                             JSPEC_S.num_vertices)


@pytest.fixture
def one_thread():
    """The torch tier's CPU scatter-adds (the backward of its gathers) add
    in a thread-dependent order; one thread makes two eager backward
    passes, and so compiled and eager, equal bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nll(logits, labels):
    return -torch.log_softmax(logits, dim=-1).gather(
        -1, labels[:, None])[:, 0].mean()


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("fused", [False, True])
def test_grad_through_compile_training_step(one_thread, name, fused):
    """The reference's ``test_grad_through_compile_training_step``: a loss
    through ``plan.compile()`` is differentiable (the compiled logits need
    a gradient -- before the repair they did not), its gradients equal
    eager autograd's bit for bit on every call and the reference's
    ``jax.grad`` of its eager forward within its own rtol 1e-4 / atol
    1e-6, and one SGD step lowers the loss."""
    jm = JGCNModel(JMODELS[name], JSPEC_S.feature_len, JSPEC_S.num_classes)
    params = jm.init(jax.random.PRNGKey(3))
    tm = GCNModel(PAPER_MODELS[name], TSPEC_S.feature_len,
                  TSPEC_S.num_classes, device="cpu")
    tm.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
    jplan = jbuild_plan(JG_S, JMODELS[name], JSPEC_S.feature_len,
                        JSPEC_S.num_classes, backend="xla", machine="h100",
                        fused=fused)
    jlabels = jax.numpy.asarray(LABELS_S)

    def loss_e(pp):
        ll = jax.nn.log_softmax(jplan.run_model(pp, JX_S), axis=-1)
        return -jax.numpy.take_along_axis(ll, jlabels[:, None],
                                          axis=-1).mean()

    jgrads = dict(tplan._leaves(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss_e)(params))))
    labels = torch.from_numpy(LABELS_S)
    plan = tm.plan_for(TG_S, fused=fused)
    leaves = tplan._leaves(tm.tree())
    tensors = [t for _, t in leaves]
    eager_loss = _nll(plan.run_model(tm.tree(), TX_S), labels)
    eager = torch.autograd.grad(eager_loss, tensors)
    fn = plan.compile()
    for _ in range(3):
        logits = fn(tm.tree(), TX_S)
        assert logits.requires_grad
        loss = _nll(logits, labels)
        grads = torch.autograd.grad(loss, tensors)
        assert torch.equal(loss, eager_loss)
        assert all(torch.equal(a, b) for a, b in zip(grads, eager))
    assert (fn.num_traces, fn.num_replays) == (1, 2)
    for (path, _), gr in zip(leaves, grads):
        assert bool(torch.isfinite(gr).all())
        np.testing.assert_allclose(gr.numpy(), jgrads[path], rtol=1e-4,
                                   atol=1e-6)
    # the reference's step of 0.5; GIN sums its neighbours unnormalised,
    # so its gradients are larger and that step overshoots
    lr = 0.05 if name == "gin" else 0.5
    with torch.no_grad():
        for t, gr in zip(tensors, grads):
            t.sub_(lr * gr)
        assert float(_nll(fn(tm.tree(), TX_S), labels)) < float(loss)


def test_grad_and_inference_signatures_are_separate_traces():
    """Whether a gradient is wanted joins the signature: a call under
    no_grad and one under autograd are two traces, each replayed after,
    and the retrace guard still fires on a dropped trace."""
    m = make_paper_model("gcn", TSPEC, device="cpu")
    plan = m.plan_for(TG)
    fn = tplan.CompiledPlan(plan)
    with torch.no_grad():
        a = fn(m.tree(), TX)
    b = fn(m.tree(), TX)
    assert not a.requires_grad and b.requires_grad
    with torch.no_grad():
        fn(m.tree(), TX)
    fn(m.tree(), TX)
    assert (fn.num_traces, fn.num_replays) == (2, 2)
    # x needing a gradient is a third signature
    x = TX.clone().requires_grad_()
    gx, = torch.autograd.grad(fn(m.tree(), x).sum(), [x])
    assert gx.shape == x.shape and fn.num_traces == 3
    fn._traces.clear()
    with pytest.raises(RuntimeError, match="retraced"):
        fn(m.tree(), TX)


def test_dynamic_compile_gradients_equal_eager(one_thread):
    """Gradients through ``compile(dynamic=True)`` on the CPU: a loss over
    each of two runtime graphs differentiates, bit for bit the eager
    forward's autograd over the same graph, on every call; the grad
    signature is one trace and the no_grad one another."""
    m = make_paper_model("gcn", TSPEC, device="cpu")
    plan = m.plan_for(TG, fused=False)
    fn = tplan.CompiledPlan(plan, dynamic=True)
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        0, TSPEC.num_classes, TSPEC.num_vertices))
    tensors = [t for _, t in tplan._leaves(m.tree())]
    for graph in (TG2, TG, TG2):
        eager = torch.autograd.grad(
            _nll(plan.run_model(m.tree(), TX, graph=graph), labels), tensors)
        logits = fn(m.tree(), TX, graph)
        assert logits.requires_grad
        grads = torch.autograd.grad(_nll(logits, labels), tensors)
        assert all(torch.equal(a, b) for a, b in zip(grads, eager))
    with torch.no_grad():
        fn(m.tree(), TX, TG2)
    assert (fn.num_traces, fn.num_replays) == (2, 2)


def test_capture_graph_pauses_the_collector(monkeypatch):
    """``capture_graph`` runs ``torch.cuda.graph`` with the cyclic garbage
    collector off (a dead cycle's graph freed mid-capture would invalidate
    the capture) and turns it back on after, also when the capture
    raises."""
    import contextlib
    import gc
    seen = []

    @contextlib.contextmanager
    def graph(g, pool=None):
        seen.append((gc.isenabled(), g, pool))
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    with tplan.capture_graph("g", pool="p"):
        seen.append(gc.isenabled())
    assert seen == [(False, "g", "p"), False] and gc.isenabled()
    with pytest.raises(RuntimeError, match="inside"):
        with tplan.capture_graph("g"):
            raise RuntimeError("inside")
    assert gc.isenabled()
