"""``plan.compile()`` of distributed plans on ``LocalMesh`` against the JAX
package, on the CPU.

The reference compiles its mesh plans and requires compiled == eager bit
for bit with one trace at V = 249 on 8 shards (ragged), 1-D and 2-D
(``tests/test_overlap.py``); its own sharded and compiled contracts fail
on this tree (ROADMAP "Reference caveats"), so the port is held here to
its own eager forward bit for bit and to the reference's eager
single-device forward in the f32 band.  On the CPU a compiled call runs
the eager forward under the capture contract (one trace a signature, the
retrace guard, a cache per (donate, layer)), under autograd when a
gradient is wanted; ``tests/test_torch_cuda.py`` holds the CUDA graphs.
"""

import dataclasses

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
from repro_torch.core import distributed as tdist
from repro_torch.graph.datasets import make_features as tfeatures
from repro_torch.graph.datasets import make_labels as tlabels
from repro_torch.graph.datasets import make_synthetic_graph as tgraph
from repro_torch.models.gcn import PAPER_MODELS, GCNModel

torch.set_num_threads(2)

#: the reference's ragged case: 249 % 8 == 1, so every shard's block ends
#: in padding rows
JSPEC = reduced_graph(CORA, 249, 32)
TSPEC = tconfig.reduced_graph(tconfig.CORA, 249, 32)
JG, TG = jgraph(JSPEC), tgraph(TSPEC, device="cpu")
JX, TX = jfeatures(JSPEC), tfeatures(TSPEC, device="cpu")
TY = tlabels(TSPEC, device="cpu")
V = TSPEC.num_vertices
#: the reference's overlap test's model: GCN 32 -> 16 -> 7
JCFG = dataclasses.replace(JMODELS["gcn"], hidden_dims=(16,))
TCFG = dataclasses.replace(PAPER_MODELS["gcn"], hidden_dims=(16,))
MESHES = [1, 4, 8, (4, 2)]
STRATEGIES = [("allgather", "none"), ("ring", "none"), ("ring", "pipelined")]
CALLS = 3


def _mesh(shape):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    names = ("data",) if len(shape) == 1 else ("node", "feat")
    return tdist.LocalMesh(shape, names, device="cpu")


_MODEL = {}


def _model():
    """The reference's params (seed 0) and the port's model holding them."""
    if "m" not in _MODEL:
        jm = JGCNModel(JCFG, JSPEC.feature_len, JSPEC.num_classes)
        params = jm.init(jax.random.PRNGKey(0))
        tm = GCNModel(TCFG, TSPEC.feature_len, TSPEC.num_classes,
                      device="cpu")
        tm.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
        jplan = jbuild_plan(JG, JCFG, JSPEC.feature_len, JSPEC.num_classes,
                            backend="xla", machine="h100")
        _MODEL["m"] = (tm, np.asarray(jplan.run_model(params, JX)))
    return _MODEL["m"]


def _plan(shape, strategy="ring", overlap="none", dtype="f32"):
    tm, _ = _model()
    return tm.plan_for(TG, mesh=_mesh(shape), strategy=strategy,
                       overlap=overlap, dtype=dtype)


def _loss(logits):
    return -torch.log_softmax(logits.float(), dim=-1).gather(
        -1, TY.long()[:, None])[:, 0].mean()


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("strategy,overlap", STRATEGIES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_compiled_mesh_plan_bitwise_eager(shape, strategy, overlap, dtype):
    """compile() of a mesh plan: one trace over three calls, every call bit
    for bit the eager forward; the f32 logits in the band of the
    reference's eager single-device forward; describe() says compiled."""
    tm, want = _model()
    plan = _plan(shape, strategy, overlap, dtype)
    assert plan.compile_supported and all(d["compiled"]
                                          for d in plan.describe())
    fn = plan.compile()
    with torch.no_grad():
        eager = plan.run_model(tm.tree(), TX)
        outs = [fn(tm.tree(), TX) for _ in range(CALLS)]
    assert all(torch.equal(o, eager) for o in outs)
    assert (fn.num_traces, fn.num_replays) == (1, CALLS - 1)
    assert fn.capture_launches == {} and fn.capture_collectives == {}
    assert outs[0].shape == (V, TSPEC.num_classes)
    if dtype == "f32":
        assert_allclose_dtype(outs[0].numpy(), want, scale=100)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_compile_cache_layers_and_refusals(shape):
    """The cache per (donate, layer); compile(layer=i) takes and returns
    the padded partition layout and equals run_layer bit for bit with one
    trace; the graph-as-argument mode raises, as the reference's."""
    tm, _ = _model()
    plan = _plan(shape, overlap="pipelined")
    assert plan.compile() is plan.compile()
    assert plan.compile(layer=0) is plan.compile(layer=0)
    assert plan.compile(layer=0) is not plan.compile()
    assert plan.compile(donate=True) is not plan.compile()
    tree = tm.tree()
    with torch.no_grad():
        h = plan._ingress(TX)
        for i in range(plan.num_layers):
            sub = tree[f"conv{i}"]
            want = plan.run_layer(sub, h, layer=i)
            fl = plan.compile(layer=i)
            assert all(torch.equal(fl(sub, h), want) for _ in range(2))
            assert (fl.num_traces, fl.num_replays) == (1, 1)
            h = torch.relu(want) if i < plan.num_layers - 1 else want
        assert torch.equal(plan._egress(h), plan.run_model(tree, TX))
        assert torch.equal(plan.compile(donate=True)(tree, TX),
                           plan.compile()(tree, TX))
    with pytest.raises(ValueError, match="edge-derived shards"):
        plan.compile(dynamic=True)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("strategy,overlap", STRATEGIES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_compiled_mesh_plan_gradients_bitwise_eager(shape, strategy,
                                                    overlap, dtype):
    """A loss through a compiled mesh plan under autograd: the logits need
    a gradient, and the loss and every parameter's gradient equal eager
    autograd's bit for bit on every call, one trace for the grad
    signature beside the inference one."""
    tm, _ = _model()
    plan = _plan(shape, strategy, overlap, dtype)
    params = list(tm.parameters())
    loss = _loss(plan.run_model(tm.tree(), TX))
    want = torch.autograd.grad(loss, params)
    fn = plan.compile()
    with torch.no_grad():
        fn(tm.tree(), TX)
    for _ in range(CALLS):
        logits = fn(tm.tree(), TX)
        assert logits.requires_grad
        got_loss = _loss(logits)
        got = torch.autograd.grad(got_loss, params)
        assert torch.equal(got_loss, loss)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fn.num_traces, fn.num_replays) == (2, CALLS - 1)


def test_compiled_mesh_plan_gradient_in_x():
    """Under autograd with x requiring a gradient the compiled mesh plan
    gives eager's gradient in x too, bit for bit."""
    tm, _ = _model()
    plan = _plan(4, overlap="pipelined")
    x = TX.clone().requires_grad_()
    params = list(tm.parameters())
    want = torch.autograd.grad(_loss(plan.run_model(tm.tree(), x)),
                               params + [x])
    got = torch.autograd.grad(_loss(plan.compile()(tm.tree(), x)),
                              params + [x])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_launcher_training_through_compile_matches_eager_loop(capsys):
    """``launch/distributed_gcn.py``'s ``train`` takes its logits from
    ``plan.compile()`` under autograd: its losses and parameters after
    the steps equal an eager loop's over ``model.loss_fn`` bit for bit
    (the example's ring plan, int8 error-feedback all-reduce)."""
    from repro_torch.launch import distributed_gcn as launch
    from repro_torch.optim.compression import (init_residuals,
                                               make_compressed_allreduce)
    from repro_torch.optim.optimizer import tree_map
    dev = torch.device("cpu")
    spec, g, x, y = launch.example_data(dev, 128, 16)
    cfg = dataclasses.replace(PAPER_MODELS["gcn"], hidden_dims=(16,))
    runs = []
    for compiled in (True, False):
        mesh = tdist.LocalMesh((8,), ("data",), device=dev)
        model = GCNModel(cfg, spec.feature_len, spec.num_classes, device=dev,
                         generator=torch.Generator().manual_seed(0))
        plan = model.plan_for(g, mesh=mesh)
        allreduce = make_compressed_allreduce(mesh, "data")
        if compiled:
            losses = launch.train(model, plan, g, x, y, steps=4,
                                  lr=launch.LR, allreduce=allreduce)
        else:           # the loop before the compiled forward
            params = model.tree()
            leaves = list(model.parameters())
            residuals, losses = init_residuals(params), []
            for _ in range(4):
                loss = model.loss_fn(g, x, y, plan=plan)
                grads = dict(zip(map(id, leaves),
                                 torch.autograd.grad(loss, leaves)))
                grads = tree_map(lambda t: grads[id(t)], params)
                grads, residuals = allreduce(grads, residuals)
                with torch.no_grad():
                    tree_map(lambda p, gr: p.sub_(launch.LR * gr), params,
                             grads)
                losses.append(float(loss.detach()))
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
        if compiled:
            assert plan.compile().num_traces == 1
    (lc, pc), (le, pe) = runs
    assert lc == le and lc[-1] < lc[0]
    assert all(torch.equal(a, b) for a, b in zip(pc, pe))
    assert "step  0" in capsys.readouterr().out
