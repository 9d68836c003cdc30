"""Distributed GCN inference and training on ``torch.distributed`` ranks
(gloo, CPU).

Each test spawns one process per rank (this file run as a script, which
imports torch and the port only), with the rendezvous through a
``FileStore`` under the test's ``tmp_path`` -- no port, so parallel test
workers never collide -- and a deadline of its own: a hung rendezvous or
collective fails the test instead of eating the suite's time.  In every
rank a ``ProcessGroupMesh`` plan runs the forward; the rank checks, in its
own process, that its logits equal a ``LocalMesh`` plan's at the same
mesh shape bit for bit (the 2-D mesh's ``psum_scatter`` over Q = 2 adds
two partials, which IEEE addition gives the same in either order) and
that
the bytes its collectives counted equal ``schedule_wire_bytes`` layer by
layer (the instrumented run) and over the forward, and that the plan's
``compile()`` -- on gloo the eager forward under the capture contract --
gives the same logits with one trace.  The test then holds the logits
to the reference's unsharded eager forward, in the band.

Training (``--train-worker``): each rank takes one SGD step of the mean
NLL through a ``ProcessGroupMesh`` plan (TRAIN_CASES).  Its gradients --
the rank's partials summed over the world by the plan's backward
(``core.distributed`` adjoint (c)) -- are held to a ``LocalMesh`` plan's
in the same process: bit for bit at world 2, where the two partials a
sum adds come out the same in either order, and in the f32 band at
worlds 4 and 2 x 2, where gloo's all-reduce adds four partials in its
own order.  The backward's counted bytes: the halo's as the forward's,
the logits' gather none (its adjoint is the rank's own slice), one
all-reduce of every parameter's gradient.  World 2 also runs the int8
error-feedback all-reduce (``make_compressed_allreduce``) over the
gradients, bit for bit the ``LocalMesh``'s.

By hand (two ranks, 1-D)::

    PYTHONPATH=src python tests/test_torch_distributed_pg.py --worker \\
        0 2 /tmp/store 2 /tmp/out & \\
    PYTHONPATH=src python tests/test_torch_distributed_pg.py --worker \\
        1 2 /tmp/store 2 /tmp/out
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
#: seconds a spawned world may take, rendezvous to exit
DEADLINE_S = 240
#: seconds a collective may wait before gloo gives up
PG_TIMEOUT_S = 60
#: the cases each rank runs: (strategy, overlap, dtype)
CASES = [("allgather", "none", "f32"), ("ring", "none", "f32"),
         ("ring", "pipelined", "f32"), ("ring", "pipelined", "bf16")]
#: the training step's cases
TRAIN_CASES = [("allgather", "none", "f32"), ("ring", "none", "f32"),
               ("ring", "pipelined", "f32"), ("ring", "pipelined", "bf16")]


def _setup():
    """The graph, features and model every rank and the test build alike
    (seeded), torch and the port only."""
    import torch
    from repro_torch.config import CORA, reduced_graph
    from repro_torch.graph.datasets import make_features, make_synthetic_graph
    from repro_torch.models.gcn import PAPER_MODELS, GCNModel
    spec = reduced_graph(CORA, 300, 32)
    g = make_synthetic_graph(spec, device="cpu")
    x = make_features(spec, device="cpu")
    cfg = dataclasses.replace(PAPER_MODELS["gcn"], hidden_dims=(16,))
    model = GCNModel(cfg, spec.feature_len, spec.num_classes, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    return spec, g, x, cfg, model


def worker(rank: int, world: int, store: str, shape: str, out_dir: str):
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as tdist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    dims = tuple(int(n) for n in shape.split("x"))
    names = ("data",) if len(dims) == 1 else ("node", "feat")
    spec, g, x, _, model = _setup()
    mesh = tdist.ProcessGroupMesh(dims, names, device="cpu")
    local = tdist.LocalMesh(dims, names, device="cpu")
    results = {}
    for strategy, overlap, dtype in CASES:
        kw = dict(strategy=strategy, overlap=overlap, dtype=dtype)
        plan = model.plan_for(g, mesh=mesh, **kw)
        two_d = plan.partition_kind == "2d"
        sched = [tdist.schedule_wire_bytes(
            plan.partition,
            lp.din if lp.order == "aggregate_first" else lp.dout,
            combine_out_len=lp.dout if two_d else None, **kw)["total_bytes"]
            for lp in plan.layers]
        mesh.reset_counts()
        with torch.no_grad():
            out = model(g, x, plan=plan)
            counted = mesh.collective_bytes()
            want = model(g, x, plan=model.plan_for(g, mesh=local, **kw))
            # compiled: on gloo the eager forward under the contract
            comp = plan.compile()
            compiled = [torch.equal(comp(model.tree(), x), out)
                        for _ in range(2)] + [comp.num_traces == 1]
        # the logits' gather at egress: one slab of every shard
        pg = plan.partition.nodes if two_d else plan.partition
        fb = plan.partition.feature_block(plan.layers[-1].dout) if two_d \
            else plan.layers[-1].dout
        egress = pg.block_size * fb * out.element_size()
        # the probe raises unless each layer's count equals its schedule
        rep = plan.instrument().run_model(model.tree(), x)
        name = f"{strategy}-{overlap}-{dtype}"
        np.save(os.path.join(out_dir, f"{name}-{rank}.npy"),
                out.float().numpy())
        results[name] = {
            "bitwise_local": bool(torch.equal(out, want)),
            "compiled": compiled,
            "max_diff_local": float((out.float() - want.float()).abs().max()),
            "counted": counted["total"], "scheduled": sum(sched) + egress,
            "layer_wire": [r.wire_collective_bytes for r in rep.records],
            "layer_sched": [float(b) for b in sched],
            "overlap": plan.overlap, "coords": list(mesh.coords[0]),
        }
    with open(os.path.join(out_dir, f"result-{rank}.json"), "w") as f:
        json.dump(results, f)
    # no rank tears the group down while a peer is still in a collective
    dist.barrier()
    dist.destroy_process_group()


def train_worker(rank: int, world: int, store: str, shape: str,
                 out_dir: str):
    """One SGD step a TRAIN_CASES case on a ProcessGroupMesh, against a
    LocalMesh plan of the same shape in this process."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as tdist
    from repro_torch.graph.datasets import make_labels
    from repro_torch.optim.compression import (init_residuals,
                                               make_compressed_allreduce)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    dims = tuple(int(n) for n in shape.split("x"))
    names = ("data",) if len(dims) == 1 else ("node", "feat")
    spec, g, x, _, model = _setup()
    y = make_labels(spec, device="cpu")
    mesh = tdist.ProcessGroupMesh(dims, names, device="cpu")
    local = tdist.LocalMesh(dims, names, device="cpu")
    names_p = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    param_bytes = sum(p.numel() * 4 for p in params)
    results = {}
    for strategy, overlap, dtype in TRAIN_CASES:
        kw = dict(strategy=strategy, overlap=overlap, dtype=dtype)
        plan = model.plan_for(g, mesh=mesh, **kw)
        mesh.reset_counts()
        loss = model.loss_fn(g, x, y, plan=plan)
        fwd = mesh.collective_bytes()
        mesh.reset_counts()
        grads = torch.autograd.grad(loss, params)
        bwd = mesh.collective_bytes()
        want_loss = model.loss_fn(g, x, y, plan=model.plan_for(
            g, mesh=local, **kw))
        want = torch.autograd.grad(want_loss, params)
        two_d = plan.partition_kind == "2d"
        pg = plan.partition.nodes if two_d else plan.partition
        last = plan.layers[-1]
        fb = plan.partition.feature_block(last.dout) if two_d else last.dout
        egress = pg.block_size * fb * (2 if dtype == "bf16" else 4)
        # the psum_scatter's adjoint: one (block, fb_out) all-gather a layer
        rs_adj = sum(pg.block_size * plan.partition.feature_block(lp.dout)
                     * 4 for lp in plan.layers) if two_d else 0
        name = f"{strategy}-{overlap}-{dtype}"
        results[name] = {
            "loss_bitwise": bool(torch.equal(loss, want_loss)),
            "bitwise": [bool(torch.equal(a, b)) for a, b in zip(grads, want)],
            "rel_err": [float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(grads, want)],
            "ppermute": [fwd["collective-permute"],
                         bwd["collective-permute"]],
            "all_gather": [fwd["all-gather"] - egress + rs_adj,
                           bwd["all-gather"]],
            "all_reduce": [param_bytes, bwd["all-reduce"]],
            "reduce_scatter_bwd": bwd["reduce-scatter"],
            "names": names_p,
        }
        if world == 2 and name == "ring-none-f32":
            tree = dict(zip(names_p, grads))
            ltree = dict(zip(names_p, want))
            out, res = make_compressed_allreduce(mesh, "data")(
                tree, init_residuals(tree))
            lout, lres = make_compressed_allreduce(local, "data")(
                ltree, init_residuals(ltree))
            results["int8_ef"] = {
                "bitwise": all(torch.equal(out[n], lout[n])
                               and torch.equal(res[n], lres[n])
                               for n in names_p),
                "err_over_scale": max(
                    float((out[n] - tree[n]).abs().max()
                          / (tree[n].abs().max() / 127)) for n in names_p)}
    with open(os.path.join(out_dir, f"train-{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(tmp_path, world: int, shape: str,
           mode: str = "--worker") -> list:
    """Run ``world`` ranks to completion within ``DEADLINE_S``; returns
    each rank's results.  Any rank failing or the deadline passing fails
    the test, and every rank is killed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(world), store,
         shape, str(tmp_path)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0][-1500:] for p in procs]
        pytest.fail(f"ranks did not finish within {DEADLINE_S} s:\n"
                    + "\n".join(logs))
    logs = [p.communicate()[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    prefix = "result" if mode == "--worker" else "train"
    return [json.loads((tmp_path / f"{prefix}-{r}.json").read_text())
            for r in range(world)]


def _reference(dtype: str):
    """The reference's unsharded eager forward with the ranks' weights."""
    import jax.numpy as jnp

    from repro.config import CORA, reduced_graph
    from repro.core.plan import build_plan
    from repro.graph.datasets import make_features, make_synthetic_graph
    from repro.models.gcn import PAPER_MODELS
    _, _, _, _, model = _setup()
    params = {c: {d: {k: jnp.asarray(t.detach().numpy())
                      for k, t in leaf.items()}
                  for d, leaf in sub.items()}
              for c, sub in model.tree().items()}
    spec = reduced_graph(CORA, 300, 32)
    cfg = dataclasses.replace(PAPER_MODELS["gcn"], hidden_dims=(16,))
    plan = build_plan(make_synthetic_graph(spec), cfg, spec.feature_len,
                      spec.num_classes, backend="xla", machine="h100",
                      dtype=dtype)
    return np.asarray(plan.run_model(params, make_features(spec)),
                      np.float32)


def _check(tmp_path, results, world: int):
    from tolerance import assert_allclose_dtype
    coords = {tuple(r[CASES[0][0] + "-" + CASES[0][1] + "-f32"]["coords"])
              for r in results}
    assert len(coords) == world           # every rank holds its own shard
    refs = {}
    for strategy, overlap, dtype in CASES:
        name = f"{strategy}-{overlap}-{dtype}"
        outs = [np.load(tmp_path / f"{name}-{r}.npy") for r in range(world)]
        for r, res in enumerate(results):
            got = res[name]
            assert got["overlap"] == overlap
            assert got["bitwise_local"], (r, name, got["max_diff_local"])
            assert all(got["compiled"]), (r, name, got["compiled"])
            assert got["counted"] == got["scheduled"], (r, name, got)
            assert got["layer_wire"] == got["layer_sched"], (r, name, got)
            # every rank returns the whole logits
            assert np.array_equal(outs[r], outs[0])
        if dtype not in refs:
            refs[dtype] = _reference(dtype)
        assert_allclose_dtype(outs[0], refs[dtype], dtype,
                              scale=100 if dtype == "f32" else 1)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_1d_match_local_mesh(tmp_path, world):
    """1-D meshes of 2 and 4 gloo ranks: all-gather, ring none and
    pipelined, bf16 pipelined -- bit for bit the LocalMesh plan at the same
    P, the counted bytes as scheduled, the reference's band."""
    results = _spawn(tmp_path, world, str(world))
    _check(tmp_path, results, world)


def test_gloo_ranks_2d_match_local_mesh(tmp_path):
    """A 2 x 2 (node, feat) mesh of 4 gloo ranks: the ring along the node
    axis, the reduce-scatter along the feature axis: bit for bit the
    LocalMesh plan (two partials a sum)."""
    results = _spawn(tmp_path, 4, "2x2")
    _check(tmp_path, results, 4)


@pytest.mark.parametrize("shape", ["2", "4", "2x2"])
def test_gloo_ranks_train_step_matches_local_mesh(tmp_path, shape):
    """One SGD step's gradients on gloo ranks (world 2, 4, 2 x 2) equal a
    LocalMesh plan's: bit for bit at world 2, in the f32 band (bf16's for
    the bf16 case) at 4 and 2 x 2; the loss bit for bit; the backward's
    bytes as scheduled; at world 2 the int8 error-feedback all-reduce
    bit for bit the LocalMesh's, within a scale of the gradient."""
    world = int(np.prod([int(n) for n in shape.split("x")]))
    results = _spawn(tmp_path, world, shape, "--train-worker")
    band = {"f32": 1e-5 * 10, "bf16": 3e-2}
    for r, res in enumerate(results):
        for strategy, overlap, dtype in TRAIN_CASES:
            got = res[f"{strategy}-{overlap}-{dtype}"]
            assert got["loss_bitwise"], (r, strategy, overlap, dtype)
            if world == 2:
                assert all(got["bitwise"]), (r, strategy, overlap, got)
            else:
                assert max(got["rel_err"]) <= band[dtype], (r, got)
            for key in ("ppermute", "all_gather", "all_reduce"):
                assert got[key][0] == got[key][1], (r, key, got)
            assert got["reduce_scatter_bwd"] == 0
        if world == 2:
            assert res["int8_ef"]["bitwise"], res["int8_ef"]
            assert res["int8_ef"]["err_over_scale"] <= 1.01


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
           sys.argv[6])
elif __name__ == "__main__" and sys.argv[1:2] == ["--train-worker"]:
    train_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                 sys.argv[5], sys.argv[6])
