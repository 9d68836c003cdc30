"""Distributed GCN inference on ``torch.distributed`` ranks (gloo, CPU).

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
layer (the instrumented run) and over the forward.  The test then holds
the logits to the reference's unsharded eager forward, in the band.

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
            "max_diff_local": float((out.float() - want.float()).abs().max()),
            "counted": counted["total"], "scheduled": sum(sched) + egress,
            "layer_wire": [r.wire_collective_bytes for r in rep.records],
            "layer_sched": [float(b) for b in sched],
            "overlap": plan.overlap, "coords": list(mesh.coords[0]),
        }
    with open(os.path.join(out_dir, f"result-{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def _spawn(tmp_path, world: int, shape: str) -> list:
    """Run ``world`` ranks to completion within ``DEADLINE_S``; returns
    each rank's results.  Any rank failing or the deadline passing fails
    the test, and every rank is killed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(world), store,
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
    return [json.loads((tmp_path / f"result-{r}.json").read_text())
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


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
           sys.argv[6])
