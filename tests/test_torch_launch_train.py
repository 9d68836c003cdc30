"""The training launcher on a mesh (``repro_torch.launch.train``) and
``remat="selective"``, on the CPU.

A (1, 1) mesh over a one-rank gloo group is a DTensor program whose every
collective is an identity: its loss history is the run without a mesh bit
for bit.  Four gloo ranks on a (2, 2) mesh (this file run as the rank
script, ``--worker rank world store outdir``, the barrier-before-teardown
pattern of ``tests/test_torch_distributed_pg.py``) hold step 0's loss and
gradients, of a dense and of an SSM stack, to the single-device step within the distributed-training limit
the port uses (1e-4 of each leaf's largest magnitude).  A sharded run
killed and resumed through ``FailureInjector`` is the run that was not,
bit for bit.  ``remat="selective"`` keeps the products without batch dims
(the reference's ``dots_with_no_batch_dims_saveable``): its gradients are
``"none"``'s bit for bit, it keeps strictly fewer bytes than ``"none"``
and more than ``"full"``, and its loss and gradients are the reference's
``make_train_step(remat="selective")``'s in the f32 band.
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
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
#: seconds the spawned world may take, rendezvous to exit
DEADLINE_S = 240
#: step 0 on the (2, 2) mesh against one device: each gradient leaf's
#: largest error over its largest magnitude (gloo sums partials in its own
#: order)
LEAF_LIMIT = 1e-4


def _cfg(dtype="float32", arch="granite_3_8b"):
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return dataclasses.replace(mod.reduced(), dtype=dtype)


def _opt(steps):
    from repro_torch.config import OptimizerConfig
    return OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=steps)


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo group over a file store; closed afterwards."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _plain_trainer(cfg, opt, steps, batch, seq, ckdir, **kw):
    from repro_torch.config import ShapeSpec, TrainConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.optimizer import make_train_state
    from repro_torch.train.trainer import Trainer

    def make_state():
        m = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
        return make_train_state({k: p.detach() for k, p in
                                 m.named_parameters()}, opt)
    tc = TrainConfig(model=cfg.name, steps=steps, optimizer=opt,
                     checkpoint_dir=str(ckdir), log_every=1, **kw)
    return Trainer(tc, make_state=make_state,
                   step_fn=make_train_step(cfg, opt, remat=tc.remat),
                   pipeline=TokenPipeline(cfg, ShapeSpec("t", seq, batch,
                                                         "train"), seed=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_rank_mesh_history_bit_for_bit(group, tmp_path, dtype):
    """``launch/train.py::train`` on a (1, 1) mesh: the DTensor run's loss
    history, gradient norms and final parameters are the unsharded run's
    bit for bit."""
    from repro_torch.launch import train as lt
    from torch.distributed.tensor import DTensor
    cfg, opt = _cfg(dtype), _opt(3)
    res = lt.train(cfg, steps=3, batch=4, seq=24, ckpt_dir=str(
        tmp_path / "a"), device="cpu", checkpoint_every=0, log_every=1,
        opt=opt)
    assert tuple(res["mesh"].shape) == (1, 1)
    plain = _plain_trainer(cfg, opt, 3, 4, 24, tmp_path / "b",
                           checkpoint_every=0).run()
    for key in ("loss", "grad_norm", "lr"):
        assert [h[key] for h in res["history"]] == \
            [h[key] for h in plain["history"]], key
    for k, p in plain["state"].params.items():
        got = res["state"].params[k]
        assert isinstance(got, DTensor)
        assert torch.equal(got.to_local(), p), k


def test_step0_selective_and_none_bit_for_bit_the_plain_step(group):
    """Step 0's loss and every gradient, bf16: the (1, 1) mesh with remat
    "selective", and with "none", against the plain step."""
    from repro_torch.config import ShapeSpec
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch.sharding import sharding_rules
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.transformer import init_lm
    cfg = _cfg("bfloat16")
    tr, mesh, rules = build_trainer(cfg, steps=1, batch=4, seq=40,
                                    ckpt_dir="unused", device="cpu",
                                    checkpoint_every=0, opt=_opt(1))
    batch = TokenPipeline(cfg, ShapeSpec("t", 40, 4, "train"),
                          seed=0).batch_at(0)
    m = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    plain = {k: p.detach() for k, p in m.named_parameters()}
    want, wm = make_loss_and_grads(cfg, "selective")(
        plain, {k: torch.as_tensor(v) for k, v in batch.items()})
    with sharding_rules(mesh, rules):
        state = tr.make_state()
        placed = shard_batch(batch, tr.batch_shardings)
        for remat in ("selective", "none"):
            got, gm = make_loss_and_grads(cfg, remat)(state.params, placed)
            assert torch.equal(gm["loss"].full_tensor(), wm["loss"])
            for k in want:
                assert torch.equal(got[k].to_local(), want[k]), (remat, k)


def test_sharded_resume_bit_for_bit(group, tmp_path):
    """A (1, 1)-mesh run that fails at step 3 and resumes from its step-1
    checkpoint (each leaf saved whole, restored under its placements) is
    the run that did not fail, bit for bit."""
    from repro_torch.launch.sharding import sharding_rules
    from repro_torch.launch.train import build_trainer
    from repro_torch.train.trainer import FailureInjector
    from torch.distributed.tensor import DTensor
    cfg = _cfg()
    out = []
    for name, fail_at in (("clean", ()), ("killed", (3,))):
        tr, mesh, rules = build_trainer(
            cfg, steps=5, batch=4, seq=16, ckpt_dir=str(tmp_path / name),
            device="cpu", checkpoint_every=2, log_every=1, opt=_opt(5),
            failure_injector=FailureInjector(fail_at=fail_at))
        with sharding_rules(mesh, rules):
            res = tr.run()
        out.append(res)
        assert res["recoveries"] == len(fail_at)
    clean, killed = out
    assert [h["loss"] for h in killed["history"]][-2:] == \
        [h["loss"] for h in clean["history"]][-2:]
    for k, p in clean["state"].params.items():
        q = killed["state"].params[k]
        assert isinstance(q, DTensor) and q.placements == p.placements
        assert torch.equal(q.to_local(), p.to_local()), k


def test_shard_batch_and_trainer_shardings(group, tmp_path):
    """``shard_batch`` places each entry by its sharding (others stay
    as they are); the launcher's ``Trainer`` carries the state's and the
    batch's shardings, and its state is made placed."""
    from repro_torch.config import ShapeSpec
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import named_sharding, sharding_rules
    from repro_torch.launch.train import build_trainer
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_test_mesh(device_type="cpu")
    cfg = _cfg()
    batch = TokenPipeline(cfg, ShapeSpec("t", 8, 2, "train"),
                          seed=0).batch_at(0)
    sh = {"tokens": named_sharding(mesh, "data", None)}
    out = shard_batch(batch, sh)
    assert isinstance(out["tokens"], DTensor)
    assert tuple(out["tokens"].placements) == (Shard(0), Replicate())
    assert np.array_equal(out["tokens"].full_tensor().numpy(),
                          batch["tokens"])
    assert out["labels"] is batch["labels"]
    tr, mesh, rules = build_trainer(cfg, steps=1, batch=2, seq=8,
                                    ckpt_dir=str(tmp_path), device="cpu")
    assert set(tr.batch_shardings) == {"tokens", "labels"}
    with sharding_rules(mesh, rules):
        state = tr.make_state()
    for k, p in state.params.items():
        assert isinstance(p, DTensor)
        assert tuple(p.placements) == tr.state_shardings.params[k].placements


def test_launcher_refuses_the_audio_family(group):
    from repro_torch.config import get_config
    from repro_torch.launch.train import build_trainer
    with pytest.raises(SystemExit, match="encdec"):
        build_trainer(get_config("seamless-m4t-medium"), steps=1, batch=1,
                      seq=8, ckpt_dir="unused", device="cpu")


def test_launcher_main_reduced(tmp_path, group):
    """``main`` with ``--reduced`` (f32) on the CPU: steps run, the loss
    is finite, and ``MODULES`` names every arch's config module."""
    import importlib

    from repro_torch.config import list_archs
    from repro_torch.launch import train as lt
    res = lt.main(["--arch", "granite-3-8b", "--reduced", "--steps", "2",
                   "--batch", "2", "--seq", "16", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path), "--remat", "selective"])
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert sorted(lt.MODULES) == list_archs()
    for mod in lt.MODULES.values():
        importlib.import_module(f"repro_torch.configs.{mod}")


# --- remat="selective" -----------------------------------------------------


def _loss_grads(model, toks, labels, remat):
    from repro_torch.models import transformer as ttr
    loss, _ = ttr.lm_loss(model, toks, labels, remat=remat)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


def _saved_bytes(model, toks, labels, remat):
    """Bytes of the forward's outputs still alive when it returns (what the
    backward keeps), counted by ``core/op_cost.py``'s mode."""
    from repro_torch.core.op_cost import CostMode
    from repro_torch.models import transformer as ttr
    mode = CostMode()
    with mode:
        loss, _ = ttr.lm_loss(model, toks, labels, remat=remat)
        kept = mode._live
    del loss
    return kept


def test_selective_remat_bit_for_bit_none_and_keeps_the_products():
    from repro_torch.models import transformer as ttr
    cfg = _cfg()
    model = ttr.TransformerLM(cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    labels = torch.roll(toks, -1, 1)
    ls, gs = _loss_grads(model, toks, labels, "selective")
    ln, gn = _loss_grads(model, toks, labels, "none")
    assert torch.equal(ls, ln)
    assert all(torch.equal(a, b) for a, b in zip(gs, gn))
    kept = {r: _saved_bytes(model, toks, labels, r)
            for r in ("none", "selective", "full")}
    assert kept["full"] < kept["selective"] < kept["none"], kept
    seen = []
    orig = ttr.selective_policy

    def spy(ctx, func, *args, **kwargs):
        out = orig(ctx, func, *args, **kwargs)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            seen.append(func)
        return out
    ttr.selective_policy = spy
    try:
        _loss_grads(model, toks, labels, "selective")
    finally:
        ttr.selective_policy = orig
    assert seen and set(seen) <= set(ttr.SAVED_PRODUCTS)
    # a layer's seven projections (q, k, v, o, wi, wg, wo), kept in the
    # forward (the recompute takes them from the cache)
    n_mm = sum(f == torch.ops.aten.mm.default for f in seen)
    assert n_mm == 7 * cfg.num_layers, n_mm


def test_selective_remat_matches_reference():
    """Loss and every gradient of ``remat="selective"`` against the
    reference's ``lm_loss(remat="selective")`` on the same weights, f32
    band (1e-5 relative, 1e-5 of each leaf's largest magnitude)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import granite_3_8b as jgranite
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr
    cfg = _cfg()
    jcfg = dataclasses.replace(jgranite.reduced(), dtype="float32")
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(3))
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(
        jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    (jloss, _), jgrad = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                              remat="selective"), has_aux=True)(params)
    loss, grads = _loss_grads(model, torch.from_numpy(toks),
                              torch.from_numpy(labels), "selective")
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    want = ttr.flatten_reference(jax.tree.map(np.asarray, jgrad), cfg)
    for (n, _), g in zip(model.named_parameters(), grads):
        w = want[n]
        err = float(np.abs(g.numpy() - w).max() / max(np.abs(w).max(),
                                                      1e-30))
        assert err <= 1e-5, (n, err)


# --- four gloo ranks on a (2, 2) mesh ---------------------------------------


#: the reduced configs the ranks train: a dense stack, and the SSM stack
#: whose SSD runs split by head over `model` (16 heads on 2)
WORLD_ARCHS = ("granite_3_8b", "mamba2_2_7b")


def worker(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank: step 0's loss and gradients through the launcher's
    placement on the (2, 2) mesh, each gathered whole, against the same
    step on one device in this process, for each of ``WORLD_ARCHS``."""
    from repro_torch.config import ShapeSpec
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch.sharding import sharding_rules
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.transformer import init_lm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    out = {}
    for arch in WORLD_ARCHS:
        cfg = _cfg(arch=arch)
        tr, mesh, rules = build_trainer(cfg, steps=1, batch=4, seq=32,
                                        ckpt_dir="unused", device="cpu",
                                        checkpoint_every=0, opt=_opt(1))
        batch = TokenPipeline(cfg, ShapeSpec("t", 32, 4, "train"),
                              seed=0).batch_at(0)
        with sharding_rules(mesh, rules):
            state = tr.make_state()
            got, gm = make_loss_and_grads(cfg, "none")(
                state.params, shard_batch(batch, tr.batch_shardings))
            loss = float(gm["loss"].full_tensor())
            got = {k: g.full_tensor() for k, g in got.items()}
            placements = {k: str(p.placements)
                          for k, p in state.params.items()}
        m = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
        want, wm = make_loss_and_grads(cfg, "none")(
            {k: p.detach() for k, p in m.named_parameters()},
            {k: torch.as_tensor(v) for k, v in batch.items()})
        errs = {k: float((got[k] - w).abs().max() / w.abs().max().clamp(
            min=1e-30)) for k, w in want.items()}
        out[arch] = {"loss": loss, "want_loss": float(wm["loss"]),
                     "errs": errs, "mesh": list(mesh.shape),
                     "placements": placements}
        if arch == "granite_3_8b":
            out["decode"] = _decode_on_mesh(cfg, tr, mesh, rules, m)
    with open(os.path.join(out_dir, f"rank-{rank}.json"), "w") as f:
        json.dump(out, f)
    # no rank tears the group down while a peer is still in a collective
    dist.barrier()
    dist.destroy_process_group()


def _decode_on_mesh(cfg, tr, mesh, rules, model):
    """A decode step on the mesh -- parameters and caches placed as the
    dry run places them, the cache's 128 positions split over `model` --
    against the same step on one device: the logits' largest error over
    their largest magnitude."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.sharding import named, sharding_rules
    from repro_torch.launch.specs import input_pspecs
    from repro_torch.models.transformer import (TransformerLM, _Bound,
                                                lm_decode_step)
    b, s = 4, 128
    gen = torch.Generator().manual_seed(5)
    a = cfg.attention
    caches = [tuple(torch.randn((b, a.num_kv_heads, s, a.head_dim),
                                generator=gen) for _ in range(2))
              for _ in range(cfg.num_layers)]
    token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen)
    length = torch.tensor(100, dtype=torch.int32)
    with torch.no_grad():
        want, _, _ = lm_decode_step(model, token,
                                    [tuple(t.clone() for t in c)
                                     for c in caches], length)
    shard = named(mesh, input_pspecs(cfg, ShapeSpec("d", s, b, "decode"),
                                     mesh))
    skel = TransformerLM(cfg, device="meta")
    bound = _Bound(skel, lambda *x: lm_decode_step(skel, *x))
    with sharding_rules(mesh, rules), torch.no_grad():
        state = tr.make_state()
        placed = [tuple(sh.place(t) for t, sh in zip(c, cs))
                  for c, cs in zip(caches, shard["caches"])]
        seq_split = str(placed[0][0].placements)
        got, _, _ = torch.func.functional_call(
            bound, {f"module.{k}": v for k, v in state.params.items()},
            (shard["token"].place(token), placed, length))
        got = got.full_tensor()
    return {"err": float((got - want).abs().max() / want.abs().max()),
            "cache_placements": seq_split}


def test_four_gloo_ranks_on_a_2x2_mesh_match_one_device(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), "4", store,
         str(tmp_path)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("ranks did not finish within the deadline:\n" + "\n".join(
            p.communicate()[0][-1500:] for p in procs))
    for r, p in enumerate(procs):
        log = p.communicate()[0]
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    for r in range(4):
        out = json.loads((tmp_path / f"rank-{r}.json").read_text())
        dec = out.pop("decode")
        # the cache's sequence split over `model`, merged softmaxes
        assert dec["cache_placements"] == "(Shard(dim=0), Shard(dim=2))"
        assert dec["err"] <= 1e-5, dec
        for arch, res in out.items():
            assert res["mesh"] == [2, 2]
            np.testing.assert_allclose(res["loss"], res["want_loss"],
                                       rtol=1e-5)
            worst = max(res["errs"], key=res["errs"].get)
            assert res["errs"][worst] <= LEAF_LIMIT, \
                (arch, worst, res["errs"][worst])
            # TP and FSDP both in play: the table (model, fsdp)
            assert res["placements"]["embed.table"] == \
                "(Shard(dim=1), Shard(dim=0))"
        assert out["granite_3_8b"]["placements"]["layers.0.attn.wq"] == \
            "(Shard(dim=0), Shard(dim=1))"
        assert out["mamba2_2_7b"]["placements"]["layers.0.ssm.conv_w"] == \
            "(Replicate(), Shard(dim=0))"


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(ROOT / "src"))
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
