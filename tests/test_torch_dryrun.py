"""The pod dry run (``repro_torch.launch.dryrun``), its cost counter
(``repro_torch.core.op_cost``) and K5's opaque op, on the CPU.

The reference's dry run compiles each cell for 512 placeholder XLA devices
and reads the HLO (``repro.core.hlo_cost``); the port traces one rank's
step over a ``"fake"`` process group under ``FakeTensorMode`` and counts
its ops.  Here: ``model_flops`` is the reference's for every runnable
cell; on reduced configs on one device the port's product FLOPs of a
prefill and a decode step are within 2 % of the reference's
``analyze_hlo(...).dot_flops`` of the same step compiled by XLA on the
CPU, and a training step's equal the count derived from the config; one
linear layer under FSDP/TP on fake (4, 1) and (2, 2) meshes moves the
collective bytes computed by hand, exactly; reduced dense, SSM and
enc-dec cells on a fake (2, 2) mesh record ``status: "ok"`` and an MoE
cell the ``NotImplementedError`` of expert parallelism.  K5's
opaque ops pass ``opcheck``, their fake implementation gives the shapes
and raises where ``_check`` raises, the forward's FLOP formula is ``4 B
Hq Sq Sk D``, on a mesh ``per_shard`` runs them on each rank's batch or
heads, and a ``FakeTensorMode`` trace of an LM training step on the
cuda tier shows one K5 forward op per layer and launches nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro import config as rcfg
from repro.configs import ASSIGNED_ARCHS
from repro.configs import granite_3_8b as jgranite
from repro.core.hlo_cost import analyze_hlo
from repro.launch import dryrun as rdry
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro_torch import config as tcfg
from repro_torch.config import ShapeSpec
from repro_torch.configs import granite_3_8b
from repro_torch.core import op_cost
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import open_fake_group
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.transformer import TransformerLM, init_caches
from repro_torch.optim.optimizer import make_train_state

torch.set_num_threads(2)

#: the port's product FLOPs against the reference's compiled dot FLOPs
DOT_LIMIT = 0.02


@pytest.fixture(autouse=True)
def _close_groups():
    """A test that opens a fake process group leaves none open behind it
    (other files share this worker process)."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _cfgs():
    cfg = dataclasses.replace(granite_3_8b.reduced(), dtype="float32")
    jcfg = dataclasses.replace(jgranite.reduced(), dtype="float32")
    return cfg, jcfg


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_match_reference(arch):
    cfg, rc = tcfg.get_config(arch), rcfg.get_config(arch)
    for shape in rc.shapes():
        assert dryrun.model_flops(cfg, tcfg.SHAPES_BY_NAME[shape.name]) == \
            rdry.model_flops(rc, shape), (arch, shape.name)
    assert dryrun.default_opt(cfg).moment_dtype == \
        rdry.default_opt(rc).moment_dtype
    assert [c for c in dryrun.all_cells() if c[0] == arch] == \
        [c for c in rdry.all_cells() if c[0] == arch]


def _ref_dot_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()) \
        .dot_flops


def _port_cost(fn, *args):
    _, cost = op_cost.count(fn, *args)
    return cost


def test_prefill_and_decode_dot_flops_match_reference():
    """Reduced granite-3-8b in f32 on one device, B 2 x S 64 (a cache of
    64): the port's product FLOPs of ``make_prefill_step`` and
    ``make_decode_step`` within 2 % of the reference's HLO dot FLOPs."""
    cfg, jcfg = _cfgs()
    b, s = 2, 64
    params = jax.eval_shape(lambda: jtr.init_lm(jcfg,
                                                jax.random.PRNGKey(0)))
    i32 = jnp.int32
    want_p = _ref_dot_flops(jsteps.make_prefill_step(jcfg), params,
                            {"tokens": jax.ShapeDtypeStruct((b, s), i32)})
    want_d = _ref_dot_flops(
        jsteps.make_decode_step(jcfg), params,
        {"token": jax.ShapeDtypeStruct((b, 1), i32),
         "caches": jtr.init_caches_abstract(jcfg, b, s),
         "length": jax.ShapeDtypeStruct((), i32)})
    model = TransformerLM(cfg, device="cpu")
    toks = torch.zeros((b, s), dtype=torch.int32)
    with torch.no_grad():
        got_p = _port_cost(make_prefill_step(cfg), model,
                           {"tokens": toks}).dot_flops
        got_d = _port_cost(make_decode_step(cfg), model, {
            "token": toks[:, :1], "caches": init_caches(cfg, b, s, "cpu"),
            "length": torch.tensor(s - 1, dtype=torch.int32)}).dot_flops
    print(f"prefill {got_p:.6e} vs {want_p:.6e}; decode {got_d:.6e} vs "
          f"{want_d:.6e}")
    assert abs(got_p / want_p - 1) <= DOT_LIMIT
    assert abs(got_d / want_d - 1) <= DOT_LIMIT


def test_train_dot_flops_equal_the_analytic_count():
    """A training step (remat none, f32, direct attention): every product
    of the forward (projections, attention's two, the CE chunks' logits)
    is matched by two in the backward, and the CE chunks' forward runs
    again under their checkpoint.  The count equals that, exactly; its
    ratio to the reference's compiled step is printed."""
    cfg, jcfg = _cfgs()
    b, s = 2, 32
    a = cfg.attention
    t, d = b * s, cfg.d_model
    proj = 2 * t * d * (a.q_dim + 2 * a.kv_dim) + 2 * t * a.q_dim * d
    mlp = 3 * 2 * t * d * cfg.d_ff
    attn = 4 * b * a.num_heads * s * s * a.head_dim
    head = 2 * t * d * cfg.padded_vocab
    want = 3 * cfg.num_layers * (proj + mlp + attn) + 4 * head
    opt = tcfg.OptimizerConfig()
    model = TransformerLM(cfg, device="cpu")
    state = make_train_state({k: p.detach() for k, p in
                              model.named_parameters()}, opt)
    toks = torch.zeros((b, s), dtype=torch.int32)
    got = _port_cost(make_train_step(cfg, opt), state,
                     {"tokens": toks, "labels": toks}).dot_flops
    assert got == want, (got, want)
    rstate = jax.eval_shape(lambda: jsteps.make_train_step.__globals__[
        "TrainState"](step=jnp.zeros((), jnp.int32),
                      params=jtr.init_lm(jcfg, jax.random.PRNGKey(0)),
                      m=jtr.init_lm(jcfg, jax.random.PRNGKey(0)),
                      v=jtr.init_lm(jcfg, jax.random.PRNGKey(0))))
    spec = jax.ShapeDtypeStruct((b, s), jnp.int32)
    ref = _ref_dot_flops(jsteps.make_train_step(
        jcfg, rcfg.OptimizerConfig()), rstate, {"tokens": spec,
                                                "labels": spec})
    print(f"train dot flops: port {got:.6e} (analytic {want:.6e}), "
          f"reference HLO {ref:.6e}, ratio {got / ref:.4f}")


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_linear_layer_collective_bytes_by_hand(shape):
    """``y = x @ w`` with x (64, 32) batch-sharded over `data` and w (32,
    16) FSDP over `data` and TP over `model`, its gradient reduced to w's
    placements: one all-gather of w's FSDP shards (32 x 16 / tp f32) and
    one reduce-scatter of the gradient (32 / dp x 16 / tp f32), nothing
    else."""
    open_fake_group(4)
    dp, tp = shape
    mesh = DeviceMesh("cpu", torch.arange(4).view(shape),
                      mesh_dim_names=("data", "model"))
    b, d, f = 64, 32, 16
    with FakeTensorMode() as fm:
        x = distribute_tensor(torch.empty(b, d), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(d, f), mesh, [Shard(0), Shard(1)],
                              src_data_rank=None).requires_grad_()

        def step():
            y = x @ w
            dy = distribute_tensor(torch.empty(b, f), mesh,
                                   list(y.placements), src_data_rank=None)
            (g,) = torch.autograd.grad(y, w, dy)
            return g.redistribute(mesh, list(w.placements))
        g, cost = op_cost.count(step, fake_mode=fm)
    assert tuple(g.placements) == (Shard(0), Shard(1))
    assert cost.collectives == {"all-gather": d * f // tp * 4,
                                "reduce-scatter": d // dp * f // tp * 4,
                                "all-reduce": 0.0, "all-to-all": 0.0,
                                "collective-permute": 0.0}
    assert cost.collective_bytes == d * f // tp * 4 + d // dp * f // tp * 4
    assert cost.dot_flops == 2 * (b // dp) * d * (f // tp) * 2


def test_characterize_cost_helpers():
    """``shape_bytes`` is the reference's; ``cost_of`` counts a traced
    function on fake tensors (a product and its bytes) without running
    it."""
    from repro.core import characterize as rchar
    from repro_torch.core import characterize as tchar
    for dt, dims in (("f32", "2,3"), ("bf16", "7"), ("s32", "")):
        assert tchar.shape_bytes(dt, dims) == rchar.shape_bytes(dt, dims)
    with FakeTensorMode():
        a, b = torch.empty(8, 16), torch.empty(16, 4)
        cost = tchar.cost_of(torch.mm, a, b)
    assert cost.flops == 2 * 8 * 16 * 4
    assert cost.hbm_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert cost.collective["total"] == 0
    assert cost.peak_memory_per_device == (8 * 16 + 16 * 4 + 8 * 4) * 4


def _test_mesh():
    open_fake_group(4)
    return DeviceMesh("cpu", torch.arange(4).view(2, 2),
                      mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("arch,kind", [
    ("granite-3-8b", "train"), ("granite-3-8b", "prefill"),
    ("granite-3-8b", "decode"), ("mamba2-2.7b", "train"),
    ("mamba2-2.7b", "decode"), ("seamless-m4t-medium", "train"),
    ("seamless-m4t-medium", "prefill")])
def test_reduced_cells_trace_ok(arch, kind):
    """Reduced dense, SSM and enc-dec cells on a fake (2, 2) mesh: status
    "ok", per-device numbers that are positive, the state's bytes the
    local shards' of its placements."""
    import importlib

    from repro_torch.launch.train import MODULES
    mod = importlib.import_module(f"repro_torch.configs.{MODULES[arch]}")
    cfg = mod.reduced()
    shape = ShapeSpec(f"{kind}_t", 64, 4, kind)
    rec = dryrun.run_cell(arch, shape.name, "test", cfg=cfg, shape=shape,
                          mesh=_test_mesh(), device="cpu", out_dir=None,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 4
    assert rec["flops"] > rec["dot_flops"] > 0
    assert rec["peak_bytes_per_device"] >= \
        rec["memory_per_device"]["argument_bytes"] > 0
    assert rec["fits_80g"] and rec["model_flops"] > 0
    assert set(rec["roofline"]) >= {"dominant", "roofline_fraction"}


def test_moe_cell_records_expert_parallelism():
    from repro_torch.configs import kimi_k2
    shape = ShapeSpec("train_t", 32, 4, "train")
    rec = dryrun.run_cell("kimi-k2-1t-a32b", "train_t", "test",
                          cfg=kimi_k2.reduced(), shape=shape,
                          mesh=_test_mesh(), device="cpu", out_dir=None,
                          verbose=False)
    assert rec["status"] == "error"
    assert rec["error"].startswith("NotImplementedError")
    assert "expert parallelism" in rec["error"] and "13.8" in rec["error"]


def test_context_parallel_profile_raises():
    """Heads that do not divide the `model` axis ask for the reference's
    context-parallel region, which raises naming ROADMAP item 13.8."""
    cfg = dataclasses.replace(granite_3_8b.reduced(), attention=dataclasses
                              .replace(granite_3_8b.reduced().attention,
                                       num_heads=3, num_kv_heads=1))
    shape = ShapeSpec("prefill_t", 32, 4, "prefill")
    rec = dryrun.run_cell("granite-3-8b", "prefill_t", "test", cfg=cfg,
                          shape=shape, mesh=_test_mesh(), device="cpu",
                          out_dir=None, verbose=False)
    assert rec["status"] == "error"
    assert "context-parallel" in rec["error"] and "13.8" in rec["error"]


def test_dryrun_writes_a_record(tmp_path):
    shape = ShapeSpec("decode_t", 64, 4, "decode")
    rec = dryrun.run_cell("granite-3-8b", "decode_t", "test",
                          cfg=granite_3_8b.reduced(), shape=shape,
                          mesh=_test_mesh(), device="cpu", out_dir=tmp_path,
                          verbose=False)
    import json
    got = json.loads((tmp_path / "granite-3-8b_decode_t_test.json")
                     .read_text())
    assert got["status"] == rec["status"] == "ok"
    for key in ("arch", "shape", "mesh", "tag", "remat", "chips", "flops",
                "hbm_bytes", "collective", "raw_cost_analysis",
                "memory_per_device", "peak_bytes_per_device", "fits_80g",
                "model_flops", "roofline", "lower_s", "compile_s"):
        assert key in got, key


# --- K5 as an opaque op ----------------------------------------------------


def _qkv(b=1, hq=4, hkv=2, s=24, d=16, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, hq, s, d), generator=g, dtype=dtype),
            torch.randn((b, hkv, s, d), generator=g, dtype=dtype),
            torch.randn((b, hkv, s, d), generator=g, dtype=dtype))


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("kv_len", [None, [20]])
def test_k5_op_opcheck(kv_len, grad):
    """``opcheck`` of both ops; with inputs that want a gradient it also
    checks the forward's Autograd kernel (``test_autograd_registration``,
    ``test_aot_dispatch_dynamic``)."""
    from torch.library import opcheck
    q, k, v = _qkv()
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    opcheck(torch.ops.repro_torch.flash_attention.default,
            tuple(t.detach().requires_grad_(grad) for t in (q, k, v))
            + (kvl, True, 8, 5.0, True))
    opcheck(torch.ops.repro_torch.flash_attention.default,
            (q, k, v, kvl, False, 0, 0.0, False),
            test_utils=("test_schema", "test_faketensor"))
    out, lse = k5.flash_attention_plain(q, k, v, kvl, return_lse=True)
    opcheck(torch.ops.repro_torch.flash_attention_bwd.default,
            (q, k, v, out, lse, torch.randn_like(q), kvl, True, 0, 0.0),
            test_utils=("test_schema", "test_faketensor"))


def test_k5_op_cpu_is_the_plain_version_and_its_gradient():
    q, k, v = (t.requires_grad_() for t in _qkv())
    out = k5.flash_attention(q, k, v, window=8, softcap=5.0)
    want, lse = k5.flash_attention_plain(q, k, v, window=8, softcap=5.0,
                                         return_lse=True)
    assert torch.equal(out, want)
    dout = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = k5.flash_attention_bwd_plain(q, k, v, want, lse, dout, window=8,
                                       softcap=5.0)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_k5_fake_shapes_and_checks():
    """The fake implementation (fake CUDA tensors: no card needed) gives
    the outputs' shapes and dtypes, launches nothing, and raises where the
    checks that need no data raise (``_check_static``: ``_check``'s rank,
    dtype, head dim and group, and k / v against q)."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="cuda")
    n = k5.flash_attention.launches
    with FakeTensorMode():
        q, k = t(2, 8, 32, 64), t(2, 2, 48, 64)
        out, lse = torch.ops.repro_torch.flash_attention(q, k, k, None, True,
                                                         0, 0.0, True)
        assert out.shape == q.shape and out.dtype == q.dtype
        assert lse.shape == (2, 8, 32) and lse.dtype == torch.float32
        assert out.device.type == "cuda"
        _, none = torch.ops.repro_torch.flash_attention(q, k, k, None, True,
                                                        0, 0.0, False)
        assert none.numel() == 0
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, k, out, lse, out, None, True, 0, 0.0)
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        bad = [(t(2, 8, 32, 48), t(2, 2, 48, 48), ValueError),     # head dim
               (t(2, 8, 32, 64, dtype=torch.float16),
                t(2, 2, 48, 64, dtype=torch.float16), TypeError),  # dtype
               (t(2, 6, 32, 64), t(2, 4, 48, 64), ValueError),     # group
               (t(8, 32, 64), t(2, 48, 64), ValueError),           # rank
               (q, t(2, 2, 48, 64, dtype=torch.float32), ValueError)]
        for bq, bk, exc in bad:
            with pytest.raises(exc):
                torch.ops.repro_torch.flash_attention(bq, bk, bk, None, True,
                                                      0, 0.0, True)
            with pytest.raises(exc):
                k5._check_static(bq, bk, bk, None, "flash_attention")
    assert k5.flash_attention.launches == n


def test_k5_flop_formula():
    from torch.utils.flop_counter import FlopCounterMode
    b, hq, hkv, s, d = 2, 4, 2, 24, 16
    q, k, v = _qkv(b, hq, hkv, s, d)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_attention(q, k, v, None, True, 0, 0.0,
                                              True)
    assert fc.get_total_flops() == 4 * b * hq * s * s * d
    assert k5.flops_fwd(q.shape, k.shape) == 4 * b * hq * s * s * d
    assert k5.flops_bwd(q.shape, k.shape) == 14 * b * hq * s * s * d


@pytest.mark.parametrize("dim", [0, 1])
def test_k5_on_a_mesh_runs_per_shard(dim):
    """On a fake 2-rank mesh, q, k and v sharded alike on batch (over
    `data`) or on heads (over `model`, 2 dividing Hkv) go through
    ``nn/attention.py::per_shard``: K5's op sees each rank's local
    tensors, the output keeps q's placement and so do the gradients;
    nothing is gathered."""
    from repro_torch.nn.attention import per_shard
    open_fake_group(2)
    axis = "data" if dim == 0 else "model"
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=(axis,))
    with FakeTensorMode() as fm:
        q, k, v = (distribute_tensor(t, mesh, [Shard(dim)],
                                     src_data_rank=None).requires_grad_()
                   for t in (torch.empty(2, 4, 16, 16),
                             torch.empty(2, 2, 16, 16),
                             torch.empty(2, 2, 16, 16)))

        def step():
            out = per_shard(k5.flash_attention, q, k, v)
            return out, torch.autograd.grad(out, (q, k, v), out.detach())
        (out, grads), cost = op_cost.count(step, fake_mode=fm)
        assert out.placements == (Shard(dim),)
        assert all(g.placements == (Shard(dim),) for g in grads)
    assert cost.collective_bytes == 0
    b_local, hq_local = (1, 4) if dim == 0 else (2, 2)
    local = 4 * b_local * hq_local * 16 * 16 * 16
    assert cost.dot_flops == local + 14 * local // 4


def test_fake_trace_of_a_training_step_runs_k5_ops_and_launches_nothing(
        monkeypatch):
    """The cuda tier's LM training step (remat none) under FakeTensorMode,
    the tier's device check lifted: one K5 forward op and one backward op
    per layer, and no launch counter moved."""
    monkeypatch.setattr(ops, "_check_tier", lambda backend, t: None)
    from repro_torch.models import transformer as ttr
    monkeypatch.setattr(ttr.Block, "forward", _cuda_tier(ttr.Block.forward))
    cfg = dataclasses.replace(granite_3_8b.reduced(), num_layers=3)
    opt = tcfg.OptimizerConfig()
    n = (k5.flash_attention.launches, k5.flash_attention_bwd.launches)
    with FakeTensorMode() as fm:
        model = TransformerLM(cfg, device="meta")
        state = make_train_state({k: torch.empty(p.shape, dtype=p.dtype)
                                  for k, p in model.named_parameters()}, opt)
        toks = torch.zeros((2, 64), dtype=torch.int32)
        _, cost = op_cost.count(make_train_step(cfg, opt), state,
                                {"tokens": toks, "labels": toks},
                                fake_mode=fm)
    assert cost.counts["repro_torch.flash_attention"] == cfg.num_layers
    assert cost.counts["repro_torch.flash_attention_bwd"] == cfg.num_layers
    assert (k5.flash_attention.launches,
            k5.flash_attention_bwd.launches) == n
    top = [op for _, _, op, _ in op_cost.top_ops(cost, "flops", 40)]
    assert "repro_torch.flash_attention" in top


def _cuda_tier(forward):
    def run(self, x, cfg, **kw):
        kw["attn_impl"] = "cuda"
        return forward(self, x, cfg, **kw)
    return run
