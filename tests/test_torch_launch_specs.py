"""The launch layer's specs against the reference's, on the CPU.

``repro_torch.launch.specs`` gives each port parameter, input, cache and
serving output its DTensor placements; ``repro.launch.specs`` gives the
reference's leaves ``PartitionSpec``s on an ``AbstractMesh`` (no
devices).  The reference's stacked leaves map onto the port's per-layer
parameters through ``flatten_reference`` (its leading stacked dim
dropped), and every placement must match exactly, for the ten archs on
both production meshes.  The reference's ``tests/test_specs.py`` cases are
ported beside them.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import config as rcfg
from repro.configs import ASSIGNED_ARCHS
from repro.launch import sharding as rshard
from repro.launch import specs as rspecs
from repro_torch import config as tcfg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshard
from repro_torch.launch import specs as tspecs
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttrans

MESHES = ["single", "multi"]


class FakeMesh:
    """What the port's spec functions read of a DeviceMesh (axis names and
    sizes), for a production mesh without its process group."""

    def __init__(self, multi: bool):
        self.shape, self.mesh_dim_names = tmesh.production_shape(multi)
        self.ndim = len(self.shape)

    def size(self, i):
        return self.shape[i]


def _ref_mesh(multi: bool):
    sizes, names = tmesh.production_shape(multi)
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def _norm(part):
    """A spec entry as None, a name or a tuple of names."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return part[0] if len(part) == 1 else (part or None)
    return part


def _spec(p, ndim):
    parts = tuple(_norm(x) for x in tuple(p))
    return parts + (None,) * (ndim - len(parts))


class _Leaf:
    """A reference spec leaf that ``flatten_into`` can slice: slice i of
    a stacked leaf is its spec without the stacked dim."""

    def __init__(self, spec):
        self.spec = spec

    def __getitem__(self, i):
        return _Leaf(self.spec[1:])


def _ref_param_specs(cfg_name, multi):
    rc = rcfg.get_config(cfg_name)
    mesh = _ref_mesh(multi)
    params = rspecs.abstract_params(rc)
    specs = rspecs.param_pspecs(params, mesh, rspecs.arch_attn_tp(rc, mesh))
    tree = jax.tree.map(lambda leaf, s: _Leaf(_spec(s, len(leaf.shape))),
                        params, specs,
                        is_leaf=lambda x: isinstance(x, jax.sharding.
                                                     PartitionSpec))
    tc = tcfg.get_config(cfg_name)
    flat = (tencdec.flatten_reference(tree, tc) if tc.family == "audio"
            else ttrans.flatten_reference(tree, tc))
    return {k: v.spec for k, v in flat.items()}


@pytest.mark.parametrize("multi", [False, True], ids=MESHES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(arch, multi):
    """Every port parameter's spec and placements are the reference
    leaf's, leaf for leaf; no parameter is missing on either side."""
    want = _ref_param_specs(arch, multi)
    cfg = tcfg.get_config(arch)
    mesh = FakeMesh(multi)
    params = tspecs.abstract_params(cfg)
    assert set(params) == set(want)
    attn_tp = tspecs.arch_attn_tp(cfg, mesh)
    placed = tspecs.param_pspecs(params, mesh, attn_tp)
    for name, p in params.items():
        got = tspecs.param_spec(name, p.shape, mesh, attn_tp)
        assert got == want[name], (name, got, want[name])
        assert placed[name] == tshard.spec_to_placements(want[name], mesh)
        assert p.device.type == "meta"


@pytest.mark.parametrize("multi", [False, True], ids=MESHES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_state_specs_match_reference(arch, multi):
    """The train state: step replicated, moments placed as their
    parameters, in the moment dtype the reference's default picks."""
    from repro_torch.launch.dryrun import default_opt
    cfg = tcfg.get_config(arch)
    mesh = FakeMesh(multi)
    opt = default_opt(cfg)
    state = tspecs.abstract_state(cfg, opt)
    specs = tspecs.state_pspecs(state, mesh, tspecs.arch_attn_tp(cfg, mesh))
    rc = rcfg.get_config(arch)
    rstate = rspecs.abstract_state(rc, rspecs.OptimizerConfig(
        moment_dtype=opt.moment_dtype))
    want = _ref_param_specs(arch, multi)
    assert specs.step == tshard.spec_to_placements((), mesh)
    for name in want:
        w = tshard.spec_to_placements(want[name], mesh)
        assert specs.params[name] == specs.m[name] == specs.v[name] == w
        assert str(state.m[name].dtype).removeprefix("torch.") == \
            str(jax.tree.leaves(rstate.m)[0].dtype)


def _cells():
    return [(a, s.name) for a in ASSIGNED_ARCHS
            for s in rcfg.get_config(a).shapes()]


def _ref_caches_per_layer(tree, cfg):
    """The reference's stacked cache tree as the port's list of per-layer
    pairs (leaf, stacked dim dropped by the caller)."""
    if cfg.family == "audio":
        return [(("k", i), ("v", i)) for i in range(cfg.num_layers)]
    period = len(ttrans.layer_positions(cfg))
    out = []
    for n in range(cfg.num_layers):
        node = tree[f"pos{n % period}"]
        keys = ("k", "v") if "k" in node else ("state", "conv")
        out.append(tuple((f"pos{n % period}", k, n // period)
                         for k in keys))
    return out


def _pick(tree, path, cfg):
    if cfg.family == "audio":
        key, i = path
        return tree[key], i
    pos, key, i = path
    return tree[pos][key], i


@pytest.mark.parametrize("multi", [False, True], ids=MESHES)
@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_and_pspecs_match_reference(arch, shape, multi):
    """Every input of every runnable cell: shape and dtype, then
    placements; caches layer by layer; and the serving outputs'."""
    cfg, rc = tcfg.get_config(arch), rcfg.get_config(arch)
    sh, rsh = tcfg.SHAPES_BY_NAME[shape], rcfg.SHAPES_BY_NAME[shape]
    mesh, rmesh = FakeMesh(multi), _ref_mesh(multi)
    got, want = tspecs.input_specs(cfg, sh), rspecs.input_specs(rc, rsh)
    gotp, wantp = tspecs.input_pspecs(cfg, sh, mesh), \
        rspecs.input_pspecs(rc, rsh, rmesh)
    assert set(got) == set(want) == set(gotp) == set(wantp)
    place = lambda s, nd: tshard.spec_to_placements(_spec(s, nd), mesh)  # noqa
    for k in got:
        if k == "caches":
            paths = _ref_caches_per_layer(want[k], cfg)
            assert len(got[k]) == len(paths)
            for pair, ppair, path in zip(got[k], gotp[k], paths):
                for t, pl, p in zip(pair, ppair, path):
                    leaf, i = _pick(want[k], p, cfg)
                    spec, _ = _pick(wantp[k], p, cfg)
                    assert tuple(t.shape) == leaf.shape[1:]
                    assert str(t.dtype).removeprefix("torch.") == \
                        str(leaf.dtype)
                    assert pl == place(tuple(spec)[1:], t.dim())
            continue
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == \
            str(want[k].dtype), k
        assert gotp[k] == place(wantp[k], got[k].dim()), k
    if sh.kind == "train":
        return
    outs = tspecs.serve_out_pspecs(cfg, sh, mesh)
    routs = rspecs.serve_out_pspecs(rc, rsh, rmesh)
    assert len(outs) == len(routs)
    assert outs[0] == place(routs[0], 3)
    assert outs[-1] == place(routs[-1], 0)
    if len(outs) == 4:
        assert outs[2] == place(routs[2], 3)
    raw = tspecs.input_specs(cfg, rcfg.ShapeSpec(
        shape, sh.seq_len, sh.global_batch, "decode"))["caches"]
    for pair, ppair, path in zip(raw, outs[1],
                                 _ref_caches_per_layer(routs[1], cfg)):
        for t, pl, p in zip(pair, ppair, path):
            spec, _ = _pick(routs[1], p, cfg)
            assert pl == place(tuple(spec)[1:], t.dim())


@pytest.mark.parametrize("multi", [False, True], ids=MESHES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_rules_for_match_reference(arch, multi):
    got = tshard.rules_for(tcfg.get_config(arch), FakeMesh(multi))
    want = rshard.rules_for(rcfg.get_config(arch), _ref_mesh(multi))
    assert got == want
    assert tshard.DEFAULT_RULES == rshard.DEFAULT_RULES


def test_vlm_patch_tokens_agree():
    from repro_torch.configs import internvl2_1b
    assert tspecs.VLM_PATCH_TOKENS == rspecs.VLM_PATCH_TOKENS == \
        internvl2_1b.NUM_PATCH_TOKENS


# --- the reference's tests/test_specs.py, ported --------------------------


def test_cell_enumeration_is_40():
    cells = [(a, s.name) for a in ASSIGNED_ARCHS for s in tcfg.ALL_SHAPES]
    assert len(cells) == 40
    runnable = [(a, s.name) for a in ASSIGNED_ARCHS
                for s in tcfg.get_config(a).shapes()]
    assert 40 - len(runnable) == 7  # 7 archs skip long_500k


@pytest.mark.parametrize("arch", ["granite-3-8b", "kimi-k2-1t-a32b",
                                  "mamba2-2.7b", "internvl2-1b"])
def test_param_pspecs_divisibility(arch):
    """Every sharded dim divides by its mesh axes' product."""
    cfg = tcfg.get_config(arch)
    mesh = FakeMesh(False)
    sizes = tmesh.mesh_shape(mesh)
    attn_tp = tspecs.arch_attn_tp(cfg, mesh)
    for name, p in tspecs.abstract_params(cfg).items():
        for dim, part in zip(p.shape, tspecs.param_spec(name, p.shape, mesh,
                                                        attn_tp)):
            if part is None:
                continue
            axes = part if isinstance(part, tuple) else (part,)
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0


def test_moe_experts_sharded():
    cfg = tcfg.get_config("kimi-k2-1t-a32b")
    mesh = FakeMesh(False)
    wi = tspecs.abstract_params(cfg)["layers.0.moe.wi"]
    assert tspecs.param_spec("layers.0.moe.wi", wi.shape, mesh)[0] == "model"


def test_ctx_profile_for_indivisible_heads():
    mesh = FakeMesh(False)
    assert not tspecs.arch_attn_tp(tcfg.get_config("internvl2-1b"), mesh)
    assert not tspecs.arch_attn_tp(tcfg.get_config("arctic-480b"), mesh)
    assert tspecs.arch_attn_tp(tcfg.get_config("deepseek-67b"), mesh)


def test_padded_vocab_shards():
    for arch in ASSIGNED_ARCHS:
        cfg = tcfg.get_config(arch)
        assert cfg.padded_vocab % 256 == 0
        assert 0 <= cfg.padded_vocab - cfg.vocab_size < 256


def test_spec_placements_and_the_rules_context():
    """A spec's placements (a dim over ("pod", "data") is a Shard of it on
    both mesh dims); ``logical_to_spec``, ``ctx_mesh_axes`` and
    ``ctx_parallel_info`` under ``sharding_rules`` and off it."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(True)
    assert tshard.spec_to_placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert tshard.spec_to_placements((None, "model"), mesh) == \
        [Replicate(), Replicate(), Shard(1)]
    assert tshard.ctx_mesh_axes() is None
    assert tshard.ctx_parallel_info() is None
    single = FakeMesh(False)
    with tshard.sharding_rules(single):
        assert tshard.logical_to_spec(("batch", "seq", "embed")) == \
            [Shard(0), Shard(1)]
        assert tshard.ctx_mesh_axes() == (single, ("data",), ("model",))
        assert tshard.ctx_parallel_info() is None
    rules = tshard.rules_for(tcfg.get_config("arctic-480b"), single)
    with tshard.sharding_rules(single, rules):
        info = tshard.ctx_parallel_info()
        assert info.tp == 16 and info.batch == ("data",)
    assert tshard.ctx_mesh_axes() is None
    sh = tshard.named_sharding(mesh, "model", None)
    assert sh.mesh is mesh and list(sh.placements) == \
        tshard.spec_to_placements(("model", None), mesh)
    assert all(isinstance(t, torch.Tensor) for t in
               tspecs.input_specs(tcfg.get_config("gemma-7b"),
                                  tcfg.SHAPES_BY_NAME["train_4k"]).values())
