"""Logical-axis sharding rules and activation constraints
(``repro/launch/sharding.py``).

Models annotate activations with LOGICAL axis names; this module maps them
to mesh axes by the active rule set and places DTensors accordingly.  A
reference ``PartitionSpec`` becomes a DTensor placement list, one
``Shard(d)`` or ``Replicate()`` per mesh dim; a tensor dim sharded over
several mesh axes (``("pod", "data")``) is a ``Shard(d)`` on each, pod
outermost, as the reference's major-to-minor order.  Without an active
mesh, or on a plain tensor, every annotation is a no-op, so the same model
code runs single-device tests, one-card runs and the 512-rank dry run.

Default rules (``DEFAULT_RULES``, copied from the reference):
  batch    -> ("pod", "data")     (DP/FSDP axes)
  seq      -> ("model",)          (Megatron sequence parallelism between
                                   blocks; long_500k remaps it)
  seq_q    -> None                (context-parallel attention: ("model",))
  embed    -> None                (activation d_model replicated)
  heads    -> "model", kv_heads -> "model" (when divisible)
  mlp, experts, vocab -> "model"; expert_cap -> ("pod", "data")
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch.mesh import mesh_shape

_state = threading.local()

DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    # Megatron-style sequence parallelism: the residual stream (and with it
    # every saved-for-backward layer carry) is sharded over `model` between
    # blocks; attention/MLP gather it on entry and the TP all-reduce after
    # each block becomes a reduce-scatter.  Same collective bytes, 1/tp the
    # activation memory.
    "seq": ("model",),
    "seq_q": None,   # context-parallel attention: remapped to ("model",)
    "embed": None,   # for archs whose head count doesn't divide the TP axis
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_cap": ("pod", "data"),
    "vocab": ("model",),
    "state": None,
}


def rules_for(cfg, mesh: DeviceMesh) -> Dict[str, Optional[Tuple[str, ...]]]:
    """Per-arch rule overrides (``rules_for``): where the head count does
    not divide the `model` axis (internvl2 14 heads, arctic 56), the
    context-parallel profile -- q's sequence dim over `model`, K/V and the
    FFN model-replicated."""
    rules = dict(DEFAULT_RULES)
    tp = mesh_shape(mesh).get("model", 1)
    a = getattr(cfg, "attention", None)
    if a is not None and (a.num_heads % tp != 0):
        rules["heads"] = None
        rules["kv_heads"] = None
        rules["seq"] = ("model",)
        rules["seq_q"] = ("model",)
        rules["mlp"] = None
        rules["vocab"] = None
    return rules


def _current():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def sharding_rules(mesh: DeviceMesh, rules: Optional[Dict] = None):
    """Activate a mesh and its logical rules for the models' constraints
    (thread-local); mesh axes the mesh does not have are dropped (a
    single-pod mesh has no "pod").  Inside, a plain tensor that meets a
    DTensor in an op (a position table, a mask, a scalar of the update)
    counts as replicated (``implicit_replication``), as a constant is in
    the reference's GSPMD program."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    names = set(mesh.mesh_dim_names)
    clean = {}
    for k, v in merged.items():
        kept = tuple(a for a in v if a in names) if v else ()
        clean[k] = kept or None
    prev = _current()
    _state.ctx = (mesh, clean)
    try:
        with implicit_replication():
            yield
    finally:
        _state.ctx = prev


def current():
    """The active (mesh, rules) context, or None: what ``restored`` puts
    back on another thread (the autograd engine runs a CUDA backward, and
    with it a checkpoint's recompute, on a thread of its own)."""
    return _current()


@contextlib.contextmanager
def restored(ctx):
    """Make ``ctx`` (``current()``'s value) the active context on this
    thread for the block."""
    prev = _current()
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def active_mesh() -> Optional[DeviceMesh]:
    """The mesh of the active ``sharding_rules`` context, or None."""
    ctx = _current()
    return None if ctx is None else ctx[0]


def spec_to_placements(spec, mesh: DeviceMesh) -> List[Placement]:
    """A reference-style spec -- one entry per tensor dim, each None, a
    mesh axis name or a tuple of them -- as a DTensor placement list over
    ``mesh``.  Where several tensor dims name mesh axes, each mesh dim
    takes the dim that names it."""
    out: List[Placement] = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            out[names.index(ax)] = Shard(dim)
    return out


def logical_to_spec(axes: Tuple[Optional[str], ...]) -> List[Placement]:
    """The placements the active rules give logical ``axes``, one entry
    per tensor dim (``logical_to_spec``, which returns a
    ``PartitionSpec``), without ``constrain``'s divisibility guard."""
    ctx = _current()
    assert ctx is not None
    mesh, rules = ctx
    return spec_to_placements(tuple(None if a is None else rules.get(a)
                                    for a in axes), mesh)


def _constrained_spec(shape, axes, mesh: DeviceMesh, rules) -> tuple:
    sizes = mesh_shape(mesh)
    parts = []
    used: set = set()
    for i, a in enumerate(axes):
        r = rules.get(a) if a is not None else None
        if r:  # a mesh axis may appear once per spec; first dim wins
            r = tuple(ax for ax in r if ax not in used)
        if not r:
            parts.append(None)
            continue
        size = 1
        for ax in r:
            size *= sizes[ax]
        if shape[i] % size != 0:
            parts.append(None)
        else:
            used.update(r)
            parts.append(r if len(r) > 1 else r[0])
    return tuple(parts)


class _Pin(torch.autograd.Function):
    """Identity forward; the backward lays the gradient out as the forward
    value was (the transpose of a sharding constraint is the same
    constraint on the cotangent, as in the reference's
    ``with_sharding_constraint``), so a DTensor program's backward keeps
    the forward's layouts rather than whatever a strategy picked."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, list(ctx.placements))
        return g, None


def _place(x, mesh, want):
    if tuple(x.placements) != tuple(want):
        x = x.redistribute(mesh, want)
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _Pin.apply(x, tuple(want))


def constrain_as(x, shape, *axes: Optional[str]):
    """``constrain`` of the DTensor ``x`` by the placements a tensor of
    ``shape`` (x's shape before a view that splits a dim, as (B, S, H) is
    to (B, S, H * D)) takes under ``axes``: a view then splits the dim
    along shard boundaries.  A no-op where ``constrain`` is one."""
    ctx = _current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    return _place(x, mesh, spec_to_placements(
        _constrained_spec(shape, axes, mesh, rules), mesh))


def constrain(x, *axes: Optional[str]):
    """``with_sharding_constraint`` by logical axis names: the DTensor
    ``x`` redistributed to the placements the active rules give; a no-op
    without an active mesh or on a plain tensor.

    ``axes`` has one entry per dim of x; None leaves a dim unsharded.
    Divisibility guard: a dim that does not divide by its mesh axes'
    product stays unsharded (8 KV heads on a 16-way `model` axis are
    replicated, the documented fallback), and a mesh axis shards at most
    one dim, the first that asks for it.  The gradient is laid out the
    same way (``_Pin``), as the reference's constraint binds both
    directions."""
    ctx = _current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    if len(axes) != x.dim():
        raise ValueError(f"constrain: {len(axes)} axes for a {x.dim()}-D "
                         f"tensor")
    return _place(x, mesh, spec_to_placements(
        _constrained_spec(x.shape, axes, mesh, rules), mesh))


class NamedSharding(NamedTuple):
    """A mesh and a DTensor placement list: where a tensor lives (the
    reference's ``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    placements: Tuple[Placement, ...]

    def place(self, t):
        """``t`` (a tensor, or numpy) as a DTensor of these placements.
        Every rank holds the whole ``t`` (the weights drawn from one seed,
        a batch from (seed, step)), so each takes its own shard and
        nothing is sent (``src_data_rank=None``)."""
        t = torch.as_tensor(t)
        dev = torch.device(self.mesh.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return distribute_tensor(t.to(dev), self.mesh,
                                 list(self.placements), src_data_rank=None)


def named_sharding(mesh: DeviceMesh, *parts) -> NamedSharding:
    """The sharding of the spec ``parts`` on ``mesh`` (the reference's
    ``NamedSharding(mesh, P(*parts))``)."""
    return NamedSharding(mesh, tuple(spec_to_placements(parts, mesh)))


def named(mesh: DeviceMesh, tree):
    """Placement lists in ``tree`` (dicts, lists, ``TrainState``) as
    ``NamedSharding``s on ``mesh`` (the reference's ``specs.named``)."""
    if isinstance(tree, dict):
        return {k: named(mesh, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(named(mesh, v) for v in tree))
    if isinstance(tree, (list, tuple)) and tree and \
            not isinstance(tree[0], Placement):
        return type(tree)(named(mesh, v) for v in tree)
    return NamedSharding(mesh, tuple(tree))


def ctx_mesh_axes():
    """(mesh, batch_axes, seq_axes) under an active sharding context, for
    modules that build explicit per-shard regions (MoE EP)."""
    ctx = _current()
    if ctx is None:
        return None
    mesh, rules = ctx
    return mesh, tuple(rules.get("batch") or ()), tuple(rules.get("seq")
                                                        or ())


class _CtxInfo:
    def __init__(self, mesh, tp, batch):
        self.mesh, self.tp, self.batch = mesh, tp, batch


def ctx_parallel_info():
    """Non-None when the active rules ask for context-parallel attention."""
    ctx = _current()
    if ctx is None:
        return None
    mesh, rules = ctx
    if rules.get("seq_q") and "model" in mesh.mesh_dim_names:
        return _CtxInfo(mesh, mesh_shape(mesh)["model"],
                        tuple(rules.get("batch") or ()))
    return None
