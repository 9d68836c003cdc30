"""Abstract inputs, parameters and caches, and their placements, per (arch
x shape) (``repro/launch/specs.py``).

Nothing here allocates: parameters come from the real modules built on
the ``meta`` device (the reference's ``jax.eval_shape`` over its
initializers), inputs are ``meta`` tensors (its ``ShapeDtypeStruct``s),
and placements are divisibility-guarded DTensor placement lists (its
``PartitionSpec`` trees).  ``launch/dryrun.py`` turns these into the
DTensors of one traced step a cell.

Sharding policy (the reference's):
  * params: FSDP over (pod, data) on the d_model-ish dim + TP over `model`
    on heads / FFN / vocabulary / experts (Megatron layout), guarded by
    divisibility;
  * batch inputs: (pod, data); batch == 1 long-context puts the sequence
    on `data`;
  * KV caches: batch -> data, sequence -> model (decode_32k) or
    sequence -> (data, model) (long_500k, batch 1); SSM states: heads ->
    model.

The reference keys its rules on stacked paths (``blocks/pos{j}/attn/wq/w``
with a leading ``n_rep`` dim; ``enc/``, ``dec/`` with a leading layer
dim).  The port's parameters are per layer, named as ``models/
transformer.py::flatten_reference`` and ``models/encdec.py::
flatten_reference`` map the reference's leaves onto them, in the same
layouts; so each rule here is the reference's on the port's name, and a
parameter's placements are its reference leaf's spec without the stacked
dim.  Specs are tuples (one entry per dim: None, an axis name or a tuple
of names); ``launch/sharding.py::spec_to_placements`` makes placements.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import LMConfig, OptimizerConfig, ShapeSpec
from repro_torch.launch.mesh import fsdp_axes, mesh_shape
from repro_torch.launch.sharding import spec_to_placements
from repro_torch.models import encdec as encdec_lib
from repro_torch.models.transformer import (DTYPES, TransformerLM,
                                            init_caches_abstract)
from repro_torch.optim.optimizer import TrainState, moment_dtype

#: patch-embedding positions a VLM cell's inputs carry (the reference's
#: ``VLM_PATCH_TOKENS``; ``configs/internvl2_1b.py::NUM_PATCH_TOKENS``)
VLM_PATCH_TOKENS = 256

_META = torch.device("meta")


# ---------------------------------------------------------------------------
# Abstract parameters / optimizer state
# ---------------------------------------------------------------------------


def abstract_model(cfg: LMConfig):
    """The family's model on the ``meta`` device: the real initializers'
    shapes and dtypes, no storage."""
    if cfg.family == "audio":
        return encdec_lib.EncDecLM(cfg, device=_META)
    return TransformerLM(cfg, device=_META)


def abstract_params(cfg: LMConfig) -> Dict[str, torch.Tensor]:
    """``{parameter name: meta tensor}``, the model's parameters."""
    return {n: p.detach() for n, p in
            abstract_model(cfg).named_parameters()}


def abstract_state(cfg: LMConfig, opt: OptimizerConfig) -> TrainState:
    """The ``TrainState`` of ``make_train_state`` as meta tensors: step,
    parameters, and moments in ``opt.moment_dtype``."""
    p = abstract_params(cfg)
    mdt = moment_dtype(opt)
    mom = {k: torch.empty(v.shape, dtype=mdt, device=_META)
           for k, v in p.items()}
    return TrainState(step=torch.empty((), dtype=torch.int32, device=_META),
                      params=p, m=mom, v=dict(mom))


# ---------------------------------------------------------------------------
# Parameter specs (name-based rules + divisibility guard)
# ---------------------------------------------------------------------------


def _guard(parts, shape, mesh) -> tuple:
    """Each dim's mesh axes, kept where the dim divides by their product
    and the mesh has them (``_guard``)."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        axes = tuple(a for a in axes if a in sizes)
        size = math.prod(sizes[a] for a in axes) if axes else 1
        if not axes or dim % size != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def _param_rule(name: str, ndim: int, fsdp) -> Tuple:
    """Per-dim mesh-axis parts of the port's parameter ``name``
    (``_param_rule`` on the reference's path of the same leaf)."""
    m = "model"
    last = name.rsplit(".", 1)[-1]
    if name.endswith(("embed.table", "lm_head.table")):
        return (m, fsdp)
    if last in ("wq", "wk", "wv"):
        return (fsdp, m)
    if ".moe." in name and ndim == 3:
        if last in ("wi", "wg"):
            return (m, fsdp, None)
        if last == "wo":
            return (m, None, fsdp)
    if last in ("wi", "wg"):
        return (fsdp, m)
    if last == "wo":
        return (m, fsdp)
    if last == "router":
        return (fsdp, None)
    if last in ("in_proj", "z_proj", "xbc_proj", "dt_proj"):
        return (fsdp, m)
    if last == "out_proj":
        return (m, fsdp)
    if last == "conv_w":
        return (m, None)
    return tuple(None for _ in range(ndim))


def param_spec(name: str, shape, mesh, attn_tp: bool = True) -> tuple:
    """The spec of one parameter (the reference leaf's, stacked dim
    dropped).  ``attn_tp=False`` (head count does not divide the `model`
    axis): rank-2 weights FSDP only, tables FSDP on the vocabulary, so
    activations can run context-parallel; experts keep EP."""
    fsdp = fsdp_axes(mesh)
    fsdp = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    parts = _param_rule(name, len(shape), fsdp)
    if not attn_tp:
        if name.endswith(("embed.table", "lm_head.table")):
            parts = (fsdp, None)
        elif len(shape) == 2:
            parts = (fsdp, None)
    if len(parts) != len(shape):  # scalar-ish leaves
        parts = tuple(None for _ in shape)
    return _guard(parts, shape, mesh)


def param_pspecs(params, mesh, attn_tp: bool = True) -> Dict[str, list]:
    """``{parameter name: placements}`` for a dict of (abstract or real)
    parameters (``param_pspecs``)."""
    return {n: spec_to_placements(param_spec(n, p.shape, mesh, attn_tp),
                                  mesh)
            for n, p in params.items()}


def arch_attn_tp(cfg: LMConfig, mesh) -> bool:
    a = cfg.attention
    return a is None or a.num_heads % mesh_shape(mesh).get("model", 1) == 0


def state_pspecs(state: TrainState, mesh, attn_tp: bool = True
                 ) -> TrainState:
    """The placements of a ``TrainState``: the step replicated, the
    moments as their parameters (``state_pspecs``)."""
    ps = param_pspecs(state.params, mesh, attn_tp)
    return TrainState(step=spec_to_placements((), mesh), params=ps,
                      m=dict(ps), v=dict(ps))


# ---------------------------------------------------------------------------
# Input specs per (arch, shape)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def _batch_part(mesh, b: int):
    sizes = mesh_shape(mesh)
    axes = fsdp_axes(mesh)
    size = math.prod(sizes[a] for a in axes)
    if b % size == 0:
        return axes if len(axes) > 1 else axes[0]
    if "data" in sizes and b % sizes["data"] == 0:
        return "data"
    return None


def _seq_part_for_long(mesh):
    return "data" if "data" in mesh.mesh_dim_names else None


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell
    (``input_specs``); a decode cell's ``caches`` are the port's list of
    per-layer pairs (``init_caches_abstract``)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = DTYPES[cfg.dtype]
    d = cfg.d_model
    if cfg.family == "audio":
        frames = _meta((b, min(s, 4096), d), dt)
        if shape.kind == "train":
            return {"frames": frames, "tokens": _meta((b, s), i32),
                    "labels": _meta((b, s), i32)}
        if shape.kind == "prefill":
            return {"frames": frames, "tokens": _meta((b, s), i32)}
        return {"token": _meta((b, 1), i32),
                "caches": encdec_lib.init_dec_caches_abstract(cfg, b, s),
                "memory": _meta((b, min(s, 4096), d), dt),
                "length": _meta((), i32)}
    embeds = None
    n_tok = s
    if cfg.frontend_stub:  # vlm: patch embeddings take the first positions
        embeds = _meta((b, VLM_PATCH_TOKENS, d), dt)
        n_tok = s - VLM_PATCH_TOKENS
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta((b, n_tok), i32)}
        if shape.kind == "train":
            out["labels"] = _meta((b, n_tok), i32)
        if embeds is not None:
            out["embeds"] = embeds
        return out
    return {"token": _meta((b, 1), i32),
            "caches": init_caches_abstract(cfg, b, s),
            "length": _meta((), i32)}


def _input_spec_tree(cfg: LMConfig, shape: ShapeSpec, mesh) -> Dict:
    b = shape.global_batch
    bp = _batch_part(mesh, b)
    long_ctx = b == 1
    out: Dict[str, Any] = {}
    for k, v in input_specs(cfg, shape).items():
        if k in ("tokens", "labels"):
            out[k] = (None, _seq_part_for_long(mesh)) if long_ctx \
                else (bp, None)
        elif k in ("embeds", "frames", "memory"):
            out[k] = (bp, None, None)
        elif k == "token":
            out[k] = (bp, None)
        elif k == "length":
            out[k] = ()
        elif k == "caches":
            out[k] = [tuple(_cache_spec(t.shape, mesh=mesh,
                                        long_ctx=long_ctx, bp=bp)
                            for t in pair) for pair in v]
    return out


def input_pspecs(cfg: LMConfig, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    """Each input's placements (``input_pspecs``); ``caches`` a list of
    per-layer pairs of placements."""
    tree = _input_spec_tree(cfg, shape, mesh)
    return {k: ([tuple(spec_to_placements(s, mesh) for s in pair)
                 for pair in v] if k == "caches"
                else spec_to_placements(v, mesh))
            for k, v in tree.items()}


def serve_out_pspecs(cfg: LMConfig, shape: ShapeSpec, mesh):
    """The placements of a prefill or decode step's outputs: (logits,
    caches, [memory,] length) (``serve_out_pspecs``): the caches leave
    the step placed as the decode step takes them."""
    b, s = shape.global_batch, shape.seq_len
    bp = _batch_part(mesh, b)
    long_ctx = b == 1
    vp = "model" if cfg.padded_vocab % mesh_shape(mesh).get("model", 1) \
        == 0 else None
    place = lambda spec: spec_to_placements(spec, mesh)  # noqa: E731
    logits, length = place((bp, None, vp)), place(())
    raw = encdec_lib.init_dec_caches_abstract(cfg, b, s) \
        if cfg.family == "audio" else init_caches_abstract(cfg, b, s)
    caches = [tuple(place(_cache_spec(t.shape, mesh=mesh, long_ctx=long_ctx,
                                      bp=bp)) for t in pair) for pair in raw]
    if cfg.family == "audio" and shape.kind == "prefill":
        return (logits, caches, place((bp, None, None)), length)
    return (logits, caches, length)


def _cache_spec(shape, *, mesh, long_ctx: bool, bp) -> tuple:
    """The spec of one layer's cache tensor (``_cache_pspec`` on the
    stacked leaf, whose leading layer dim the port's per-layer tensors do
    not have; the reference's tests on the stacked rank are the same tests
    on rank + 1, kept with their quirk: an SSM state whose d_state is 128
    or more takes the KV rule)."""
    sizes = mesh_shape(mesh)
    batch = bp if not long_ctx else None
    if len(shape) == 4 and shape[-1] != 0 and shape[-2] >= 128:
        # KV cache (B, Hkv, S, hd): seq -> model (+data when batch=1)
        seq = ("data", "model") if long_ctx else ("model",)
        seq = tuple(a for a in seq if a in sizes)
        size = math.prod(sizes[a] for a in seq) if seq else 1
        seq_part = (seq if len(seq) > 1 else seq[0]) if seq and \
            shape[2] % size == 0 else None
        return (batch, None, seq_part, None)
    if len(shape) == 4:
        # SSM state (B, H, N, P): heads -> model
        hp = "model" if shape[1] % sizes["model"] == 0 else None
        return (batch, hp, None, None)
    if len(shape) == 3:
        # conv tail (B, conv_dim, K-1)
        return (batch, None, None)
    return tuple(None for _ in shape)
