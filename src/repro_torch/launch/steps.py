"""The LM step functions (``repro/launch/steps.py``): training,
evaluation, prefill and decode, for both families the port runs --
decoder stacks (``models/transformer.py``), whose VLM batches carry the
frontend's patch ``embeds`` (``models/vlm.py``), and the audio family's
enc-dec stack (``models/encdec.py``), whose batches carry the encoder's
``frames``.

``make_train_step`` returns ``(TrainState, batch) -> (TrainState,
metrics)``: the loss and its gradients over the state's parameters, then
one AdamW update (``optim/optimizer.py::adamw_update``).  The state's
``params`` are the model's parameters by name (``dict(
model.named_parameters())``, detached), which ``make_train_state``,
``train/trainer.py::Trainer`` and ``checkpoint/`` take as they are; the
loss runs over them through ``torch.func.functional_call`` on a module
that holds only the structure (on the ``meta`` device).  A batch is a
dict of numpy arrays or tensors (``tokens``, ``labels``, ``embeds``,
``frames``), moved to the parameters' device.

``make_prefill_step`` and ``make_decode_step`` take the model itself in
the reference's ``params`` place: ``(model, batch)`` with ``tokens`` (and
``embeds`` or ``frames``), then ``token``, ``caches``, ``length`` (and the
encoder's ``memory``).  The serving engine (``serve/``) drives the
decoder family's own prefill and decode.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import LMConfig, OptimizerConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models.transformer import (DTYPES, TransformerLM,
                                            lm_decode_step, lm_loss,
                                            lm_prefill)
from repro_torch.optim.optimizer import TrainState, adamw_update


def _on_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Each entry as a tensor on ``device``, but a decode batch's
    ``caches`` (a list of tensor pairs) and a DTensor (already placed on
    its mesh), which stay as they are."""
    return {k: v if k == "caches" or isinstance(v, DTensor)
            else torch.as_tensor(v).to(device) for k, v in batch.items()}


def _skeleton(cfg: LMConfig):
    """The family's model on the ``meta`` device: structure only."""
    if cfg.family == "audio":
        return encdec_lib.EncDecLM(cfg, device="meta")
    return TransformerLM(cfg, device="meta")


def _loss(cfg: LMConfig, skel, batch, params, remat: str = "none"):
    """The family's loss over ``params`` by name: ``encdec_loss`` of the
    batch's frames, tokens and labels for the audio family (whose layers
    are always rematerialized, as the reference's), else ``lm_loss``."""
    if cfg.family == "audio":
        return encdec_lib.encdec_loss(skel, batch["frames"], batch["tokens"],
                                      batch["labels"], params=params)
    return lm_loss(skel, batch["tokens"], batch["labels"],
                   batch.get("embeds"), remat=remat, params=params)


def make_loss_and_grads(cfg: LMConfig, remat: str = "none") -> Callable:
    """(params, batch) -> (gradients by name, metrics with the ``loss``):
    the family's loss and its gradients over ``params``, the part of
    ``make_train_step`` before the update.  The batch must already be on
    the parameters' device (or placed on their mesh)."""
    skel = _skeleton(cfg)

    def loss_and_grads(params, batch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss, metrics = _loss(cfg, skel, batch, leaves, remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return dict(zip(leaves, grads)), metrics

    return loss_and_grads


def make_train_step(cfg: LMConfig, opt: OptimizerConfig,
                    remat: str = "none", microbatch: int = 0) -> Callable:
    """(TrainState, batch) -> (TrainState, metrics) (``make_train_step``,
    :23).

    ``microbatch`` > 1 accumulates gradients: the batch is split along dim
    0 into that many slices, each slice's gradients added into buffers of
    ``opt.accum_dtype`` in order and divided by their number, the metrics
    averaged over the slices.  ``remat`` ("none", "full" or "selective")
    goes to ``lm_loss``; the audio family's ``encdec_loss``
    rematerializes every layer as the reference's does, whatever
    ``remat`` says, so there any other value than the default raises.
    Metrics: ``loss``, ``ce`` (and ``aux`` for a decoder stack: the MoE
    layers' load-balance loss), ``lr``, ``grad_norm`` (0-d tensors; on a
    mesh, DTensors).  State and batch may be DTensors on a mesh (under
    ``launch/sharding.py::sharding_rules``): the step is then one DTensor
    program, the update and the global-norm clip included."""
    if cfg.family == "audio" and remat != "none":
        raise ValueError(f"make_train_step: the audio family's encdec_loss "
                         f"rematerializes every layer and takes no remat "
                         f"option; got remat={remat!r}")
    adt = DTYPES[opt.accum_dtype]
    loss_and_grads = make_loss_and_grads(cfg, remat)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        dev = next(iter(state.params.values())).device
        batch = _on_device(batch, dev)
        if microbatch and microbatch > 1:
            n = microbatch
            size = batch["tokens"].shape[0] // n
            acc = {k: torch.zeros(p.shape, dtype=adt, device=p.device)
                   for k, p in state.params.items()}
            per = []
            for i in range(n):
                one = {k: v[i * size:(i + 1) * size] for k, v in
                       batch.items()}
                grads, metrics = loss_and_grads(state.params, one)
                for k, g in grads.items():
                    acc[k] += g.to(adt)
                per.append(metrics)
            grads = {k: a / n for k, a in acc.items()}
            metrics = {k: torch.stack([m[k] for m in per]).mean()
                       for k in per[0]}
        else:
            grads, metrics = loss_and_grads(state.params, batch)
        loss = metrics.pop("loss")
        new_state, opt_metrics = adamw_update(state, grads, opt)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: LMConfig, cache_size: int = 0, *,
                      attn_impl: str = "auto") -> Callable:
    """(model, batch) -> (last logits, caches, [memory,] length)
    (``make_prefill_step``, :75).  The audio family runs
    ``encdec_prefill`` over ``frames`` and ``tokens``; a decoder model
    ``lm_prefill`` over ``embeds`` (where the batch has them) and
    ``tokens``.  The caches hold ``cache_size`` positions, by default the
    prompt's: the frontend's positions and the tokens'."""

    def prefill_step(model, batch):
        batch = _on_device(batch, model.device)
        if cfg.family == "audio":
            return encdec_lib.encdec_prefill(
                model, batch["frames"], batch["tokens"],
                cache_size or batch["tokens"].shape[1], attn_impl=attn_impl)
        n_front = batch["embeds"].shape[1] if "embeds" in batch else 0
        size = cache_size or (batch["tokens"].shape[1] + n_front)
        return lm_prefill(model, batch["tokens"], size, batch.get("embeds"),
                          attn_impl=attn_impl)

    return prefill_step


def make_decode_step(cfg: LMConfig, *, attn_impl: str = "auto") -> Callable:
    """(model, batch{token, caches, [memory,] length}) -> (logits, caches,
    length) (``make_decode_step``, :92): ``encdec_decode_step`` for the
    audio family, ``lm_decode_step`` for a decoder model.  The new rows are
    written into ``caches`` in place."""

    def decode_step(model, batch):
        batch = _on_device(batch, model.device)
        if cfg.family == "audio":
            return encdec_lib.encdec_decode_step(
                model, batch["token"], batch["caches"], batch["memory"],
                batch["length"], attn_impl=attn_impl)
        return lm_decode_step(model, batch["token"], batch["caches"],
                              batch["length"], attn_impl=attn_impl)

    return decode_step


def make_eval_step(cfg: LMConfig) -> Callable:
    """(params, batch) -> the loss's metrics without a gradient
    (``make_eval_step``, :106): ``{"ce", "aux"}`` for a decoder model,
    ``{"ce"}`` for the audio family."""
    skel = _skeleton(cfg)

    def eval_step(params, batch):
        dev = next(iter(params.values())).device
        batch = _on_device(batch, dev)
        with torch.no_grad():
            _, metrics = _loss(cfg, skel, batch, params)
        return metrics

    return eval_step
