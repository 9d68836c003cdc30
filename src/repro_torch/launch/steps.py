"""The LM training and evaluation steps (``repro/launch/steps.py``).

``make_train_step`` returns ``(TrainState, batch) -> (TrainState,
metrics)``: the loss and its gradients over the state's parameters, then
one AdamW update (``optim/optimizer.py::adamw_update``).  The state's
``params`` are the model's parameters by name (``dict(
model.named_parameters())``, detached), which ``make_train_state``,
``train/trainer.py::Trainer`` and ``checkpoint/`` take as they are; the
loss runs over them through ``torch.func.functional_call`` on a module
that holds only the structure (on the ``meta`` device).  A batch is a
dict of numpy arrays or tensors (``tokens``, ``labels``), moved to the
parameters' device.

The reference's prefill and decode step makers are served by ``serve/``;
the audio family's enc-dec loss is not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.config import LMConfig, OptimizerConfig
from repro_torch.models.transformer import DTYPES, TransformerLM, lm_loss
from repro_torch.optim.optimizer import TrainState, adamw_update


def _on_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: LMConfig, opt: OptimizerConfig,
                    remat: str = "none", microbatch: int = 0) -> Callable:
    """(TrainState, batch) -> (TrainState, metrics) (``make_train_step``,
    :23).

    ``microbatch`` > 1 accumulates gradients: the batch is split along dim
    0 into that many slices, each slice's gradients added into buffers of
    ``opt.accum_dtype`` in order and divided by their number, the metrics
    averaged over the slices.  ``remat`` ("none" or "full") goes to
    ``lm_loss``.  Metrics: ``loss``, ``ce``, ``aux``, ``lr``,
    ``grad_norm`` (0-d tensors)."""
    if cfg.family == "audio":
        raise NotImplementedError("the enc-dec loss (audio family) is not "
                                  "ported")
    skel = TransformerLM(cfg, device="meta")
    adt = DTYPES[opt.accum_dtype]

    def loss_and_grads(params, batch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss, metrics = lm_loss(skel, batch["tokens"], batch["labels"],
                                batch.get("embeds"), remat=remat,
                                params=leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return dict(zip(leaves, grads)), metrics

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


def make_eval_step(cfg: LMConfig) -> Callable:
    """(params, batch) -> {"ce", "aux"} without a gradient
    (``make_eval_step``, :107)."""
    skel = TransformerLM(cfg, device="meta")

    def eval_step(params, batch):
        dev = next(iter(params.values())).device
        batch = _on_device(batch, dev)
        with torch.no_grad():
            _, metrics = lm_loss(skel, batch["tokens"], batch["labels"],
                                 batch.get("embeds"), params=params)
        return metrics

    return eval_step
