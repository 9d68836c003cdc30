"""AdamW with a warmup + cosine schedule and global-norm clipping
(``repro/optim/optimizer.py``, :22-89).

The state is a ``TrainState`` of nested dicts of tensors, the moments
mirroring the parameters.  Moments may be stored in bf16
(``OptimizerConfig.moment_dtype``); the update computes in f32 and rounds
each moment and parameter once to its storage dtype, as the reference
does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.config import OptimizerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState(NamedTuple):
    step: torch.Tensor          # () int32
    params: Any
    m: Any
    v: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys in sorted order),
    lists and tuples; ``rest`` share ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def moment_dtype(cfg: OptimizerConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.moment_dtype]
    except KeyError:
        raise ValueError(f"unknown moment_dtype {cfg.moment_dtype!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None


def make_train_state(params, cfg: OptimizerConfig) -> TrainState:
    """Zero moments in ``cfg.moment_dtype`` beside ``params``, on their
    devices; step 0."""
    dt = moment_dtype(cfg)
    first = tree_leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev), params=params,
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                         device=p.device), params))


def adamw_init(params, cfg: OptimizerConfig) -> TrainState:
    return make_train_state(params, cfg)


def cosine_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine
    decay to 0 at ``total_steps`` (``cosine_lr``, :45).  f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * (0.5 * (1.0 + torch.cos(math.pi * t)))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def adamw_update(state: TrainState, grads, cfg: OptimizerConfig
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step (``adamw_update``, :56): clip by the global norm,
    bias-corrected moments, decoupled weight decay on matrices only.
    Returns the new state and ``{"lr", "grad_norm"}``."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 \
        else torch.ones((), device=gnorm.device)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=step.device), stepf)
    mdt = moment_dtype(cfg)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay > 0 and p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)

    with torch.no_grad():
        out = [upd(*leaves) for leaves in zip(
            *(tree_leaves(t) for t in (state.params, grads, state.m,
                                       state.v)))]
    new_p, new_m, new_v = (tree_unflatten(state.params, [o[i] for o in out])
                           for i in range(3))
    return TrainState(step, new_p, new_m, new_v), \
        {"lr": lr, "grad_norm": gnorm}
