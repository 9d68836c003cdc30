"""MLP-MNIST baseline (paper Table 1: 784-128, batch 1000;
``repro/models/mlp.py``).

The paper contrasts GCN Combination with a plain fully-connected layer
classifying single samples: no parameter is shared across a
neighbourhood, and the batch is the only parallelism.  The data is
synthetic, MNIST-shaped (no download): the characterization depends on
the shapes alone.  The reference draws from ``jax.random``; here every
draw comes from an explicit ``torch.Generator``, so the values differ
from the reference's and the shapes, dtypes and ranges do not.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.backend import resolve_device
from repro_torch.core.phases import combine_cost

MNIST_IN, MNIST_OUT, MNIST_BATCH = 784, 128, 1000
MNIST_CLASSES = 10


def init_mlp(generator: torch.Generator, din: int = MNIST_IN,
             dout: int = MNIST_OUT, *, device="cuda") -> Dict:
    """``{"w": (din, dout), "b": (dout,)}`` f32 on ``device``: He-normal
    weights, ``N(0, 1) * sqrt(2 / din)`` drawn from ``generator`` (a CPU
    generator), and zero bias (``init_mlp``, :21)."""
    dev = resolve_device(device)
    w = torch.randn((din, dout), generator=generator) * (2.0 / din) ** 0.5
    return {"w": w.to(dev), "b": torch.zeros((dout,), device=dev)}


def apply_mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``relu(x @ w + b)`` (``apply_mlp``, :26)."""
    return torch.relu(x @ params["w"] + params["b"])


def mlp_cost(batch: int = MNIST_BATCH, din: int = MNIST_IN,
             dout: int = MNIST_OUT) -> dict:
    """Cost and parameter-reuse factor (paper §4.3): reuse = rows per
    weight (``mlp_cost``, :34)."""
    c = combine_cost(batch, (din, dout))
    c["param_reuse"] = batch  # each weight used once per row
    return c


def synthetic_mnist(generator: torch.Generator, batch: int = MNIST_BATCH,
                    *, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """A synthetic MNIST batch on ``device`` (``synthetic_mnist``, :42):
    ``(batch, 784)`` f32 pixels uniform in ``[0, 1)`` and ``(batch,)``
    int64 labels uniform in ``0..9``, drawn from ``generator``."""
    dev = resolve_device(device)
    x = torch.rand((batch, MNIST_IN), generator=generator)
    y = torch.randint(0, MNIST_CLASSES, (batch,), generator=generator)
    return x.to(dev), y.to(dev)
