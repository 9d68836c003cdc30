"""MLP-MNIST baseline (paper Table 1: 784-128, batch 1000;
``repro/models/mlp.py``).

The paper contrasts GCN Combination with a plain fully-connected layer
classifying single samples: no parameter is shared across a
neighbourhood, and the batch is the only parallelism.  Only its cost model
is ported: the characterization depends on the shapes alone.
"""

from __future__ import annotations

from repro_torch.core.phases import combine_cost

MNIST_IN, MNIST_OUT, MNIST_BATCH = 784, 128, 1000


def mlp_cost(batch: int = MNIST_BATCH, din: int = MNIST_IN,
             dout: int = MNIST_OUT) -> dict:
    """Cost and parameter-reuse factor (paper §4.3): reuse = rows per
    weight (``mlp_cost``, :34)."""
    c = combine_cost(batch, (din, dout))
    c["param_reuse"] = batch  # each weight used once per row
    return c
