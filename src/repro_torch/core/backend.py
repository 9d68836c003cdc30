"""Tier resolution and the device rule (``repro/core/backend.py``).

The reference has three tiers (``xla``, ``pallas-tpu``, ``pallas-gpu``,
:43-48).  The port has two:

  * ``"torch"`` -- plays the part of ``xla``: plain PyTorch, the kernels'
    plain versions; runs on any device.
  * ``"cuda"``  -- plays the part of both Pallas tiers: the kernels written
    by hand in CUDA C++ (``repro_torch/csrc``).  It takes CUDA tensors
    only; asking for it with tensors on the CPU raises.  There is no
    fallback from ``cuda`` to ``torch``.

``"auto"`` resolves per device: ``cuda`` for a CUDA device, ``torch`` for
the CPU.

The device rule: entry points take ``device=`` with default ``"cuda"``;
``resolve_device`` raises when that default finds no card instead of
falling back to the CPU.
"""

from __future__ import annotations

import torch

TORCH = "torch"
CUDA = "cuda"
AUTO = "auto"
BACKENDS = (TORCH, CUDA)


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` with its index (``"cuda"`` becomes
    ``cuda:<current device>``, so it compares equal to a tensor's device);
    raises when it names CUDA and no card is visible.  On a CUDA device,
    TF32 is switched off for f32 matmuls and convolutions: the port
    computes f32 in full f32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' needs a CUDA card and none is visible; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def resolve_backend(requested: str, device) -> str:
    """Map a requested tier to a concrete one (never ``"auto"``).

    ::

        requested    cpu      cuda
        ---------    -----    -----
        "auto"       torch    cuda
        "torch"      torch    torch
        "cuda"       cuda     cuda   (running it on the CPU raises:
                                      ``require_device``)
    """
    if requested in BACKENDS:
        return requested
    if requested != AUTO:
        raise ValueError(f"unknown backend {requested!r}; expected one of "
                         f"{BACKENDS + (AUTO,)}")
    return CUDA if torch.device(device).type == "cuda" else TORCH


def require_device(backend: str, device) -> None:
    """Raise unless ``backend`` can run on ``device``: the ``cuda`` tier
    launches kernels and takes CUDA tensors only."""
    if backend == CUDA and torch.device(device).type != "cuda":
        raise ValueError(
            f"backend='cuda' launches the CUDA kernels and needs tensors on "
            f"a CUDA device; got {torch.device(device)} (use "
            f"backend='torch' or 'auto' on the CPU)")
