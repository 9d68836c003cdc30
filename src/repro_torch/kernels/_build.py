"""Build ``csrc/*.cu`` with nvcc at first use and load them with ctypes.

Each kernel source compiles on its own into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``), so
no PyTorch header is ever compiled.  Libraries land in ``build/kernels/``
at the repository root, named by a hash of the sources and flags: an edited
source rebuilds, an unchanged one is reused.  Only the sources in the
checkout are used.

Nothing here runs at import time; ``load`` builds on first use, and
``build`` compiles several sources in parallel, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("seg_agg", "fused_agg_combine", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda);"
        " the cuda tier's kernels are compiled from repro_torch/csrc at first"
        " use")


def lib_path(name: str) -> Path:
    """Where the library for source ``name`` lives, keyed by a hash of the
    source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes started together.  Returns ``{name: nvcc's log}`` for the
    sources compiled by this call (``-Xptxas -v``: registers, shared
    memory and spills per kernel).  Raises if a compile fails."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def check_args(kernel: str, device, args) -> None:
    """Raise unless each ``name: (tensor, dtype, shape)`` in ``args`` lies on
    ``device`` with that dtype and shape (``None`` = any extent) and is
    contiguous -- the kernels take nothing else.  Also raises when autograd
    would want a gradient through a launch: a launch has no backward of its
    own (K1's wrapper launches inside its autograd Function, where grad
    mode is off), and silently dropping the gradient would be wrong."""
    for name, (t, dtype, shape) in args.items():
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, "
                            f"expected {dtype}")
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t, _, _ in args.values()):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel launch has no backward; call it "
            f"under torch.no_grad() or through a differentiable wrapper")
