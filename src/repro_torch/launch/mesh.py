"""Production and test meshes (``repro/launch/mesh.py``).

A ``torch.distributed.device_mesh.DeviceMesh`` stands where the reference
has a ``jax.sharding.Mesh``, with the same axis names:

  single-pod: (16, 16)      axes ("data", "model")          = 256 ranks
  multi-pod:  (2, 16, 16)   axes ("pod", "data", "model")   = 512 ranks

Axis roles (``launch/sharding.py``): pod+data carry DP/FSDP (parameters
and batch), model carries TP (heads, FFN, vocabulary) and EP.

The functions build meshes over the process group that is open; they open
none.  A production mesh needs a group of its world size: the dry run
(``launch/dryrun.py``) opens a ``"fake"`` group of 256 or 512 ranks in
one process (``open_fake_group``), whose collectives move no data, as the
reference's dry run compiles for 512 placeholder devices.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of a production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def open_fake_group(world_size: int, rank: int = 0) -> None:
    """Open the default process group as a ``"fake"`` group of
    ``world_size`` ranks in this process (closing one that is open): its
    collectives return at once and move nothing, so one process traces
    what rank ``rank`` of a pod runs."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) or (2, 16, 16) mesh over the open process group, whose
    world size must be 256 or 512."""
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(ranks=None, device_type: str = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh over ``ranks`` (default: every rank of the open
    group), axes ("data", "model"): tp = 2 from 4 ranks up, else 1 (the
    reference's rule); a world of one rank gives a (1, 1) mesh."""
    n = len(ranks) if ranks is not None else dist.get_world_size()
    dp, tp = (n // 2, 2) if n >= 4 else (n, 1)
    ranks = list(ranks) if ranks is not None else list(range(n))
    grid = torch.tensor(ranks[:dp * tp], dtype=torch.int64).view(dp, tp)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{axis name: size}``, the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fsdp_axes(mesh: DeviceMesh):
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def num_chips(mesh: DeviceMesh) -> int:
    return int(math.prod(mesh.shape))
