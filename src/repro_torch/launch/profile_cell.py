"""Dry-run profiler (``repro/launch/profile_cell.py``): the top HBM-traffic
and FLOP contributors of one cell, keyed by (op, input shapes), from the
same traced step as ``launch/dryrun.py`` (per device; ``core/op_cost.py``
counts it).  K5 appears by its op's name, ``repro_torch.flash_attention``
(and ``repro_torch.flash_attention_bwd``), on the cuda tier.

  PYTHONPATH=src python -m repro_torch.launch.profile_cell --device cpu \\
      --arch mamba2-2.7b --shape train_4k [--mesh single] [--top 20]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import op_cost
from repro_torch.core.backend import resolve_device
from repro_torch.profile.machine import H100


def profile(arch: str, shape: str, mesh_kind: str = "single", top: int = 20,
            remat: str = "auto", microbatch: int = 0, rules_override=None,
            device: str = "cuda", cfg=None, verbose: bool = True):
    """Trace the cell and print its top rows; returns ``(by_bytes,
    by_flops, cost)``: each a list of ``(value, calls, op, shapes)``,
    largest first (``core/op_cost.py::top_ops``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.config import get_config
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.mesh import make_production_mesh, open_fake_group
    from repro_torch.launch.sharding import rules_for, sharding_rules
    from repro_torch.optim.optimizer import tree_leaves

    resolve_device(device)     # raises for "cuda" without a card
    multi = mesh_kind == "multi"
    open_fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi,
                                device_type=torch.device(device).type)
    rules = rules_for(cfg or get_config(arch), mesh)
    if rules_override:
        rules.update(rules_override)
    with FakeTensorMode() as fm, sharding_rules(mesh, rules):
        fn, args, cfg, sh = build_cell(arch, shape, mesh, remat=remat,
                                       microbatch=microbatch, device=device,
                                       cfg=cfg)
        _, cost = op_cost.count(fn, *args, fake_mode=fm,
                                inputs=tree_leaves(args))
    by_bytes = op_cost.top_ops(cost, "bytes", top)
    by_flops = op_cost.top_ops(cost, "flops", max(6, top // 2))
    if verbose:
        tb, tf = cost.bytes_accessed, cost.flops
        print(f"== {arch} x {shape} x {mesh_kind} (remat={remat}, "
              f"microbatch={microbatch}, device={device}) ==")
        print(f"bytes={tb:.3e} ({tb / H100.hbm_bw:.2f}s at H100 HBM) "
              f"flops={tf:.3e} ({tf / H100.peak_flops:.2f}s at H100 bf16 "
              f"peak)\n")
        print("-- top HBM traffic --")
        for v, n, op, shp in by_bytes:
            print(f"{v:9.2e} ({100 * v / tb:4.1f}%) x{n:<4d} {op:36s} "
                  f"{shp[:90]}")
        print("\n-- top FLOPs --")
        for v, n, op, shp in by_flops:
            print(f"{v:9.2e} ({100 * v / tf:4.1f}%) x{n:<4d} {op:36s} "
                  f"{shp[:90]}")
    return by_bytes, by_flops, cost


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--remat", default="auto")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    profile(args.arch, args.shape, args.mesh, args.top, args.remat,
            args.microbatch, device=args.device)


if __name__ == "__main__":
    main()
