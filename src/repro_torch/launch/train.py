"""Training launcher on a mesh (``repro/launch/train.py``):
``python -m repro_torch.launch.train --arch <id> [...]``.

Builds ``launch/mesh.py::make_test_mesh`` over the ranks of the process
group there is -- one NCCL rank on one card gives a (1, 1) mesh, gloo
ranks on the CPU a (dp, tp) one -- places the train state by
``launch/specs.py::state_pspecs`` and each batch by ``input_pspecs``
(DTensors), and drives ``train/trainer.py::Trainer`` (checkpoint-resume,
failure recovery, straggler watchdog) under the arch's sharding rules.
Without an open group it opens a one-rank group itself (NCCL on a card,
gloo on the CPU).  Under ``torchrun`` each rank runs the same command.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --reduced --steps 20 --batch 4 --seq 64 --device cpu

The audio family is refused, as the reference refuses it (its enc-dec
example path is ``launch/train_lm.py``).  ``train(cfg, ...)`` is the work
``main`` does, for a caller with its own config (``chip_smoke.py`` passes
a depth-cut one).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import logging
import os
import tempfile
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.config import (LMConfig, OptimizerConfig, ShapeSpec,
                                TrainConfig, get_config)
from repro_torch.core.backend import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.sharding import named, rules_for, sharding_rules
from repro_torch.launch.specs import (abstract_state, arch_attn_tp,
                                      input_pspecs, state_pspecs)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_lm
from repro_torch.optim.optimizer import make_train_state, tree_map
from repro_torch.train.trainer import Trainer

MODULES = {
    "kimi-k2-1t-a32b": "kimi_k2", "arctic-480b": "arctic_480b",
    "deepseek-67b": "deepseek_67b", "gemma2-9b": "gemma2_9b",
    "gemma-7b": "gemma_7b", "granite-3-8b": "granite_3_8b",
    "jamba-1.5-large-398b": "jamba_1_5_large", "internvl2-1b": "internvl2_1b",
    "seamless-m4t-medium": "seamless_m4t_medium", "mamba2-2.7b": "mamba2_2_7b",
}

#: what a batch entry of a decoder LM's training step is placed as
BATCH_KEYS = ("tokens", "labels", "embeds")


def open_group(device) -> None:
    """Open a one-rank default process group (NCCL for a card, gloo for
    the CPU) over a file store, unless one is open; under ``torchrun``
    the group comes from its environment."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return
    store = Path(tempfile.mkdtemp(prefix="repro_torch_train_")) / "store"
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=0, world_size=1)


def build_trainer(cfg: LMConfig, *, steps: int, batch: int, seq: int,
                  lr: float = 3e-4, microbatch: int = 0,
                  remat: str = "none", ckpt_dir: str, device="cuda",
                  checkpoint_every: int = 25, log_every: int = 5,
                  opt: Optional[OptimizerConfig] = None,
                  failure_injector=None):
    """(trainer, mesh, rules) for ``cfg`` on the mesh over the open
    process group: the state made by ``make_train_state(init_lm(cfg))``
    (weights from a generator seeded with 0 on each rank's device, so
    every rank draws the same weights and keeps its shard) and placed by
    ``state_pspecs``; batches from ``TokenPipeline(cfg, (seq, batch),
    seed=0)`` placed by ``input_pspecs``.  Run it under
    ``sharding_rules(mesh, rules)``."""
    if cfg.family == "audio":
        raise SystemExit("use the encdec example path for audio archs "
                         "(launch/train_lm.py)")
    dev = resolve_device(device)
    mesh = make_test_mesh(device_type=dev.type)
    rules = rules_for(cfg, mesh)
    shape = ShapeSpec("train_cli", seq, batch, "train")
    opt = opt or OptimizerConfig(lr=lr, warmup_steps=max(5, steps // 20),
                                 total_steps=steps)
    tc = TrainConfig(model=cfg.name, steps=steps, optimizer=opt,
                     checkpoint_dir=ckpt_dir,
                     checkpoint_every=checkpoint_every, log_every=log_every,
                     remat=remat, microbatch=microbatch)
    attn_tp = arch_attn_tp(cfg, mesh)
    st_sh = named(mesh, state_pspecs(abstract_state(cfg, opt), mesh,
                                     attn_tp))
    bt_sh = {k: v for k, v in named(mesh, input_pspecs(
        cfg, shape, mesh)).items() if k in BATCH_KEYS}

    def make_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        model = init_lm(cfg, generator=gen, device=dev)
        params = {k: p.detach() for k, p in model.named_parameters()}
        state = make_train_state(params, opt)
        return tree_map(lambda t, sh: sh.place(t), state, st_sh)

    from repro_torch.launch.train_lm import frontend_tokens
    trainer = Trainer(tc, make_state=make_state,
                      step_fn=make_train_step(cfg, opt, remat=tc.remat,
                                              microbatch=tc.microbatch),
                      pipeline=TokenPipeline(
                          cfg, shape, seed=0,
                          frontend_tokens=frontend_tokens(cfg)),
                      state_shardings=st_sh, batch_shardings=bt_sh,
                      failure_injector=failure_injector)
    return trainer, mesh, rules


def train(cfg: LMConfig, **kw) -> dict:
    """Open a group if none is, build the trainer (``build_trainer``'s
    keywords) and run it under the arch's sharding rules; returns
    ``Trainer.run()``'s result with the ``mesh``."""
    open_group(resolve_device(kw.get("device", "cuda")))
    trainer, mesh, rules = build_trainer(cfg, **kw)
    with sharding_rules(mesh, rules):
        result = trainer.run()
    result["mesh"] = mesh
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-sized family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "selective"])
    ap.add_argument("--ckpt-dir", default="checkpoints/launch_train")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.reduced:
        mod = importlib.import_module(
            f"repro_torch.configs.{MODULES[args.arch]}")
        cfg = dataclasses.replace(mod.reduced(), dtype="float32")
    else:
        cfg = get_config(args.arch)
    ckpt = args.ckpt_dir
    if dist.is_initialized() and dist.get_world_size() > 1:
        ckpt = f"{ckpt}/rank{dist.get_rank()}"
    result = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                   lr=args.lr, microbatch=args.microbatch, remat=args.remat,
                   ckpt_dir=ckpt, device=args.device)
    h = result["history"]
    if h:
        print(f"done: loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}; "
              f"recoveries={result['recoveries']}")
    return result


if __name__ == "__main__":
    main()
