"""Train a decoder LM end to end: the port's ``examples/train_lm.py``.

The full runtime -- ``TokenPipeline`` (Zipf tokens, a pure function of
(seed, step)), ``make_train_step`` (AdamW with warmup and cosine decay),
``make_train_state(init_lm(...))`` and the fault-tolerant ``Trainer`` with
its atomic checkpoints -- over a ~100M granite-family model by default:

  PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 300
  PYTHONPATH=src python -m repro_torch.launch.train_lm --arch gemma2-9b \\
      --preset smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train_lm \\
      --arch seamless-m4t-medium --width full --steps 3 --batch 2 --seq 4096

On a card the attention of every layer runs K5 and its backward kernels
(``--device cuda``, the default); a Mamba-2 layer is plain PyTorch under
autograd.  ``--arch`` takes the archs whose configs the port has
(``granite-100m``, ``gemma2-9b``, ``gemma-7b``, ``granite-3-8b``,
``deepseek-67b``, the SSM ``mamba2-2.7b``, the hybrid
``jamba-1.5-large-398b``, the VLM ``internvl2-1b``, its patch embeddings
from the pipeline -- ``--seq`` counts them and the tokens -- and the
enc-dec ``seamless-m4t-medium``, its frames from the pipeline),
reduced and in f32 as the example trains them (``make_config(...,
width="full", layers=n)`` keeps the published widths and cuts the depth,
as ``chip_smoke.py``'s phase 18 trains gemma2-9b).  Re-running the same
command resumes from the newest checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import logging
from typing import Optional

import torch

from repro_torch.config import (AttentionConfig, LMConfig, OptimizerConfig,
                                ShapeSpec, TrainConfig)
from repro_torch.configs.internvl2_1b import NUM_PATCH_TOKENS
from repro_torch.core.backend import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models.encdec import init_encdec
from repro_torch.models.transformer import init_lm
from repro_torch.optim.optimizer import make_train_state
from repro_torch.train.trainer import Trainer

#: --arch -> the port's config module (the example's MODULES, the VLM
#: internvl2-1b, whose batches carry the frontend's patch embeddings, and
#: the enc-dec seamless-m4t-medium, whose batches carry the encoder's
#: frames)
MODULES = {"deepseek-67b": "deepseek_67b", "gemma-7b": "gemma_7b",
           "gemma2-9b": "gemma2_9b", "granite-3-8b": "granite_3_8b",
           "internvl2-1b": "internvl2_1b",
           "jamba-1.5-large-398b": "jamba_1_5_large",
           "mamba2-2.7b": "mamba2_2_7b",
           "seamless-m4t-medium": "seamless_m4t_medium"}


def model_100m() -> LMConfig:
    """granite-family ~100M: 12L d=640 10H kv=2 ffn 1792 vocab 32768."""
    return LMConfig(
        name="granite-100m", family="dense", num_layers=12, d_model=640,
        d_ff=1792, vocab_size=32768,
        attention=AttentionConfig(num_heads=10, num_kv_heads=2, head_dim=64),
        mlp_activation="swiglu", tie_embeddings=True, dtype="float32")


def make_config(arch: str = "granite-100m", preset: str = "full", *,
                width: str = "reduced",
                layers: Optional[int] = None) -> LMConfig:
    """The example's config choice: ``granite-100m`` or an arch's reduced
    config in f32 (``width="full"``: its published widths in f32), the
    ``tiny`` preset's narrow widths; ``layers`` cuts the depth."""
    if arch == "granite-100m":
        cfg = model_100m()
    elif arch in MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{MODULES[arch]}")
        base = mod.config() if width == "full" else mod.reduced()
        cfg = dataclasses.replace(base, dtype="float32")
    else:
        raise NotImplementedError(
            f"--arch {arch}: not ported (the port has configs for "
            f"granite-100m and {', '.join(sorted(MODULES))})")
    if preset == "tiny":
        cfg = dataclasses.replace(cfg, num_layers=4, d_model=256, d_ff=704,
                                  vocab_size=8192)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def frontend_tokens(cfg: LMConfig) -> int:
    """Patch positions a decoder ``frontend_stub`` config's rows begin
    with (``NUM_PATCH_TOKENS``); 0 for any other config (the audio
    family's frontend is its encoder's frames)."""
    return NUM_PATCH_TOKENS if cfg.frontend_stub and \
        cfg.family != "audio" else 0


def make_trainer(cfg: LMConfig, *, steps: int, batch: int, seq: int,
                 lr: float = 3e-4, ckpt_dir: str, device="cuda",
                 log_every: int = 10, checkpoint_every: int = 50) -> Trainer:
    """A ``Trainer`` over ``TokenPipeline(cfg, (seq, batch), seed=0)``,
    ``make_train_step(cfg, opt)`` and ``make_train_state(init_lm(cfg))``
    (``init_encdec`` for the audio family) with the weights drawn from a
    generator seeded with 0 on ``device`` (the example's seeds).  A
    decoder ``frontend_stub`` config's pipeline adds ``NUM_PATCH_TOKENS``
    patch embeddings a row, which ``seq`` counts: ``seq -
    NUM_PATCH_TOKENS`` tokens follow them."""
    dev = resolve_device(device)
    shape = ShapeSpec("train_cli", seq, batch, "train")
    opt = OptimizerConfig(lr=lr, warmup_steps=max(10, steps // 20),
                          total_steps=steps)
    tc = TrainConfig(model=cfg.name, steps=steps, optimizer=opt,
                     checkpoint_dir=ckpt_dir,
                     checkpoint_every=checkpoint_every, log_every=log_every)

    init = init_encdec if cfg.family == "audio" else init_lm

    def make_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        model = init(cfg, generator=gen, device=dev)
        params = {k: p.detach() for k, p in model.named_parameters()}
        return make_train_state(params, opt)

    return Trainer(tc, make_state=make_state,
                   step_fn=make_train_step(cfg, opt),
                   pipeline=TokenPipeline(
                       cfg, shape, seed=0,
                       frontend_tokens=frontend_tokens(cfg)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-100m",
                    help="granite-100m | " + " | ".join(sorted(MODULES)))
    ap.add_argument("--preset", default="full",
                    choices=["full", "tiny", "smoke"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--width", default="reduced",
                    choices=["reduced", "full"],
                    help="an arch's reduced config or its published widths "
                    "(f32 either way)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = make_config(args.arch, args.preset, width=args.width)
    if args.preset == "smoke":
        args.steps, args.batch = min(args.steps, 5), 2
        args.seq = 32 + frontend_tokens(cfg)
    print(f"arch={cfg.name}  params={cfg.param_count() / 1e6:.1f}M  "
          f"steps={args.steps}  batch={args.batch}x{args.seq}  "
          f"device={args.device}")
    trainer = make_trainer(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                           device=args.device)
    result = trainer.run()
    hist = result["history"]
    if hist:
        print(f"\ndone: loss {hist[0]['loss']:.3f} -> "
              f"{hist[-1]['loss']:.3f} over {args.steps} steps; "
              f"checkpoints in {args.ckpt_dir}")
    else:   # resumed from a checkpoint at the last step
        print(f"\ndone: {args.ckpt_dir} already holds step "
              f"{args.steps - 1}")
    return result


if __name__ == "__main__":
    main()
