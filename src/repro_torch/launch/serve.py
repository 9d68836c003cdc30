"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Port of ``repro/launch/serve.py``: builds the ``ServeEngine`` over a model
with seeded random weights and serves a synthetic request wave (it stands
in for an RPC front-end; the engine API is the integration point).  It runs
on the card by default; reduced configs also run on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --reduced --requests 8 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.config import get_config
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.engine import Request, ServeEngine

#: arch -> module under repro_torch.configs: every decoder arch (the
#: reference's map is ``repro/launch/train.py::MODULES``; the enc-dec
#: seamless-m4t-medium is served by ``launch/steps.py``).  internvl2-1b is
#: served text-only here, as the reference's engine serves it; its
#: image+prompt path is ``make_prefill_step`` then ``make_decode_step``
MODULES = {"arctic-480b": "arctic_480b", "deepseek-67b": "deepseek_67b",
           "gemma-7b": "gemma_7b", "gemma2-9b": "gemma2_9b",
           "granite-3-8b": "granite_3_8b", "internvl2-1b": "internvl2_1b",
           "jamba-1.5-large-398b": "jamba_1_5_large",
           "kimi-k2-1t-a32b": "kimi_k2", "mamba2-2.7b": "mamba2_2_7b"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(MODULES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-size", type=int, default=256)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.reduced:
        mod = importlib.import_module(
            f"repro_torch.configs.{MODULES[args.arch]}")
        cfg = dataclasses.replace(mod.reduced(), dtype="float32")
    else:
        cfg = get_config(args.arch)

    model = TransformerLM(cfg, device=args.device)
    engine = ServeEngine(cfg, model, max_batch=args.max_batch,
                         cache_size=args.cache_size)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        engine.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(4, 32))),
            max_tokens=args.max_tokens))
    done = engine.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s) on {model.device}")


if __name__ == "__main__":
    main()
