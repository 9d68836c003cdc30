#!/usr/bin/env python3
"""Time the host-bound LM paths of ``chip_smoke.py`` on two checkouts, on
one card, to see what K5's host path costs end to end.

The paths are the ones that reach K5 many times a second: gemma2-9b's
prefills through the ServeEngine (phase 6), its f32 and bf16 training
steps (phase 18, ``drive_lm_train``), seamless-m4t-medium's prefill and
training steps (phase 19) and internvl2-1b's prefill and training steps
(phase 22).  Each run calls one checkout's own ``chip_smoke.py`` drive
functions in a process of its own, so that each checkout runs its own
package and its own kernels (built first, outside the clocks).

Run from the repository root on a machine with a card and nvcc, with
another revision's tree unpacked in a git-ignored directory:

    git archive <rev> | tar -x -C build/ab_parent
    python3 scripts/k5_dispatch_ab.py --parent build/ab_parent

The runs go parent, change, change, parent (the change is this
checkout).  Each writes its drive functions' results to
``chiprun_out/k5_ab_<i>_<tag>.json``; the script then prints the card's
name and power limit and one line per metric: its value in each run and
the change's median over the parent's.  Exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out"


def _median(xs):
    return statistics.median(xs) if xs else None


def _prefills(d: dict) -> list:
    """A ServeEngine's prefill ms by request id, in id order."""
    return [d[k] for k in sorted(d, key=int)]


#: (metric, how to read it from the drive functions' results); a missing
#: key reads as None
METRICS = [
    ("6 gemma2-9b prefill ms, sum over the 8 prompts",
     lambda r: sum(_prefills(r["lm"]["prefill_ms"]))),
    ("6 gemma2-9b prefill ms, 17-token prompt (the first)",
     lambda r: _prefills(r["lm"]["prefill_ms"])[0]),
    ("6 gemma2-9b prefill ms, 33-token prompt (the last)",
     lambda r: _prefills(r["lm"]["prefill_ms"])[-1]),
    ("18 gemma2-9b f32 train step host ms, median of steps 1-",
     lambda r: _median(r["lm_train"]["host_ms"][1:])),
    ("18 gemma2-9b bf16 train step host ms (profiled)",
     lambda r: r["lm_train"]["bf16_step_host_ms"]),
    ("19 seamless prefill ms (CUDA events)",
     lambda r: r["encdec"]["serve"]["prefill_ms"]),
    ("19 seamless f32 train step host ms, median of steps 1-",
     lambda r: _median(r["encdec"]["train"]["host_ms"][1:])),
    ("19 seamless bf16 train step host ms (profiled)",
     lambda r: r["encdec"]["train"]["bf16_step_host_ms"]),
    ("22 internvl2-1b prefill ms (CUDA events)",
     lambda r: r["vlm"]["serve"]["prefill_ms"]),
    ("22 internvl2-1b f32 train step host ms, median of steps 1-",
     lambda r: _median(r["vlm"]["train"]["host_ms"][1:])),
    ("22 internvl2-1b bf16 train step host ms (profiled)",
     lambda r: r["vlm"]["train"]["bf16_step_host_ms"]),
]


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return str(x)


def run_one(root: Path, out: Path) -> None:
    """One run: ``root``'s chip_smoke.py drive functions of phases 6, 18,
    19 and 22, their results written to ``out``."""
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / "build" / sub))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    assert Path(cs.__file__).resolve().parent == root.resolve()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build(["flash_attention"])
    print(f"[ab] {root}: K5 built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    res = {}
    for name, fn in (("lm", cs.drive_lm), ("lm_train", cs.drive_lm_train),
                     ("encdec", cs.drive_encdec), ("vlm", cs.drive_vlm)):
        t0 = time.perf_counter()
        res[name] = fn()
        print(f"[ab] {root}: {name} took {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.empty_cache()
    out.write_text(json.dumps(_jsonable(res)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="the parent revision's unpacked tree")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_one(args.run.resolve(), args.out)
        return
    if args.parent is None or not (args.parent / "chip_smoke.py").is_file():
        sys.exit("--parent must name a tree that holds chip_smoke.py")
    OUT.mkdir(exist_ok=True)
    runs = [("parent", args.parent.resolve()), ("change", ROOT),
            ("change", ROOT), ("parent", args.parent.resolve())]
    results = []
    for i, (tag, root) in enumerate(runs):
        out = OUT / f"k5_ab_{i}_{tag}.json"
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, __file__, "--run", str(root),
                             "--out", str(out)], cwd=root,
                            stdout=sys.stderr, stderr=sys.stderr).returncode
        print(f"[ab] run {i} ({tag}) exit {rc} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if rc:
            sys.exit(f"run {i} ({tag}) failed")
        results.append((tag, json.loads(out.read_text())))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[ab] {smi}; runs {' '.join(t for t, _ in results)}")
    for label, read in METRICS:
        vals = []
        for _, r in results:
            try:
                vals.append(read(r))
            except (KeyError, IndexError, TypeError):
                vals.append(None)
        by = {t: [v for (tt, _), v in zip(results, vals)
                  if tt == t and v is not None] for t in ("parent", "change")}
        ratio = (statistics.median(by["change"])
                 / statistics.median(by["parent"])
                 if by["change"] and by["parent"] else None)
        cells = " ".join("-" if v is None else f"{v:.3f}" for v in vals)
        print(f"[ab] {label}: {cells}; change / parent "
              f"{'-' if ratio is None else f'{ratio:.4f}'}")


if __name__ == "__main__":
    main()
