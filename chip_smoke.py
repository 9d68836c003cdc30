#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every result.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

  1. device  -- a CUDA card is visible; its name and power limit.
  2. build   -- nvcc builds the kernels from src/repro_torch/csrc.
  3. kernels -- each CUDA kernel against its plain PyTorch version on the
                card, at the shapes the main path gives it on Cora,
                Citeseer and Reddit, with the tolerance printed; times of
                kernel, plain version and (for seg_agg) torch.sparse.mm.
  4. main    -- the paper's GCN, SAGE and GIN (2 layers, hidden 128) at
                full width on Reddit, unfused and fused, through
                GCNModel with backend="auto"; launch counts of both
                kernels, logits against the torch tier on the same card,
                forward time and peak memory.

The last three lines are nvidia-smi's name and power limit, one JSON
object per kernel ({"kernels": [...]}) and the result line.  The full
per-shape table is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
#: the tensor cores -- both kernels compute in plain f32
HBM_BW = 3.35e12
F32_FLOPS = 67e12
#: unit f32 band (tests/tolerance.py) and the slack this script allows:
#: kernel and plain version add in different orders (slot order vs the
#: atomics of index_add_; slab-wise FMA vs cuBLAS), so results agree to a
#: few ulp of the largest magnitude, not bitwise
F32_BAND = 1e-5
SCALE = 10


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> tuple[float, float]:
    """(max |a - b|, tolerance): the f32 band times SCALE, relative to the
    largest magnitude of ``b``."""
    err = (a - b).abs().max().item()
    tol = F32_BAND * SCALE * max(1.0, b.abs().max().item())
    return err, tol


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least milliseconds for the work on the card, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(graphs, models):
    """Phase 3: every kernel against its plain version at the main path's
    shapes.  Returns one record per (kernel, graph, shape)."""
    import torch
    from repro_torch.core.phases import aggregate_cost
    from repro_torch.kernels import fused_agg_combine as k2
    from repro_torch.kernels import seg_agg as k1

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = {  # graph -> [(kernel, F_in, F_out)]
        "cora": [("seg_agg", 128, 128), ("seg_agg", 7, 7),
                 ("fused_agg_combine", 1433, 128),
                 ("fused_agg_combine", 128, 7)],
        "citeseer": [("fused_agg_combine", 3703, 128)],
        "reddit": [("seg_agg", 128, 128), ("seg_agg", 41, 41),
                   ("seg_agg", 602, 602), ("fused_agg_combine", 602, 128),
                   ("fused_agg_combine", 128, 41),
                   ("fused_agg_combine", 128, 128)],
    }
    records = []
    for gname, todo in shapes.items():
        g = graphs[gname]
        # the layouts the main path's plans use: agg_layout for unfused
        # aggregation, blocked for the fused layer
        plan = models[gname].plan_for(g, fused=True)
        agg_bg, fused_bg = plan.layers[0].agg_layout, plan.layers[0].blocked
        nnz = g.num_edges
        for kname, f_in, f_out in todo:
            x = torch.randn((g.num_vertices, f_in), generator=gen,
                            device="cuda")
            if kname == "seg_agg":
                bg = agg_bg
                args = (x, bg.src, bg.dstl, bg.mask, None)
                kern = lambda: k1.seg_agg(*args, tile_m=bg.tile_m)  # noqa
                plain = lambda: k1.seg_agg_plain(*args, tile_m=bg.tile_m)  # noqa
                nbytes = (x.numel() + 3 * bg.src.numel()
                          + bg.nblocks * bg.tile_m * f_out) * 4
                ops = nnz * f_in
                noreuse = aggregate_cost(g, f_in)["bytes"]
                adj = torch.sparse_csr_tensor(
                    g.row_ptr, g.src, torch.ones(nnz, device="cuda"),
                    size=(g.num_vertices, g.num_vertices))
                library = lambda: torch.sparse.mm(adj, x)  # noqa: E731
            else:
                bg = fused_bg
                w = torch.randn((f_in, f_out), generator=gen,
                                device="cuda") * (2.0 / f_in) ** 0.5
                args = (x, bg.src, bg.dstl, bg.mask, w)
                kern = lambda: k2.fused_agg_combine(*args, tile_m=bg.tile_m)  # noqa
                plain = lambda: k2.fused_agg_combine_plain(  # noqa: E731
                    *args, tile_m=bg.tile_m)
                nbytes = (x.numel() + 3 * bg.src.numel() + w.numel()
                          + bg.nblocks * bg.tile_m * f_out) * 4
                ops = nnz * f_in + 2 * g.num_vertices * f_in * f_out
                noreuse = (nnz * f_in + f_in * f_out
                           + g.num_vertices * f_out) * 4 + 8 * nnz
                library = None
            out_k, out_p = kern(), plain()
            torch.cuda.synchronize()
            err, tol = max_err(out_k, out_p)
            ok = bool(torch.isfinite(out_k).all().item()) and err <= tol
            del out_k, out_p
            b_ms, b_by = bound(nbytes, ops)
            rec = {"name": kname, "graph": gname, "f_in": f_in,
                   "f_out": f_out, "tile_m": bg.tile_m, "nblocks": bg.nblocks,
                   "emax": bg.emax, "max_abs_err": err, "tol": tol,
                   "ms": time_ms(kern, 10), "plain_ms": time_ms(plain, 2),
                   "bytes": nbytes, "ops": ops,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "noreuse_bytes": noreuse,
                   "bound_noreuse_ms": noreuse / HBM_BW * 1e3,
                   "library_ms": None if library is None
                   else time_ms(library, 10)}
            records.append(rec)
            print(f"[kernels] {kname:17s} {gname:8s} {f_in:4d}->{f_out:<4d} "
                  f"tile_m={bg.tile_m} layout={bg.nblocks}x{bg.emax} "
                  f"max_abs_err={err:.3e} tol={tol:.3e} ms={rec['ms']:.4f} "
                  f"plain_ms={rec['plain_ms']:.4f} "
                  f"library_ms={rec['library_ms']} bound_ms={b_ms:.4f} "
                  f"({b_by}; {nbytes} B, {ops} ops) no-reuse_bytes_ms="
                  f"{rec['bound_noreuse_ms']:.4f} ({noreuse} B)", flush=True)
            if not ok:
                fail(f"{kname} on {gname} {f_in}->{f_out}: kernel and plain "
                     f"version differ by {err:.3e} (tolerance {tol:.3e})")
    return records


def drive_main_path(g, x, spec):
    """Phase 4: GCN, SAGE and GIN at full width, unfused and fused, through
    the user entry point GCNModel(g, x) with backend="auto".  Returns the
    models, their logits and the launch counts of the run."""
    import torch
    from repro_torch.kernels import fused_agg_combine as k2
    from repro_torch.kernels import seg_agg as k1
    from repro_torch.models.gcn import make_paper_model

    models = {(name, fused): make_paper_model(
        name, spec, backend="auto", device="cuda", fused=fused,
        generator=torch.Generator().manual_seed(SEED))
        for name in ("gcn", "sage", "gin") for fused in (False, True)}
    for (name, fused), m in models.items():   # plans + layouts, host side
        m.plan_for(g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.seg_agg.launches = 0
    k2.fused_agg_combine.launches = 0
    with torch.inference_mode():
        logits = {key: m(g, x) for key, m in models.items()}
    torch.cuda.synchronize()
    counts = {"seg_agg": k1.seg_agg.launches,
              "fused_agg_combine": k2.fused_agg_combine.launches}
    peak = torch.cuda.max_memory_allocated()
    return models, logits, counts, peak


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run this script from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import CITESEER, CORA
    from repro_torch.graph.datasets import load_dataset, make_synthetic_graph
    from repro_torch.kernels import _build
    from repro_torch.models.gcn import make_paper_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[device] {kind} (count {count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # -- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {len(_build.SOURCES)} kernel libraries ready; "
          f"{len(logs)} compiled now in {time.perf_counter() - t0:.1f} s "
          f"(the rest were built earlier from the same sources)", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # -- 3. kernels against their plain versions
    t0 = time.perf_counter()
    g_red, x_red, _, spec_red = load_dataset("reddit", seed=SEED,
                                             device="cuda")
    graphs = {"cora": load_dataset("cora", seed=SEED, device="cuda")[0],
              "citeseer": make_synthetic_graph(CITESEER, SEED,
                                               device="cuda"),
              "reddit": g_red}
    print(f"[data] Reddit V={g_red.num_vertices} E={g_red.num_edges} "
          f"F={spec_red.feature_len} made in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    # a model per graph just to obtain the main path's layouts
    layout_models = {
        "cora": make_paper_model("gcn", CORA, device="cuda"),
        "citeseer": make_paper_model("gcn", CITESEER, device="cuda"),
        "reddit": make_paper_model("gcn", spec_red, device="cuda")}
    records = check_kernels(graphs, layout_models)
    del layout_models

    # -- 4. the main path at full width on Reddit
    models, logits, counts, peak = drive_main_path(g_red, x_red, spec_red)
    print(f"[main] launches {counts}; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    expected = {"seg_agg": 6, "fused_agg_combine": 6}
    if counts != expected:
        fail(f"main path launches {counts}, expected {expected}: every "
             f"unfused layer runs seg_agg once, every fused layer runs "
             f"fused_agg_combine once")
    with torch.inference_mode():
        for (name, fused), m in models.items():
            out = logits[(name, fused)]
            if tuple(out.shape) != (g_red.num_vertices,
                                    spec_red.num_classes) \
                    or not bool(torch.isfinite(out).all().item()):
                fail(f"{name} fused={fused}: logits {tuple(out.shape)} "
                     f"not finite or of the wrong shape")
            ref = m(g_red, x_red, plan=m.plan_for(g_red, backend="torch"))
            err, tol = max_err(out, ref)
            cross, ctol = max_err(out, logits[(name, not fused)])
            ms = time_ms(lambda: m(g_red, x_red), 3)
            print(f"[main] {name:4s} fused={fused!s:5s} logits "
                  f"{tuple(out.shape)} vs torch tier max_abs_err={err:.3e} "
                  f"tol={tol:.3e}; vs {'un' if fused else ''}fused "
                  f"{cross:.3e}; forward {ms:.3f} ms", flush=True)
            if err > tol or cross > ctol:
                fail(f"{name} fused={fused}: logits off the torch tier by "
                     f"{err:.3e} or off the other fusion by {cross:.3e}")
            del ref
    print(f"[main] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": kind, "nvidia_smi": smi, "launches": counts,
         "peak_bytes": peak, "records": records}, indent=1))

    # one line per kernel: the first record of each at Reddit's main shape
    main_shape = {"seg_agg": (128, 128), "fused_agg_combine": (602, 128)}
    source = {"seg_agg": ("src/repro_torch/csrc/seg_agg.cu",
                          "src/repro/kernels/seg_agg.py:74"),
              "fused_agg_combine": (
                  "src/repro_torch/csrc/fused_agg_combine.cu",
                  "src/repro/kernels/fused_agg_combine.py:73")}
    kernels = []
    for kname, (src, replaces) in source.items():
        rec = next(r for r in records if r["name"] == kname and
                   r["graph"] == "reddit" and
                   (r["f_in"], r["f_out"]) == main_shape[kname])
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": max(r["max_abs_err"] for r in records
                               if r["name"] == kname),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
