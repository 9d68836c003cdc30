#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every result.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

  1. device  -- a CUDA card is visible; its name and power limit.
  2. build   -- nvcc builds the kernels from src/repro_torch/csrc and
                prints ptxas's registers and spills per kernel;
                cuobjdump -sass shows HGMMA instructions with TF32
                operands in every instance of K2's fused kernel and of
                K5's f32 kernel.
  3. kernels -- each CUDA kernel against its plain PyTorch version on the
                card, at the shapes the main path gives it on Cora,
                Citeseer and Reddit, with the tolerance printed; times of
                kernel, plain version and (for seg_agg) torch.sparse.mm;
                every repeat launch bitwise equal to its first.  K2 is
                also held to a per-row and a relative Frobenius limit,
                which a control with one TF32 product instead of three
                must fail, and timed beside the unfused composition
                (seg_agg, then torch.matmul) and with its indices read
                from L2 instead of staged.
  4. main    -- the paper's GCN, SAGE and GIN (2 layers, hidden 128) at
                full width on Reddit, unfused and fused, through
                GCNModel with backend="auto"; launch counts of both
                kernels, logits against the torch tier on the same card,
                forward time and peak memory.
  5. flash   -- K5 (flash_attention) against its plain version in f32 and
                bf16 at gemma2's and granite's prefill shapes, the kv_len
                contract and a non-causal case: the max-abs band, and each
                row's error against that row's own scale and the relative
                Frobenius error, which a control that skips one KV tile
                must fail, and in f32 so must a control with one TF32
                product instead of three; two launches bit for bit equal;
                times of kernel, plain version and a library call
                (scaled_dot_product_attention where it computes the same
                function, flex_attention with a tanh score_mod where it
                compiles), and at (a) the kernel's time without the
                softcap.  The f32 bound is the tensor cores' 3xTF32 rate,
                the f32-FMA bound beside it.
  6. lm      -- gemma2-9b at full width and depth (42 layers, bf16, seeded
                random weights) through the port's ServeEngine: a wave of
                8 greedy requests of 17 to 6144 prompt tokens, 16 tokens
                each, with the decode step captured once as a CUDA graph
                and replayed; K5's launch count, prefill logits against an
                engine on the torch tier on the same card (max-abs band and
                relative Frobenius error), prefill, first-token
                and decode times, tokens/s, peak memory; profiles of a
                prefill, an eager and a replayed decode step; then the same
                wave with the decode step run eagerly, whose greedy tokens
                must equal the captured engine's for every request.
  7. lm f32  -- gemma2-9b in f32 at full width, depth cut to 2 layers: one
                6144-token lm_prefill, which takes K5's f32 path; its launch
                count and logits against the torch tier.
  8. compiled -- (run right after phase 4, on its models and graph) each of
                the six Reddit forwards through plan.compile(), one CUDA
                graph each: the capture's K1/K2 launches against the eager
                forward's, one capture and COMPILED_CALLS - 1 replays, every
                replay bitwise equal to eager, eager and replayed times over
                COMPILED_CALLS calls, peak memory with and without the
                graph, compile(layer=i) against run_layer; a torch-tier
                compile(dynamic=True) over a second seeded graph of the same
                V and E, within the f32 band, no recapture.
  9. report  -- (right after phase 8) plan.instrument().run_model(...,
                compiled=True) for the six: validated reports, written to
                chiprun_out/reports/ as JSON and markdown; ms per phase,
                its share and bound class (H100 and the paper's V100), the
                compiled speedup per layer; a PageRank row on Reddit.

The phases run in the order 1-4, 8, 9, 5-7.  The last three lines are nvidia-smi's name and power limit, one JSON
object per kernel ({"kernels": [...]}) and the result line.  The full
per-shape table is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
#: tensor cores (K1's adds, K2's adds), bf16 tensor-core FLOP/s, and TF32
#: tensor-core FLOP/s over three (K2's product and K5's f32 products are
#: three TF32 products each)
HBM_BW = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32X3_FLOPS = 495e12 / 3
#: the bf16 band (tests/tolerance.py): K5 and its plain version both
#: compute in f32 and round once to bf16, so they differ by about one bf16
#: ulp of the largest magnitude
BF16_BAND = 3e-2
#: phase 5's second check of K5, per dtype: the largest per-row error over
#: that row's largest magnitude, and the relative Frobenius error
#: ||kernel - plain|| / ||plain||.  The max-abs band above is relative to
#: the largest magnitude of the whole output, which the first query rows
#: (a few keys, magnitudes near 4) set, while a row that averages thousands
#: of keys is ~0.02: these hold every row to its own scale.  On the H100
#: the kernel reads at most 7.8e-03 (one bf16 ulp) / 2.2e-03 in bf16 and
#: 5.2e-06 / 8.6e-07 in f32 (3xTF32); ``drop_tile_control``, a kernel that
#: skips one KV tile, reads at least 0.69 / 0.037, and the f32 kernel with
#: one TF32 product instead of three at least 8.0e-04 / 2.9e-04 (PERF.md)
ROW_LIMIT = {"float32": 3e-5, "bfloat16": 2e-2}
FRO_LIMIT = {"float32": 3e-6, "bfloat16": 1e-2}
#: phase 6: the relative Frobenius error of each prompt's prefill logits
#: against the torch tier's; the H100 reads 2.1e-02 to 2.6e-02 (PERF.md,
#: PR 14)
LOGIT_FRO_LIMIT = 5e-2
#: K5 shapes: name -> (B, Hq, Hkv, Sq, Sk, D, causal, window, softcap,
#: kv_len).  (a)/(b) gemma2-9b's global and local prefill layers at the
#: longest prompt of phase 6, (c) a ragged short gemma2 prompt, (d) a
#: granite-3-8b layer, (e) the right-aligned kv_len contract, (f) the
#: reference test's non-causal case.
FLASH_SHAPES = {
    "a": (1, 16, 8, 6144, 6144, 256, True, 0, 50.0, None),
    "b": (1, 16, 8, 6144, 6144, 256, True, 4096, 50.0, None),
    "c": (1, 16, 8, 17, 17, 256, True, 4096, 50.0, None),
    "d": (1, 32, 8, 4096, 4096, 128, True, 0, 0.0, None),
    "e": (2, 16, 8, 8, 300, 256, True, 0, 0.0, (50, 300)),
    "f": (1, 2, 2, 96, 96, 128, False, 0, 0.0, None),
}
#: phase 3: seg_agg's column slices timed beside the one the wrapper picks
#: (slice_cols), at Reddit (F -> widths); every width gives the same sums
#: bit for bit (slicing does not change any column's fold)
SLICE_SWEEP = {128: (32, 64), 41: (24, 41), 602: (32, 64)}
#: phase 7: layers of the f32 gemma2-9b (full width, depth cut)
LM_F32_LAYERS = 2
#: phase 6: the wave's prompt lengths (two of them past gemma2's 4096
#: window, so the local layers mask rows), slots, cache and tokens
LM_PROMPTS = (17, 100, 512, 1000, 2048, 4097, 6144, 33)
LM_MAX_BATCH, LM_CACHE, LM_TOKENS = 4, 6400, 16
#: K5's kernels as the profiler names them (csrc/flash_attention.cu)
K5_KERNELS = ("wgmma_kernel", "tf32x3_kernel")
#: unit f32 band (tests/tolerance.py) and the slack this script allows:
#: kernel and plain version add in different orders (slot order vs the
#: atomics of index_add_; 3xTF32 slices vs cuBLAS), so results agree to a
#: few ulp of the largest magnitude, not bitwise
F32_BAND = 1e-5
SCALE = 10
#: phase 8: calls of each compiled forward (the first captures, the rest
#: replay), also the count each time is averaged over
COMPILED_CALLS = 20
#: phase 9: PageRank power iterations timed on Reddit
PAGERANK_ITERS = 20


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


def bound(nbytes: float, ops: float,
          peak: float = F32_FLOPS) -> tuple[float, str]:
    """Least milliseconds for the work on the card, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ratios(rec) -> dict:
    """frac_of_bound (bound / kernel time) and vs_library (kernel time /
    library time, None without a library call) of a record."""
    lib = rec.get("library_ms")
    return {"frac_of_bound": rec["bound_ms"] / rec["ms"],
            "vs_library": None if lib is None else rec["ms"] / lib}


def check_sass(name: str = "fused_agg_combine",
               kernel: str = "fused_kernel") -> dict:
    """A 3xTF32 kernel on the tensor cores: ``cuobjdump -sass`` of the
    built library ``name`` shows HGMMA instructions with TF32 operands in
    every instance of ``kernel`` (K2's fused_kernel, K5's tf32x3_kernel).
    Returns {instance: HGMMA count}; fails if an instance has none."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, example, fn = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if kernel in fn:
                counts[fn] = 0
        elif fn in counts and "HGMMA" in line and "TF32" in line:
            counts[fn] += 1
            example = example or " ".join(line.split("*/", 1)[-1].split())
    print(f"[build] {name} SASS: {len(counts)} instances of {kernel}, "
          f"HGMMA with TF32 operands in each: {sorted(counts.values())}; "
          f"e.g. {example}", flush=True)
    if not counts or not all(counts.values()):
        fail(f"{name}: an instance of {kernel} has no TF32 HGMMA ({counts})")
    return counts


def slice_sweep(x, bg, f, kern) -> dict:
    """seg_agg at each width of SLICE_SWEEP[f]: {width: ms}.  Fails unless
    every width's sums equal the default launch's bit for bit."""
    import torch
    from repro_torch.kernels import seg_agg as k1
    want, out = kern(), {}
    for w in SLICE_SWEEP.get(f, ()):
        run = lambda: k1._launch(x, bg.src, bg.dstl, bg.mask,  # noqa: E731
                                 None, bg.tile_m, w)
        if not torch.equal(run(), want):
            fail(f"seg_agg at F={f}: slice width {w} changes the sums")
        out[w] = time_ms(run, 10)
    print(f"[kernels] seg_agg reddit F={f} slice widths: " + ", ".join(
        f"{w} -> {ms:.4f} ms" for w, ms in out.items()), flush=True)
    return out


def k2_unstaged(args, tile_m, want) -> float:
    """fused_agg_combine with its indices read from L2 in every slice
    instead of staged once in shared memory (cap 0): its ms.  Fails unless
    it gives the default launch's sums bit for bit."""
    import torch
    from repro_torch.kernels import fused_agg_combine as k2
    run = lambda: k2._launch(*args, tile_m, cap=0)  # noqa: E731
    if not torch.equal(run(), want):
        fail(f"fused_agg_combine {tuple(args[-1].shape)}: unstaged indices "
             f"change the sums")
    return time_ms(run, 10)


def check_kernels(graphs, models):
    """Phase 3: every kernel against its plain version at the main path's
    shapes.  Returns one record per (kernel, graph, shape).  K2 is also
    held to K2_LIMITS per row and in Frobenius norm, a one-TF32-product
    control must fail both, and its time is set beside the unfused
    composition (seg_agg, then torch.matmul)."""
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
                # the composition fusion is weighed against: the unfused
                # plan's aggregation, then the product
                unfused = lambda: k1.seg_agg(  # noqa: E731
                    x, agg_bg.src, agg_bg.dstl, agg_bg.mask, None,
                    tile_m=agg_bg.tile_m)[:g.num_vertices] @ w
            out_k, out_p = kern(), plain()
            torch.cuda.synchronize()
            err, tol = max_err(out_k, out_p)
            ok = bool(torch.isfinite(out_k).all().item()) and err <= tol
            # the fold is in slot order: a second launch is bit for bit equal
            same = torch.equal(out_k, kern())
            if kname == "fused_agg_combine":
                row, fro = rel_errs(out_k, out_p)
                one = k2._launch(*args, bg.tile_m, terms=1)
                c_row, c_fro = rel_errs(one, out_p)
                del one
                unstaged = k2_unstaged(args, bg.tile_m, out_k) \
                    if gname == "reddit" else None
            del out_k
            b_ms, b_by = bound(nbytes, ops)
            if kname == "fused_agg_combine":
                # the adds in f32, the product on the tensor cores in
                # 3xTF32: counted as f32 operations of the same time
                prod = 2 * g.num_vertices * f_in * f_out
                b_ms, b_by = bound(nbytes, nnz * f_in
                                   + prod * F32_FLOPS / TF32X3_FLOPS)
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
            rec.update(ratios(rec))
            if kname == "seg_agg":
                rec["slice_cols"] = k1.slice_cols(f_in)
                if gname == "reddit":
                    rec["slice_sweep_ms"] = slice_sweep(x, bg, f_in, kern)
            else:
                rec.update(
                    bound_f32fma_ms=bound(nbytes, ops)[0],
                    row_rel_err=row, fro_rel_err=fro,
                    control_row_rel_err=c_row, control_fro_rel_err=c_fro,
                    unfused_ms=time_ms(unfused, 10), unstaged_ms=unstaged,
                    slot_capacity=k2.slot_capacity(bg.tile_m, bg.emax,
                                                   f_out))
            records.append(rec)
            print(f"[kernels] {kname:17s} {gname:8s} {f_in:4d}->{f_out:<4d} "
                  f"tile_m={bg.tile_m} layout={bg.nblocks}x{bg.emax} "
                  f"max_abs_err={err:.3e} tol={tol:.3e} ms={rec['ms']:.4f} "
                  f"plain_ms={rec['plain_ms']:.4f} "
                  f"library_ms={rec['library_ms']} bound_ms={b_ms:.4f} "
                  f"({b_by}; {nbytes} B, {ops} ops) no-reuse_bytes_ms="
                  f"{rec['bound_noreuse_ms']:.4f} ({noreuse} B) "
                  f"frac_of_bound={rec['frac_of_bound']:.4f} vs_library="
                  f"{rec['vs_library']}"
                  + (f" slice_cols={rec['slice_cols']}"
                     if kname == "seg_agg" else
                     f" bound_f32fma_ms={rec['bound_f32fma_ms']:.4f} "
                     f"unfused_ms={rec['unfused_ms']:.4f} unstaged_ms="
                     f"{unstaged} row_rel_err="
                     f"{row:.3e} fro_rel_err={fro:.3e} (limits "
                     f"{k2.ROW_LIMIT:.0e}/{k2.FRO_LIMIT:.0e}; control with "
                     f"one TF32 product {c_row:.3e}/{c_fro:.3e})"),
                  flush=True)
            if not ok:
                fail(f"{kname} on {gname} {f_in}->{f_out}: kernel and plain "
                     f"version differ by {err:.3e} (tolerance {tol:.3e})")
            if not same:
                fail(f"{kname} on {gname} {f_in}->{f_out}: two launches on "
                     f"the same input differ")
            if kname == "fused_agg_combine":
                if row > k2.ROW_LIMIT or fro > k2.FRO_LIMIT:
                    fail(f"{kname} on {gname} {f_in}->{f_out}: a row off by "
                         f"{row:.3e} of its scale or {fro:.3e} relative "
                         f"Frobenius error (limits {k2.ROW_LIMIT:.0e}, "
                         f"{k2.FRO_LIMIT:.0e})")
                if c_row <= k2.ROW_LIMIT or c_fro <= k2.FRO_LIMIT:
                    fail(f"{kname} on {gname} {f_in}->{f_out}: the check "
                         f"cannot see one TF32 product ({c_row:.3e}, "
                         f"{c_fro:.3e})")
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


def drive_compiled(models, g, x, spec):
    """Phase 8: the six Reddit models through plan.compile() (one CUDA
    graph each).  Fails unless a capture records the eager forward's K1/K2
    launches, the forward is captured once over COMPILED_CALLS calls with a
    replay for every call after the first, every replay's logits equal the
    eager forward's bit for bit, each layer's compile(layer=i) equals
    run_layer, and a torch-tier dynamic plan serves a second graph of the
    same V and E within the f32 band with no recapture (another shape
    raises).  Returns the measurements."""
    import torch
    from repro_torch.graph.datasets import make_synthetic_graph
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models.gcn import make_paper_model

    def launched(fn):
        before = launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: n - before[k] for k, n in launch_counts().items()}

    out = {}
    for (name, fused), m in models.items():
        key = f"{name}_{'fused' if fused else 'unfused'}"
        plan, params = m.plan_for(g), m.tree()
        with torch.inference_mode():
            # memory above what is allocated already (x, the layouts and
            # the earlier models' graphs, which phase 9 reuses)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eager, counts = launched(lambda: plan.run_model(params, x))
            eager_peak = torch.cuda.max_memory_allocated() - base
            fn = plan.compile()
            torch.cuda.reset_peak_memory_stats()
            first, first_counts = launched(lambda: fn(params, x))
            same = [torch.equal(first, eager)]
            _, replay_counts = launched(lambda: [
                same.append(torch.equal(fn(params, x), eager))
                for _ in range(COMPILED_CALLS - 1)])
            compiled_peak = torch.cuda.max_memory_allocated() - base
            # what the graph keeps: its pool and its static buffers
            resident = torch.cuda.memory_allocated() - base - \
                eager.numel() * eager.element_size()
            traces, replays = fn.num_traces, fn.num_replays
            captured = {k: fn.capture_launches.get(k, 0) for k in counts}
            ms = time_ms(lambda: plan.run_model(params, x), COMPILED_CALLS)
            ms_graph = time_ms(lambda: fn(params, x), COMPILED_CALLS)
            # the replay alone, without copying the inputs in and the
            # output out
            graph = next(iter(fn._traces.values())).graph
            ms_replay = time_ms(graph.replay, COMPILED_CALLS)
            layers_equal = []
            h = x
            for i in range(plan.num_layers):
                sub = params[f"conv{i}"]
                want = plan.run_layer(sub, h, layer=i)
                fl = plan.compile(layer=i)
                layers_equal.append(all(torch.equal(fl(sub, h), want)
                                        for _ in range(3)))
                h = torch.relu(want)
        rec = {"eager_ms": ms, "graph_ms": ms_graph,
               "replay_only_ms": ms_replay,
               "eager_peak_bytes": eager_peak,
               "compiled_peak_bytes": compiled_peak,
               "graph_resident_bytes": resident,
               "eager_launches": counts,
               "capture_launches": captured,
               "first_call_launches": first_counts,
               "replay_launches": replay_counts,
               "num_traces": traces, "num_replays": replays,
               "replays_equal": all(same), "layers_equal": layers_equal}
        out[key] = rec
        print(f"[compiled] {name:4s} fused={fused!s:5s} eager {ms:.3f} ms, "
              f"compiled call {ms_graph:.3f} ms ({ms / ms_graph:.2f}x; the "
              f"replay alone {ms_replay:.3f} ms) over {COMPILED_CALLS} "
              f"calls; "
              f"captures {traces}, replays {replays}; launches eager "
              f"{counts}, captured {captured}, in "
              f"{COMPILED_CALLS - 1} replays {replay_counts}; every replay "
              f"equal to eager bit for bit: {all(same)}; layers "
              f"{layers_equal}; peak memory above the inputs: eager "
              f"{eager_peak / 2**30:.3f} GiB, compiled calls "
              f"{compiled_peak / 2**30:.3f} GiB, the graph keeps "
              f"{resident / 2**30:.3f} GiB", flush=True)
        if captured != counts or traces != 1 or \
                replays != COMPILED_CALLS - 1 or any(replay_counts.values()):
            fail(f"{key}: captured launches {captured} against eager "
                 f"{counts}, {traces} captures, {replays} replays, launch "
                 f"counters moved by {replay_counts} in the replays")
        if not (all(same) and all(layers_equal)):
            fail(f"{key}: a replay differs from the eager forward")
        del eager, first

    # the graph as an argument: torch tier, unfused, a second seeded graph
    m = make_paper_model("gcn", spec, backend="torch", device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    plan, params = m.plan_for(g, fused=False), m.tree()
    g2 = make_synthetic_graph(spec, SEED + 1, device="cuda")
    fn = plan.compile(dynamic=True)
    with torch.inference_mode():
        want = plan.run_model(params, x, graph=g2)
        mine = plan.run_model(params, x)
        own, got = fn(params, x, g), fn(params, x, g2)
        err, tol = max_err(got, want)
        own_err, own_tol = max_err(own, mine)
        ms = time_ms(lambda: plan.run_model(params, x, graph=g2), 3)
        ms_graph = time_ms(lambda: fn(params, x, g2), 3)
        try:
            fn(params, x, g._replace(src=g.src[1:], dst=g.dst[1:]))
            raised = False
        except ValueError:
            raised = True
    print(f"[compiled] dynamic torch tier gcn over a second graph "
          f"(V={g2.num_vertices} E={g2.num_edges}, seed {SEED + 1}): "
          f"max_abs_err={err:.3e} tol={tol:.3e}; own graph {own_err:.3e}; "
          f"traces {fn.num_traces}, replays {fn.num_replays}; eager "
          f"{ms:.3f} ms, replay {ms_graph:.3f} ms; another shape raises "
          f"ValueError: {raised}", flush=True)
    if not (err <= tol and own_err <= own_tol and fn.num_traces == 1
            and raised):
        fail(f"dynamic compiled plan: error {err:.3e} (tol {tol:.3e}), own "
             f"graph {own_err:.3e}, {fn.num_traces} captures, other shape "
             f"raised: {raised}")
    out["dynamic_torch_gcn"] = {"max_abs_err": err, "tol": tol,
                                "eager_ms": ms, "graph_ms": ms_graph,
                                "num_traces": fn.num_traces}
    return out


def characterize(models, g, x):
    """Phase 9: plan.instrument().run_model(..., compiled=True) for the six
    Reddit models: every report validates, describes what ran
    (mismatches == []), and lands as JSON and markdown in
    chiprun_out/reports/.  Prints the paper's Table 3/4 breakdown on this
    card (ms per phase, share of the forward, bound class against the H100
    and the paper's V100) and the compiled speedup per layer, then a
    PageRank row on the same graph.  Returns the measurements."""
    import torch
    from repro_torch.models.mlp import mlp_cost
    from repro_torch.models.pagerank import pagerank, pagerank_cost
    from repro_torch.profile.machine import H100, V100

    out_dir = ROOT / "chiprun_out" / "reports"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for (name, fused), m in models.items():
        key = f"{name}_{'fused' if fused else 'unfused'}"
        plan = m.plan_for(g)
        rep = plan.instrument().run_model(m.tree(), x, compiled=True)
        rep.validate()
        bad = rep.mismatches(plan)
        (out_dir / f"{key}.json").write_text(rep.to_json())
        (out_dir / f"{key}.md").write_text(rep.to_markdown())
        total = rep.totals()["wall_time_s"]
        phases = {}
        for r in rep.records:
            ph = phases.setdefault(r.phase, {"ms": 0.0, "bound": set(),
                                             "bound_v100": set()})
            ph["ms"] += r.wall_time_s * 1e3
            ph["bound"].add(r.bound)
            ph["bound_v100"].add(V100.classify(r.arithmetic_intensity))
        sp = rep.compiled_speedup()
        rows = {ph: {"ms": v["ms"], "share": v["ms"] / (total * 1e3),
                     "bound": sorted(v["bound"]),
                     "bound_v100": sorted(v["bound_v100"])}
                for ph, v in phases.items()}
        out[key] = {"phases": rows, "eager_ms": total * 1e3,
                    "compiled_model_ms": rep.compiled_times["model_s"] * 1e3,
                    "compiled_layers_ms": [t * 1e3 for t in
                                           rep.compiled_times["layers_s"]],
                    "speedup": sp, "mismatches": bad}
        print(f"[report] {name:4s} fused={fused!s:5s} phases: " + "; ".join(
            f"{ph} {v['ms']:.3f} ms ({100 * v['share']:.1f}%, "
            f"{'/'.join(v['bound'])} on H100, "
            f"{'/'.join(v['bound_v100'])} on V100)"
            for ph, v in rows.items())
            + f"; eager forward {total * 1e3:.3f} ms (synchronized per "
            f"phase), compiled {rep.compiled_times['model_s'] * 1e3:.3f} ms"
            f" = {sp['model']:.2f}x; per layer "
            + ", ".join(f"{s:.2f}x" for s in sp["layers"]), flush=True)
        if bad:
            fail(f"{key}: describe() disagrees with the dispatch: {bad}")
        if plan.compile().num_traces != 1:
            fail(f"{key}: phase 9 captured the forward again")
    with torch.inference_mode():
        r = pagerank(g, iters=PAGERANK_ITERS)
        mass = float(r.sum().item())
        ms = time_ms(lambda: pagerank(g, iters=PAGERANK_ITERS),
                     3) / PAGERANK_ITERS
    c = pagerank_cost(g)
    ai = c["flops"] / c["bytes"]
    out["pagerank"] = {"ms_per_iter": ms, "bytes": c["bytes"],
                       "flops": c["flops"], "arithmetic_intensity": ai,
                       "bound": H100.classify(ai),
                       "bound_v100": V100.classify(ai), "rank_mass": mass}
    mc = mlp_cost()
    out["mlp"] = {**mc, "bound": H100.classify(mc["arithmetic_intensity"]),
                  "bound_v100": V100.classify(mc["arithmetic_intensity"])}
    print(f"[report] pagerank on Reddit: {ms:.3f} ms per iteration "
          f"({PAGERANK_ITERS} iterations, gather + index_add_), "
          f"{c['bytes']} B and {c['flops']} flops per iteration, AI "
          f"{ai:.4f} F/B: {H100.classify(ai)}-bound on H100, "
          f"{V100.classify(ai)}-bound on V100; rank mass {mass:.6f}; MLP "
          f"784-128 x 1000: AI {mc['arithmetic_intensity']:.1f} F/B, "
          f"{out['mlp']['bound']}-bound on H100, {out['mlp']['bound_v100']}"
          f"-bound on V100", flush=True)
    if not abs(mass - 1.0) < 1e-3:
        fail(f"pagerank ranks sum to {mass}, expected 1")
    return out


def unmasked_pairs(sq, sk, causal, window, kv_len) -> int:
    """(query, key) pairs K5 must compute: summed over the batch, the keys
    each query row may see (right-aligned positions, as the kernel)."""
    import numpy as np
    total = 0
    for n in kv_len:
        qpos = n - sq + np.arange(sq, dtype=np.int64)
        hi = np.minimum(qpos + 1, n) if causal else np.full(sq, n)
        lo = np.maximum(qpos - window + 1, 0) if window > 0 else 0
        total += int(np.clip(hi - lo, 0, None).sum())
    return total


def rel_errs(out, want) -> tuple[float, float]:
    """(largest per-row error over that row's largest magnitude, relative
    Frobenius error) of ``out`` against ``want``, rows along the last dim.
    A row where ``want`` is all 0 counts its largest |out| (0 if right)."""
    import torch
    a, b = out.float().flatten(0, -2), want.float().flatten(0, -2)
    diff, mag = (a - b).abs().amax(-1), b.abs().amax(-1)
    row = torch.where(mag > 0, diff / mag.clamp_min(1e-30), diff)
    fro = (a - b).norm() / b.norm().clamp_min(1e-30)
    return row.max().item(), fro.item()


def drop_tile_control(shape, q, k, v, tile=64):
    """A control that is wrong on purpose: K5's function, computed densely
    one head at a time in f32, with the KV tile of ``tile`` keys that holds
    the middle key of the shortest sequence left out of every row -- what a
    kernel that skipped that tile would return.  ``rel_errs`` must see it
    above ROW_LIMIT and FRO_LIMIT."""
    import torch
    b, hq, hkv, sq, sk, d, causal, window, cap, kv_len = shape
    lens = kv_len or (sk,) * b
    t0 = min(lens) // 2 // tile * tile
    kpos = torch.arange(sk, device=q.device)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for bi, n in enumerate(lens):
        qpos = (n - sq + torch.arange(sq, device=q.device))[:, None]
        keep = (kpos < n) & ((kpos < t0) | (kpos >= t0 + tile))
        keep = keep & (kpos <= qpos) if causal else keep.expand(sq, sk)
        if window > 0:
            keep = keep & (kpos > qpos - window)
        for h in range(hq):
            s = (q[bi, h] * d ** -0.5).float() @ \
                k[bi, h // (hq // hkv)].float().T
            if cap > 0:
                s = cap * torch.tanh(s / cap)
            p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
            out[bi, h] = p.nan_to_num(0.0) @ v[bi, h // (hq // hkv)].float()
    return out.to(q.dtype)


def flash_library(shape, q, k, v, want, tol):
    """(milliseconds, note) of one PyTorch call computing the same function
    as K5 at ``shape`` -- held against the plain version's ``want`` within
    ``tol`` -- or (None, reason).  A yardstick: the port never calls
    these."""
    import torch
    import torch.nn.functional as F
    b, hq, hkv, sq, sk, d, causal, window, cap, kv_len = shape

    def timed(fn, note):
        err = (fn().float() - want.float()).abs().max().item()
        if not err <= tol:
            return None, f"none: {note} differs from the plain version by " \
                f"{err:.3e}"
        return time_ms(fn, 5), f"{note}, max_abs_err {err:.3e}"

    if kv_len is None and sq == sk and cap == 0 and window == 0:
        g = hq // hkv
        ke = k.repeat_interleave(g, dim=1)   # outside the timed region
        ve = v.repeat_interleave(g, dim=1)
        return timed(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=causal),
            "scaled_dot_product_attention, K/V expanded")
    if not (kv_len is None and sq == sk and causal and cap > 0):
        return None, "none: no PyTorch call computes this shape's function"
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def score_mod(score, bi, hi, qi, ki):
            return cap * torch.tanh(score / cap)

        def mask_mod(bi, hi, qi, ki):
            m = ki <= qi
            return m & (ki > qi - window) if window > 0 else m

        block_mask = create_block_mask(mask_mod, None, None, sq, sk,
                                       device=q.device)
        flex = torch.compile(flex_attention)
        return timed(lambda: flex(q, k, v, score_mod=score_mod,
                                  block_mask=block_mask, enable_gqa=True),
                     "flex_attention (torch.compile), tanh score_mod, "
                     "block mask")
    except Exception as e:  # a yardstick only: K5's checks do not need it
        return None, f"none: flex_attention did not run ({type(e).__name__}:" \
            f" {str(e).splitlines()[0][:160] if str(e) else ''})"


def check_flash():
    """Phase 5: K5 against its plain version at FLASH_SHAPES, f32 and bf16.
    Fails unless every launch meets the band and the per-row and Frobenius
    limits, the drop-tile control (and in f32 the one-TF32-product control)
    fails both limits, and a second launch equals the first bit for bit.
    Returns one record per (shape, dtype)."""
    import torch
    from repro_torch.kernels import flash_attention as k5

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = []
    for name, shape in FLASH_SHAPES.items():
        b, hq, hkv, sq, sk, d, causal, window, cap, kv_len = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shp, generator=gen, device="cuda",
                                   dtype=dtype)
                       for shp in ((b, hq, sq, d), (b, hkv, sk, d),
                                   (b, hkv, sk, d)))
            kvl = None if kv_len is None else torch.tensor(
                kv_len, dtype=torch.int32, device="cuda")
            kw = dict(causal=causal, window=window, softcap=cap)
            kern = lambda: k5.flash_attention(q, k, v, kvl, **kw)  # noqa
            plain = lambda: k5.flash_attention_plain(  # noqa: E731
                q, k, v, kvl, **kw)
            out_k, out_p = kern(), plain()
            torch.cuda.synchronize()
            err = (out_k.float() - out_p.float()).abs().max().item()
            band = F32_BAND * SCALE if dtype == torch.float32 else BF16_BAND
            tol = band * max(1.0, out_p.float().abs().max().item())
            ok = bool(torch.isfinite(out_k).all().item()) and err <= tol
            dname = str(dtype).replace("torch.", "")
            row, fro = rel_errs(out_k, out_p)
            c_row, c_fro = rel_errs(drop_tile_control(shape, q, k, v),
                                    out_p)
            same = torch.equal(out_k, kern())
            t_row = t_fro = None
            if dtype == torch.float32:  # one TF32 product instead of three
                t_row, t_fro = rel_errs(k5._launch(q, k, v, kvl, terms=1,
                                                   **kw), out_p)
            del out_k
            elt = q.element_size()
            pairs = unmasked_pairs(sq, sk, causal, window,
                                   kv_len or (sk,) * b)
            ops = 4 * d * hq * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt + 4 * b
            # f32: both products on the tensor cores in 3xTF32
            peak = TF32X3_FLOPS if dtype == torch.float32 else BF16_FLOPS
            b_ms, b_by = bound(nbytes, ops, peak)
            ms = time_ms(kern, 5)
            lib_ms, lib_note = flash_library(shape, q, k, v, out_p, tol)
            del out_p
            rec = {"name": "flash_attention", "shape": name, "dtype": dname,
                   "b": b, "hq": hq, "hkv": hkv, "sq": sq, "sk": sk, "d": d,
                   "causal": causal, "window": window, "softcap": cap,
                   "kv_len": kv_len, "max_abs_err": err, "tol": tol,
                   "row_rel_err": row, "fro_rel_err": fro,
                   "control_row_rel_err": c_row,
                   "control_fro_rel_err": c_fro,
                   "control_tf32_row_rel_err": t_row,
                   "control_tf32_fro_rel_err": t_fro, "repeat_equal": same,
                   "ms": ms, "plain_ms": time_ms(plain, 2),
                   "pairs": pairs, "bytes": nbytes, "ops": ops,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms, "library": lib_note,
                   "tflops": ops / ms / 1e9}
            if dtype == torch.float32:
                rec["bound_f32fma_ms"] = bound(nbytes, ops, F32_FLOPS)[0]
            rec.update(ratios(rec))
            if name == "a":
                # what the softcap's tanh costs: the same call without it
                rec["ms_no_softcap"] = time_ms(lambda: k5.flash_attention(
                    q, k, v, kvl, causal=causal, window=window), 5)
                if dtype == torch.float32:
                    # what the two extra TF32 products cost: the control
                    rec["ms_one_tf32"] = time_ms(lambda: k5._launch(
                        q, k, v, kvl, terms=1, **kw), 5)
            records.append(rec)
            print(f"[flash] ({name}) {rec['dtype']:8s} B={b} Hq={hq} "
                  f"Hkv={hkv} Sq={sq} Sk={sk} D={d} causal={causal} "
                  f"window={window} cap={cap} kv_len={kv_len} "
                  f"max_abs_err={err:.3e} tol={tol:.3e} row_rel_err="
                  f"{row:.3e} fro_rel_err={fro:.3e} (limits "
                  f"{ROW_LIMIT[dname]:.0e}/{FRO_LIMIT[dname]:.0e}; control "
                  f"skipping a KV tile {c_row:.3e}/{c_fro:.3e}"
                  + (f"; control with one TF32 product {t_row:.3e}/"
                     f"{t_fro:.3e}" if t_row is not None else "")
                  + f") repeat_equal={same} ms={ms:.4f} "
                  f"plain_ms={rec['plain_ms']:.4f} library_ms={lib_ms} "
                  f"[{lib_note}] bound_ms={b_ms:.4f} ({b_by}; {nbytes} B, "
                  f"{ops} ops) achieved {rec['tflops']:.2f} TFLOP/s "
                  f"frac_of_bound={rec['frac_of_bound']:.4f} vs_library="
                  f"{rec['vs_library']}"
                  + (f" bound_f32fma_ms={rec['bound_f32fma_ms']:.4f}"
                     if "bound_f32fma_ms" in rec else "")
                  + (f" ms_no_softcap={rec['ms_no_softcap']:.4f}"
                     if "ms_no_softcap" in rec else "")
                  + (f" ms_one_tf32={rec['ms_one_tf32']:.4f}"
                     if "ms_one_tf32" in rec else ""), flush=True)
            if not ok:
                fail(f"flash_attention ({name}) {dtype}: kernel and plain "
                     f"version differ by {err:.3e} (tolerance {tol:.3e})")
            if row > ROW_LIMIT[dname] or fro > FRO_LIMIT[dname]:
                fail(f"flash_attention ({name}) {dtype}: a row off by "
                     f"{row:.3e} of its scale or {fro:.3e} relative "
                     f"Frobenius error (limits {ROW_LIMIT[dname]:.0e}, "
                     f"{FRO_LIMIT[dname]:.0e})")
            if c_row <= ROW_LIMIT[dname] or c_fro <= FRO_LIMIT[dname]:
                fail(f"flash_attention ({name}) {dtype}: the check cannot "
                     f"see a skipped KV tile ({c_row:.3e}, {c_fro:.3e})")
            if t_row is not None and (t_row <= ROW_LIMIT[dname]
                                      or t_fro <= FRO_LIMIT[dname]):
                fail(f"flash_attention ({name}) {dtype}: the check cannot "
                     f"see one TF32 product ({t_row:.3e}, {t_fro:.3e})")
            if not same:
                fail(f"flash_attention ({name}) {dtype}: two launches on the "
                     f"same input differ")
            del q, k, v
    return records


def profile_lm(model, eng, prompts):
    """Where the time of one short prefill, one long prefill and one decode
    step goes: torch.profiler traces each (after the wave, so warm), and
    the kernel events of the trace give the device's busy time, K5's part
    of it and the share of the wall time the device is idle.  Traces land
    in chiprun_out/traces/."""
    import torch
    from repro_torch.models.transformer import lm_decode_step, lm_prefill
    from torch.profiler import ProfilerActivity, profile

    out_dir = ROOT / "chiprun_out" / "traces"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = model.device
    toks = torch.as_tensor(eng._last_tokens, device=dev)
    work = {f"prefill_{len(prompts[0])}": lambda: lm_prefill(
                model, torch.as_tensor(prompts[0][None], device=dev),
                LM_CACHE),
            f"prefill_{len(prompts[6])}": lambda: lm_prefill(
                model, torch.as_tensor(prompts[6][None], device=dev),
                LM_CACHE),
            "decode_step": lambda: lm_decode_step(
                model, toks, eng._caches, eng._length),
            # the engine's captured decode step: one replay of its graph
            "decode_step_graph": lambda: eng._graph[0].replay()}
    rows = {}
    for name, fn in work.items():
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        path = out_dir / f"{name}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())
        events = events.get("traceEvents", events)
        kern = [e for e in events if e.get("cat") == "kernel"]
        busy = sum(e["dur"] for e in kern) / 1e3
        k5_ms = sum(e["dur"] for e in kern
                    if any(k in e.get("name", "") for k in K5_KERNELS)) / 1e3
        rows[name] = {"wall_ms": wall, "kernels": len(kern),
                      "device_busy_ms": busy, "k5_ms": k5_ms,
                      "idle_share": 1 - busy / wall if kern else None}
        print(f"[lm] profile {name}: wall {wall:.2f} ms, {len(kern)} "
              f"kernels, device busy {busy:.2f} ms (K5 {k5_ms:.2f} ms), "
              f"device idle "
              + (f"{100 * (1 - busy / wall):.1f}%" if kern else
                 "not measured (no kernel in the trace)"), flush=True)
    return rows


def drive_lm():
    """Phase 6: gemma2-9b at full width and depth through the port's
    ServeEngine (attn_impl="auto": K5 for every prefill), then the same
    wave on the torch tier on the same card with the same weights.
    Returns the measurements."""
    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve.engine import Request, ServeEngine

    class TimedEngine(ServeEngine):
        """ServeEngine that records per request the prefill's last-position
        logits, its time and the time to first token, and per step the
        decode time and any K5 launch."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.first_logits, self.prefill_ms, self.ttft_ms = {}, {}, {}
            self.step_ms, self.decode_launches = [], 0

        def _prefill_into_slot(self, slot, req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._prefill_into_slot(slot, req)   # ends in a host copy
            self.prefill_ms[req.rid] = (time.perf_counter() - t0) * 1e3
            self.ttft_ms[req.rid] = (time.time() - req.enqueue_t) * 1e3

        def _sample(self, logits, req):
            if not req.output:
                self.first_logits[req.rid] = np.array(logits, np.float32)
            return super()._sample(logits, req)

        def _step(self):
            n, t0 = k5.flash_attention.launches, time.perf_counter()
            done = super()._step()                  # ends in a host copy
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.decode_launches += k5.flash_attention.launches - n
            return done

    cfg = get_config("gemma2-9b")
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[lm] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters in {cfg.dtype}, made on "
          f"the card in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in LM_PROMPTS]

    def serve(attn_impl, decode_graph=True):
        eng = TimedEngine(cfg, model, max_batch=LM_MAX_BATCH,
                          cache_size=LM_CACHE, attn_impl=attn_impl,
                          decode_graph=decode_graph)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k5.flash_attention.launches = 0
        t0 = time.perf_counter()
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=LM_TOKENS))
        done = eng.run()
        wall = time.perf_counter() - t0
        launches = k5.flash_attention.launches
        return eng, done, wall, launches, torch.cuda.max_memory_allocated()

    eng, done, wall, launches, peak = serve("auto")
    outputs = {r.rid: list(r.output) for r in done}
    n_tok = sum(len(o) for o in outputs.values())
    stats = eng.stats()
    for rid, n in enumerate(LM_PROMPTS):
        print(f"[lm] prompt {n:5d} tokens: prefill {eng.prefill_ms[rid]:.1f}"
              f" ms, time to first token {eng.ttft_ms[rid]:.1f} ms",
              flush=True)
    steps = sorted(eng.step_ms)
    print(f"[lm] K5 launches {launches} (expected {cfg.num_layers} x "
          f"{len(LM_PROMPTS)} prefills = {cfg.num_layers * len(LM_PROMPTS)})"
          f", in decode steps {eng.decode_launches}; {len(steps)} decode "
          f"steps, median {steps[len(steps) // 2]:.2f} ms, mean "
          f"{sum(steps) / len(steps):.2f} ms; {n_tok} tokens in {wall:.2f}"
          f" s = {n_tok / wall:.1f} tokens/s; latency p50 "
          f"{stats['p50_ms']:.0f} ms p99 {stats['p99_ms']:.0f} ms; peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    if launches != cfg.num_layers * len(LM_PROMPTS) or eng.decode_launches:
        fail(f"K5 launches {launches} (decode {eng.decode_launches}); "
             f"expected one per attention layer per prefill and none in "
             f"decode")
    # the decode step: eager once (the warm-up), captured once, replayed
    replayed = sorted(eng.step_ms[2:])
    print(f"[lm] decode step as a CUDA graph: {eng.decode_captures} "
          f"capture, {eng.decode_replays} replays; replayed steps median "
          f"{replayed[len(replayed) // 2]:.2f} ms (first, eager step "
          f"{eng.step_ms[0]:.2f} ms; the capturing step "
          f"{eng.step_ms[1]:.2f} ms)", flush=True)
    if eng.decode_captures != 1 or eng.decode_replays != len(steps) - 1:
        fail(f"decode step captured {eng.decode_captures} times and "
             f"replayed {eng.decode_replays} times in {len(steps)} steps; "
             f"expected one capture and a replay for every step after the "
             f"first")
    for rid in range(len(LM_PROMPTS)):
        out = outputs.get(rid, [])
        if len(out) != LM_TOKENS or not all(0 <= t < cfg.vocab_size
                                            for t in out):
            fail(f"request {rid}: {len(out)} tokens {out[:4]}..., expected "
                 f"{LM_TOKENS} in [0, {cfg.vocab_size})")
    first = eng.first_logits
    rec = {"prefill_ms": eng.prefill_ms, "ttft_ms": eng.ttft_ms,
           "decode_step_ms": eng.step_ms, "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "peak_bytes": peak,
           "launches": launches, "stats": stats,
           "decode_captures": eng.decode_captures,
           "decode_replays": eng.decode_replays,
           "replayed_step_median_ms": replayed[len(replayed) // 2],
           "profile": profile_lm(model, eng, prompts)}
    del eng
    torch.cuda.empty_cache()

    # the same wave with the decode step run eagerly: the same tokens
    eager, eager_done, eager_wall, _, eager_peak = serve("auto",
                                                         decode_graph=False)
    eager_out = {r.rid: list(r.output) for r in eager_done}
    esteps = sorted(eager.step_ms)
    differ = [rid for rid in outputs if outputs[rid] != eager_out.get(rid)]
    print(f"[lm] eager decode engine: {eager_wall:.2f} s for the wave, "
          f"decode step median {esteps[len(esteps) // 2]:.2f} ms against "
          f"{replayed[len(replayed) // 2]:.2f} ms replayed; "
          f"{eager.decode_captures} captures; peak memory "
          f"{eager_peak / 2**30:.2f} GiB against {peak / 2**30:.2f} GiB "
          f"with the graph; requests whose greedy tokens differ from the "
          f"captured engine's: {differ}", flush=True)
    if differ or eager.decode_captures or len(eager_out) != len(outputs):
        fail(f"eager-decode engine: tokens differ for requests {differ} "
             f"({eager.decode_captures} captures)")
    rec.update(eager_decode_step_ms=eager.step_ms, eager_wall_s=eager_wall,
               eager_peak_bytes=eager_peak)
    del eager
    torch.cuda.empty_cache()

    ref, ref_done, ref_wall, ref_launches, _ = serve("torch")
    ref_out = {r.rid: list(r.output) for r in ref_done}
    if ref_launches:
        fail(f"the torch tier launched K5 {ref_launches} times")
    worst, fros = 0.0, []
    for rid, n in enumerate(LM_PROMPTS):
        a, b = first[rid], ref.first_logits[rid]
        err = float(np.abs(a - b).max())
        tol = BF16_BAND * max(1.0, float(np.abs(b).max()))
        fro = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        agree = sum(x == y for x, y in zip(outputs[rid], ref_out[rid]))
        worst = max(worst, err / tol)
        fros.append(fro)
        print(f"[lm] prompt {n:5d}: prefill logits vs torch tier "
              f"max_abs_err={err:.3e} tol={tol:.3e} (largest "
              f"{np.abs(b).max():.3f}) fro_rel_err={fro:.3e} (limit "
              f"{LOGIT_FRO_LIMIT:.0e}); greedy tokens {agree} of "
              f"{LM_TOKENS} agree; torch-tier prefill "
              f"{ref.prefill_ms[rid]:.1f} ms", flush=True)
        if not (np.isfinite(a).all() and err <= tol
                and fro <= LOGIT_FRO_LIMIT):
            fail(f"prompt {n}: prefill logits off the torch tier by {err:.3e}"
                 f" (tolerance {tol:.3e}) or {fro:.3e} relative Frobenius "
                 f"error (limit {LOGIT_FRO_LIMIT:.0e})")
    rsteps = sorted(ref.step_ms)
    print(f"[lm] torch tier: {ref_wall:.2f} s for the wave, decode step "
          f"median {rsteps[len(rsteps) // 2]:.2f} ms", flush=True)
    rec.update(torch_tier_prefill_ms=ref.prefill_ms,
               torch_tier_wall_s=ref_wall, worst_err_over_tol=worst,
               logits_fro_rel_err=fros)
    del ref, model
    torch.cuda.empty_cache()
    return rec


def drive_lm_f32():
    """Phase 7: K5's f32 path from a user entry point.  gemma2-9b in f32 at
    full width with the depth cut to LM_F32_LAYERS (42 layers in f32 are
    37 GB of weights, and phase 6 already drives full depth): one
    6144-token lm_prefill on the cuda tier, then on the torch tier with the
    same weights.  Returns the measurements."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.models.transformer import TransformerLM, lm_prefill

    cfg = dataclasses.replace(get_config("gemma2-9b"), dtype="float32",
                              num_layers=LM_F32_LAYERS)
    model = TransformerLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    n = LM_PROMPTS[6]
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, n)[None], device="cuda")
    with torch.inference_mode():
        lm_prefill(model, toks, n)            # warm-up
        torch.cuda.synchronize()
        k5.flash_attention.launches = 0
        t0 = time.perf_counter()
        got = lm_prefill(model, toks, n)[0]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = k5.flash_attention.launches
        want = lm_prefill(model, toks, n, attn_impl="torch")[0]
    err, tol = max_err(got, want)
    print(f"[lm f32] {cfg.name} in f32, {cfg.num_layers} layers, prompt {n}:"
          f" prefill {wall:.1f} ms, K5 launches {launches} (expected "
          f"{cfg.num_layers}); logits vs torch tier max_abs_err={err:.3e} "
          f"tol={tol:.3e}", flush=True)
    if launches != cfg.num_layers:
        fail(f"f32 prefill launched K5 {launches} times, expected "
             f"{cfg.num_layers}")
    if not (bool(torch.isfinite(got).all().item()) and err <= tol):
        fail(f"f32 prefill logits off the torch tier by {err:.3e} "
             f"(tolerance {tol:.3e})")
    del model
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "prompt": n, "prefill_ms": wall,
            "launches": launches, "max_abs_err": err, "tol": tol}


def main() -> None:
    # the flex_attention yardstick compiles with inductor and Triton: keep
    # their caches inside the checkout and compile in this process
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run this script from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import CITESEER, CORA
    from repro_torch.core.plan import clear_plan_cache
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
    for name, log in logs.items():   # nvcc -Xptxas -v, per kernel
        arrives = 0
        for line in log.splitlines():
            if "(C7519)" in line:   # ptxas's own wgmma fences, counted
                arrives += 1
            elif any(w in line for w in ("Compiling entry", "registers",
                                         "spill", "smem", "arning")):
                print(f"[build] {name}: {line.strip()}", flush=True)
        if arrives:
            print(f"[build] {name}: ptxas injected warpgroup.arrive at "
                  f"{arrives} places (C7519)", flush=True)
    sass = {"fused_agg_combine": check_sass(),
            "flash_attention": check_sass("flash_attention", "tf32x3_kernel")}

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
    forwards = {}
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
            forwards[f"{name}_{'fused' if fused else 'unfused'}"] = ms
            print(f"[main] {name:4s} fused={fused!s:5s} logits "
                  f"{tuple(out.shape)} vs torch tier max_abs_err={err:.3e} "
                  f"tol={tol:.3e}; vs {'un' if fused else ''}fused "
                  f"{cross:.3e}; forward {ms:.3f} ms", flush=True)
            if err > tol or cross > ctol:
                fail(f"{name} fused={fused}: logits off the torch tier by "
                     f"{err:.3e} or off the other fusion by {cross:.3e}")
            del ref
    del logits, graphs
    torch.cuda.empty_cache()

    # -- 8. compiled execution (CUDA graphs) of the same models on Reddit
    t0 = time.perf_counter()
    compiled = drive_compiled(models, g_red, x_red, spec_red)
    print(f"[compiled] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 9. characterization: per-phase reports of the same forwards
    t0 = time.perf_counter()
    reports = characterize(models, g_red, x_red)
    print(f"[report] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    del models, g_red, x_red
    clear_plan_cache()          # drops the plans' layouts and CUDA graphs
    torch.cuda.empty_cache()

    # -- 5. K5 against its plain version
    flash = check_flash()

    # -- 6. the LM serving path: gemma2-9b through the ServeEngine
    t0 = time.perf_counter()
    lm = drive_lm()
    print(f"[lm] phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 7. K5's f32 path from the LM entry point
    lm_f32 = drive_lm_f32()
    print(f"[main] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": kind, "nvidia_smi": smi, "launches": counts,
         "peak_bytes": peak, "records": records, "flash": flash, "lm": lm,
         "lm_f32": lm_f32, "sass_tf32_hgmma": sass,
         "forwards_ms": forwards, "compiled": compiled, "reports": reports},
        indent=1))

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
            "library_ms": rec["library_ms"],
            "frac_of_bound": rec["frac_of_bound"],
            "vs_library": rec["vs_library"]})
    # K5's two paths at shape (a): bf16 (wgmma_kernel) launched by phase 6,
    # f32 (tf32x3_kernel) by phase 7
    for dtype, launches in (("bfloat16", lm["launches"]),
                            ("float32", lm_f32["launches"])):
        rec = next(r for r in flash if r["shape"] == "a" and
                   r["dtype"] == dtype)
        kernels.append({
            "name": "flash_attention_" + ("bf16" if dtype == "bfloat16"
                                          else "f32"),
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:111",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in flash
                               if r["dtype"] == dtype),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "frac_of_bound": rec["frac_of_bound"],
            "vs_library": rec["vs_library"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
