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
                K5's f32 kernel, and fewer in each bf16-W instance of K2
                than in its f32 twin (two TF32 products, not three), and
                in every instance of K5's f32 backward kernels
                (tf32x3_bwd_dq_kernel, tf32x3_bwd_dkdv_kernel); and with
                bf16 operands in every instance of K5's bf16 backward
                kernels (wgmma_bwd_dq_kernel, wgmma_bwd_dkdv_kernel).
  3. kernels -- each CUDA kernel against its plain PyTorch version on the
                card, at the shapes the main path gives it on Cora,
                Citeseer and Reddit, with the tolerance printed; times of
                kernel, plain version and (for seg_agg) torch.sparse.mm;
                every repeat launch bitwise equal to its first.  K2 is
                also held to a per-row and a relative Frobenius limit,
                which a control with one TF32 product instead of three
                must fail, and timed beside the unfused composition
                (seg_agg, then torch.matmul) and with its indices read
                from L2 instead of staged.  Then K1 in bf16 at Reddit's
                bf16 shapes and K2 with a bf16 W -- (bf16 x, bf16 W) and
                the (f32 x, bf16 W) pair of a fused dedup layer -- against
                their plain versions: the bf16 band, one bf16 ulp a row,
                repeat launches bitwise; times beside their bounds at 2
                bytes an element, torch.sparse.mm on a bf16 CSR matrix,
                and for K2 seg_agg then torch.mm(out_dtype=float32).
                Then K1's row split over long rows (LONG_ROWS: T, T + 1,
                T k, T k + 1, 7,000 and 50,000 slots) in f32 and bf16,
                weighted and not: per row against the plain version, two
                launches bitwise, rows of at most T slots bit for bit one
                in-order fold.
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
 18. lm-train -- (right after phase 7) K5's backward kernels, all on the
                tensor cores (bf16: wgmma_bwd_dq_kernel,
                wgmma_bwd_dkdv_kernel; f32: tf32x3_bwd_dq_kernel,
                tf32x3_bwd_dkdv_kernel, 3xTF32) against
                flash_attention_bwd_plain in f32 and bf16 at gemma2's
                training layers (global and local, 6144 tokens), a
                granite-3-8b layer, Sq < Sk with a ragged kv_len and a
                non-causal case: per-row and relative Frobenius limits, which
                a control without the softcap's Jacobian (without a softcap:
                without a KV tile) must fail, and in f32 so must the kernels
                with one TF32 product instead of three (f32 against the
                plain version in f64, whose f32 evaluation's own error is
                printed beside); two calls bit for bit, times of
                kernels, plain version and the library's backward
                (flex_attention's, or scaled_dot_product_attention's without
                a softcap) beside the bound.  Then gemma2-9b at full width in
                f32, 2 layers, through launch/train_lm.py's functions: step
                0's loss and every gradient leaf against the torch tier from
                the same weights, 6 make_train_step steps of 2 x 6144
                TokenPipeline tokens under Trainer (K5 forward once and its
                backward kernels twice a layer a step, counted), each step's
                loss and host and CUDA-event ms, peak memory, a profiled
                step (K5's forward and backward share, idle share), and two
                steps in bf16 for K5's bf16 backward, the second timed and
                profiled with its own peak memory.  Phase 5 also holds
                K5's row logsumexp (return_lse=True) to the plain version's
                and its out bit for bit to the launch without it.
 19. encdec -- (right after phase 18) seamless-m4t-medium, the enc-dec
                stack, at full width and depth (12 + 12 layers, D 64 MHA,
                seeded random weights) through launch/steps.py: 4
                requests of 4096 frames and 64-token prompts through
                make_prefill_step, then 16 greedy make_decode_steps (K5
                non-causal in the encoder and every cross-attention, the
                decode steps' at Sq = 1, causal in the decoder's prefill
                self-attention; launches asserted); prefill ms, decode ms
                and tokens/s (CUDA events), profiles; the prefill logits
                against the torch tier's and the decode consistency (each
                step's logits against one decode_stack), in the bf16 band
                and LOGIT_FRO_LIMIT; in f32 a prefill and a decode step in
                phase 7's band.  Then training in f32 through
                launch/train_lm.py's functions, 2 x 4096 TokenPipeline
                tokens over 4096 frames: step 0's loss and every gradient
                leaf against the torch tier, 3 Trainer steps (K5 launches
                asserted: the checkpointed layers recompute their
                forwards), a profiled step, and a timed bf16 step.  Phases
                5 and 18 hold K5 at its shapes (g)-(k); every launch of
                these segments is counted by shape at the wrapper and must
                fall on one of them.
 20. moe    -- (right after phase 19) arctic-480b (128 experts, top-2, a
                dense residual, 56 query heads over 8 KV heads at D 128)
                at full width, depth cut, seeded random weights.  K5 at
                its longest prompt's prefill shape (l), GQA group 7, as
                phase 5 holds its shapes (SDPA with enable_gqa=True as the
                library call).  In f32, one layer: lm_forward over 1024
                tokens with K5 against the torch tier, under the route
                rule (forward hooks read each MoE layer's top-k and kept
                sets; a token routed differently with no difference
                upstream of it must be a near tie, MOE_TIE_GAP; logits
                compared at the positions before the first difference).
                In bf16, two layers through the ServeEngine: 8 requests of
                64-4080 prompt tokens, 16 greedy tokens each, the decode
                step captured once and a replay bit for bit the eager
                step; prefill ms, time to first token, decode ms, tokens/s,
                peak memory; K5's launches by shape (one per layer a
                prefill, none in decode), each prefill's capacity drops;
                the first prompt's logits against the torch tier under the
                route rule; a profiled prefill and decode step.
 21. ssm    -- (right after phase 20) mamba2-2.7b (64 Mamba-2 blocks,
                attention- and FFN-free, 80 heads x 64, d_state 128, chunk
                256) at full width and depth, seeded random weights, plain
                PyTorch (the reference's SSD has no Pallas kernel).  First
                ssd_chunked against the sequential oracle ssd_reference at
                the head shape (S 1024) in f32 at the reference's limits,
                and its bf16 compute_dtype in the bf16 band.  Then 8
                requests of 1-4096 prompt tokens (shorter than the conv
                tail, within, at and past a chunk), 8 slots, 16 greedy
                tokens each, through the ServeEngine in bf16: no kernel
                launch of any wrapper, the decode step captured once and a
                replay bit for bit the eager step (logits, states, conv
                tails); each request's last decode logits against a fresh
                prefill of its tokens -- an f32 engine's within the f32
                band, the bf16 ones against that f32 yardstick beside a
                bf16 prefill's (SSM_DECODE_SLACK); prefill ms, time to
                first token, decode ms and tokens/s beside their bounds,
                peak memory, a profiled prefill and decode step.  Then
                training at full width, depth cut to 8 layers, in f32
                through launch/train_lm.py's functions (drive_lm_trainer,
                no K5 launch), and step 0's gradients of a 2-layer f32
                model against the same weights in f64.
 22. vlm    -- (right after phase 21) K5 at the VLM slice's shapes (m)-(q)
                as phase 5 holds its shapes (SDPA with enable_gqa=True as
                the library call), and its backward at (o) as phase 18
                does.  internvl2-1b (24 layers, 14 query heads over 2 KV
                heads at D 64, tied 151655-token vocabulary, seeded random
                weights) at full width and depth, bf16, image+prompt
                serving through launch/steps.py: 4 requests of
                NUM_PATCH_TOKENS stub patch embeddings and a 768-token
                prompt through make_prefill_step into a cache of 1040
                rows, then 16 greedy make_decode_steps; prefill ms, decode
                ms a step and tokens/s (CUDA events) beside their bounds,
                peak memory, K5's launches by shape (one a layer a prefill
                at (m), none in a decode step: the decode attention is the
                plain one, as the reference's), the prefill logits against
                the torch tier, and each request's last decode logits
                against a fresh vlm_forward over its patches, prompt and
                generated tokens -- an f32 model's within the f32 band x
                SCALE, the bf16 ones against that f32 yardstick beside a
                bf16 forward's (SSM_DECODE_SLACK); a profiled prefill and
                decode step; a text-only wave through launch/serve.py.
                Then training at full width and depth in f32 through
                launch/train_lm.py's functions (drive_lm_trainer): 2 x
                (256 patches + 4096 tokens) from TokenPipeline, K5's
                forward and backward at (o).  Then gemma-7b (all 28
                layers) and deepseek-67b (2 of 95 layers) at full width in
                bf16 through the ServeEngine: 4 requests of up to 2048
                prompt tokens (K5 at (p) and (q)), 16 greedy tokens each,
                the decode step captured once and a replay bit for bit the
                eager step, K5's launches by shape, the first prompt's
                logits against the torch tier, prefill and decode ms, peak
                memory.  Free device memory is checked before each model.
  8. compiled -- (run right after phase 4, on its models and graph) each of
                the six Reddit forwards through plan.compile(), one CUDA
                graph each: the capture's K1/K2 launches against the eager
                forward's, one capture and COMPILED_CALLS - 1 replays, every
                replay bitwise equal to eager, eager and replayed times over
                COMPILED_CALLS calls, peak memory with and without the
                graph, compile(layer=i) against run_layer; for gcn, sage
                and gin unfused a loss through plan.compile() under
                autograd (a forward and a backward graph, K1's backward
                over the plan's capped transposed layout): one capture over
                COMPILED_GRAD_CALLS steps, the loss and every gradient leaf
                bit for bit eager autograd's on every step, the captured
                launches eager's forward and backward ones, eager and
                compiled forward+backward ms; a torch-tier
                compile(dynamic=True) over a second seeded graph of the same
                V and E, within the f32 band, no recapture.
  9. report  -- (right after phase 8) plan.instrument().run_model(...,
                compiled=True) for the six: validated reports, written to
                chiprun_out/reports/ as JSON and markdown; ms per phase,
                its share and bound class (H100 and the paper's V100), the
                compiled speedup per layer; a PageRank row on Reddit.
 10. decisions -- (right after phase 9) the planner's other decisions for
                the six on Reddit: dtype="bf16" (K1/K2 bf16 launches,
                logits against the torch tier in bf16), "int8-agg" (f32
                kernels, the int8-agg band), reorder="degree" (natural
                order, the f32 band against the unreordered plan),
                dedup="pairs" (the reference's pair count, logits bit for
                bit the naive plan's; with bf16 and fused layers the mixed
                K2 pair), and "auto" for all three, which must resolve to
                bf16 / none / none; eager and compiled ms and peak memory
                beside phase 4's f32 forward.
 11. train   -- (right after phase 10) minibatch GraphSAGE training on
                Reddit at GraphSAGE's setting (602 -> 128 -> 41, batch
                512, fanouts 25/10, f32) through PlannedSageTrainer on
                the cuda tier, each step one replay of the bucket's
                captured step (forward, mean NLL, backward, SGD update in
                place): K1's backward (K1 over the first block's capped
                transposed layout at the bucket's capacity: the pieces,
                then the fold-back) at F=128 and F=41 against the plain
                version's autograd per row, two launches a fold, repeat
                launches bit for bit, its time beside its bound and
                torch.sparse.mm on the transposed CSR (and both on the
                device alone, CUDA-graph replays); step 0's loss and each
                gradient leaf against a torch-tier step on the same
                block, within the band of the leaf's own largest
                magnitude; 20 steps with dedup "none" and 20 with
                "pairs", each beside the eager step (loss_and_grads,
                _sgd) of a second trainer from the same state on the same
                block: one capture, no retrace, every loss and parameter
                bit for bit, K1's launches on the host only at the
                capture (and its warm-up), none at a replay, and the
                captured K1 kernels counted in a profiled replayed step;
                what "auto" resolves to; 10 captured steps, a checkpoint,
                a fresh trainer restored and 10 more, bit for bit the
                uninterrupted run; predict through compile(dynamic=True):
                one capture, every replay bit for bit the eager forward;
                the step's replay alone (CUDA events); a few steps of the
                per-block train_minibatch_sage.  Per step: host ms of
                sampling, union and padding, layouts, dedup matching and
                the feature gather, the step's wall ms, captured beside
                eager; over profiled windows of 3 captured and 3 eager
                steps the device's busy ms per step and idle share; peak
                memory.
 12. serve   -- (right after phase 11) first, in two fresh processes
                (chip_smoke.py --serve-fresh), one gcn/A engine warmed by
                its captures alone and one by warmup(), each serving the
                wave: the first request's service time and stages beside
                the median of the others; after warmup() it must be
                within WARM_LIMIT of it.  Then GCN node-prediction serving on
                Reddit through GraphServeEngine on the cuda tier: gcn,
                sage and gin (602 -> 128 -> 41, f32, unfused) under two
                traffic mixes of 50 requests (A: fanouts 5/5, 1-16 seeds,
                the reference's example; B: fanouts 25/10, 1-64 seeds,
                GraphSAGE's Reddit setting), buckets at 4/16/64 seeds, 8
                slots.  Each bucket captured once by warmup(), K1 once a
                layer in each capture as in an eager forward of its plan;
                0 retraces, 0 misses and no launch outside the graphs in
                the wave; the first 8 replays bit for bit the eager
                forward over the padded block and within the f32 band of
                the unpadded one; every request within 1e-4 of a
                torch-tier plan; one 96-seed miss (mix A) served eagerly
                through K1 and counted; workload_report() valid.  Latency
                percentiles, throughput, the host split of a request, the
                largest bucket's compiled call and its x copy-in, the
                device's busy ms and idle share over 10 profiled requests,
                peak memory.
 13. distributed -- (right after phase 12) GCN inference on a LocalMesh
                (every shard on this card): phase 4's gcn (602 -> 128 ->
                41, its params) on full-width Reddit through
                build_plan(mesh=...) -- LocalMesh((4,), ("data",)) with
                allgather, ring none / pipelined / auto and ring pipelined
                in bf16, and the 2-D plan on LocalMesh((4, 2), ("node",
                "feat")), ring none and pipelined.  Each run: the logits in
                the band of phase 4's f32 forward (bf16 3e-2), two calls
                bit for bit, none bit for bit pipelined, K1's launches the
                partition implies (layers x held shards x hops), the
                mesh's counted bytes per layer equal to
                schedule_wire_bytes (the instrumented run), CUDA-event ms
                per forward beside phase 4's (median of DIST_ROUNDS), a
                profiled window (device busy, K1 and copy ms, the copy
                time beside a kernel, idle share; traces in
                chiprun_out/traces/dist_*.json), peak memory.  K1's
                bf16-in/f32-out entry over the bf16 run's 16 ring
                sub-layouts at F = 128 and 41 against its plain version.
                Then a fresh process (chip_smoke.py --dist-nccl) inits a
                world-size-1 NCCL group from a FileStore and runs the plan
                at P = 1 through a ProcessGroupMesh: bit for bit
                LocalMesh((1,)), in the band of phase 4; each plan
                compiled (its NCCL all-gather captured), replays bit for
                bit eager; and one training step (phase 14's), gradients
                and the int8 error-feedback all-reduce bit for bit
                LocalMesh((1,))'s, then the step through plan.compile()
                under autograd (the all-reduce of the gradients captured in
                the backward graph) bit for bit the eager one.
 14. dist-train -- (right after phase 13) phase 4's gcn (602 -> 128 -> 41)
                trained on full-width Reddit through build_plan(mesh=...):
                LocalMesh((4,)) ring none, ring pipelined (its gradients
                through the int8 error-feedback all-reduce), allgather,
                ring pipelined bf16, and LocalMesh((4, 2)) ring pipelined,
                DIST_TRAIN_STEPS SGD steps each from the same params.  The
                capped transposed sub-layouts' slots, bytes, cut and
                scratch rows and build seconds beside PR 23's and what the
                uncapped ones would hold; step 0: K1's forward and
                backward launches (layers x held shards x hops; backward,
                for each held shard's P sub-layouts, the pieces and, where
                a row was cut, the fold-back), the backward's counted
                bytes against the
                forward's, the loss and each gradient leaf: f32 against
                the model's gradients in float64 on the card, apart from
                the port (GRAD_F32_LIMITS of the leaf's largest magnitude,
                a limit for each layer's leaves),
                bf16 against the torch tier's autograd of the same mesh
                plan (3e-2), each beside the torch tier's own distance from
                the f64 gradients; ring none bit for
                bit pipelined; then steps timed (forward, backward,
                update) and profiled (device busy, copy time beside a
                kernel, idle share; traces in
                chiprun_out/traces/dist_train_*.json), peak memory.  K1's
                backward over the 16 capped transposed ring sub-layouts
                at F = 128 and 41 against its plain version, beside its
                bound and torch.sparse.mm on each transposed CSR matrix,
                and the sweeps of its slice width and CTA order and of
                the cap (CAP_SWEEP).
 15. dist-compiled -- (right after phase 14, over the layouts phases 13
                and 14 built) the same plans through plan.compile(): for
                each of phase 13's forwards one capture over
                DIST_COMPILED_CALLS calls, every replay bit for bit the
                eager forward, the captured K1 launches as the partition
                implies, the collective bytes the mesh counted while
                capturing equal to schedule_wire_bytes and none moved by a
                replay, compile(layer=i) against run_layer; compiled and
                eager ms (median of DIST_ROUNDS rounds of DIST_REPS), a
                profiled window of replays (device busy, idle share;
                traces in chiprun_out/traces/dist_compiled_*.json), peak
                memory and what the graph keeps.  For each of phase 14's
                training cases DIST_TRAIN_STEPS SGD steps through the
                compiled forward and backward (int8 error feedback where
                the case has it), each step's loss and gradient leaves bit
                for bit an eager step's on the same parameters, the
                captured K1 forward and backward launches; the step's
                host-clock ms compiled and eager (turns of
                DIST_TRAIN_TIMED), device busy and idle share over
                DIST_TRAIN_PROFILED compiled steps.

 16. analysis -- (right after phase 15, on the same Reddit graph)
                repro_torch.analysis: its self-test (every rule catches
                its plant), its matrix of small plans on the card (both
                tiers), then fake-tensor traces of the full-width plans of
                the earlier phases -- phase 4's models, phase 10's
                decisions, phase 12's dynamic bucket plan over its runtime
                layout, phase 13's mesh plans -- K1 and K2 opaque nodes,
                every launch count 0 across the traces and no error
                finding (host syncs, f64, bf16 products without an f32
                accumulator, the dedup fold, the dynamic plan's constants,
                collective bytes against schedule_wire_bytes); the
                donation rule on captured compile(donate=True) plans (gcn
                unfused and fused, the f32 pipelined rings), each replay
                bit for bit the eager forward and the capture's bytes as
                scheduled; cells, errors, warnings, info, traced launches
                and the phase's seconds.
 17. paper   -- (right after phase 16, on the same Reddit graph) the
                two paper launchers' functions: repro_torch.launch.
                gcn_phase_ordering over the whole of Reddit at 602 -> 128
                (the analytic data and operation reductions of Table 4
                beside the paper's 4.75x / 4.72x, the planner's decision,
                combine-first and aggregate-first timed with CUDA events,
                their speedup beside the paper's measured 4.76x, the fused
                plan through K2 against the unfused plan in the f32 band,
                K1 and K2 launched) and repro_torch.launch.quickstart on
                its reduced Cora (the characterization, the V100 report,
                plan.compile()'s forward bit for bit the report's output,
                120 SGD steps through plan.compile() under autograd: one
                trace a signature, the loss falling).

 23. launch -- (right after phase 22) the LM launch layer.  (a) K5
                through its opaque torch ops
                (repro_torch::flash_attention and _bwd) bit for bit the
                direct launches at (a) and (o), f32 and bf16, forward and
                backward, with the op's host cost a call beside the
                direct call's.  (b) granite-3-8b at its published width
                (LAUNCH_LAYERS of 40 layers: full depth with AdamW does
                not fit 80 GB), bf16, through launch/train.py's
                build_trainer on a (1, 1) mesh over a world-size-1 NCCL
                group: LAUNCH_STEPS steps of 2 x 4096 tokens, remat
                "selective", K5's launches by shape (a forward, its
                recompute and a backward pair a layer a step), step 0's
                loss and every gradient bit for bit the plain step
                without a mesh and the mesh step with remat "none", step
                ms, idle share, peak memory.  (c) launch/dryrun.py's
                run_cell of the same step on the same mesh over fake CUDA
                tensors: state bytes exactly the real state's, peak
                within LAUNCH_PEAK_TOL of the measured, the measured
                step's model-FLOPs utilisation.  (d) python -m
                repro_torch.launch.dryrun --arch granite-3-8b --shape
                train_4k, --mesh single and --mesh multi, and
                profile_cell of the single-pod cell, three subprocesses
                started before phase 2's build and waited for right after
                it, so that their traces share the host with the build
                alone and with no measured phase: exit 0, each mesh's
                peak, FLOPs, collective bytes by kind, roofline and
                fits_80g, K5's op among the top FLOP entries.

The phases run in the order 1-4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 5-7,
18, 19, 20, 21, 22, 23, 23 (d)'s subprocesses beside 2.
The
last three lines are nvidia-smi's name and power limit, one JSON object
per kernel ({"kernels": [...]}) and the result line.  The full per-shape
table is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import atexit
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
#: K2's product with a bf16 W: two TF32 products (W's lo part is 0)
TF32X2_FLOPS = 495e12 / 2
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
#: reference test's non-causal case; seamless-m4t-medium (D 64, MHA) as
#: phase 19 gives them: (g) the encoder (non-causal) over its 4 requests'
#: 4096 frames, (h) the prefill's cross-attention (its 64-token prompts
#: over the frames), (i) the decoder's causal self-attention at the
#: training length (2 x 4096), (j) a decode step's cross-attention (Sq 1),
#: (k) the prefill's causal self-attention over the 64-token prompts;
#: arctic-480b's prefill layer at phase 20's longest prompt (GQA group 7,
#: D 128): (l), which phase 20 checks (phase 5 the others); phase 22's,
#: which it checks itself (VLM_FLASH): internvl2-1b (GQA group 7, D 64)
#: (m) its image+prompt prefill (256 patches + 768 tokens), (n) a decode
#: step's function over the 1040-row cache (held here; the decode path's
#: attention is the plain one), (o) its training layer (256 patches + 4096
#: tokens, batch 2); (p) gemma-7b's prefill at the wave's 2048-token prompt
#: (group 1, D 256), (q) deepseek-67b's (group 8, D 128).
FLASH_SHAPES = {
    "a": (1, 16, 8, 6144, 6144, 256, True, 0, 50.0, None),
    "b": (1, 16, 8, 6144, 6144, 256, True, 4096, 50.0, None),
    "c": (1, 16, 8, 17, 17, 256, True, 4096, 50.0, None),
    "d": (1, 32, 8, 4096, 4096, 128, True, 0, 0.0, None),
    "e": (2, 16, 8, 8, 300, 256, True, 0, 0.0, (50, 300)),
    "f": (1, 2, 2, 96, 96, 128, False, 0, 0.0, None),
    "g": (4, 16, 16, 4096, 4096, 64, False, 0, 0.0, None),
    "h": (4, 16, 16, 64, 4096, 64, False, 0, 0.0, None),
    "i": (2, 16, 16, 4096, 4096, 64, True, 0, 0.0, None),
    "j": (4, 16, 16, 1, 4096, 64, False, 0, 0.0, None),
    "k": (4, 16, 16, 64, 64, 64, True, 0, 0.0, None),
    "l": (1, 56, 8, 4080, 4080, 128, True, 0, 0.0, None),
    "m": (4, 14, 2, 1024, 1024, 64, True, 0, 0.0, None),
    "n": (4, 14, 2, 1, 1040, 64, True, 0, 0.0, (1025, 1030, 1035, 1040)),
    "o": (2, 14, 2, 4352, 4352, 64, True, 0, 0.0, None),
    "p": (1, 16, 16, 2048, 2048, 256, True, 0, 0.0, None),
    "q": (1, 64, 8, 2048, 2048, 128, True, 0, 0.0, None),
}
#: the shapes phase 22 holds (forward; the backward at (o)), not phase 5
VLM_FLASH = ("m", "n", "o", "p", "q")
#: phase 5: K5's row logsumexp (``return_lse=True``) against the plain
#: version's, absolute, over rows with a key (an all-masked row must read
#: -1e30 in both).  f32: the scores agree to ~1e-6 relative; bf16: the
#: kernel's row sum adds P rounded to bf16 (2^-9 relative each), so log l
#: moves by up to ~2e-3
LSE_LIMIT = {"float32": 2e-5, "bfloat16": 4e-3}
#: phase 18: K5's backward shapes, as FLASH_SHAPES: (a)/(b) gemma2-9b's
#: global and local layers at the training run's 6144 tokens, (d) a
#: granite-3-8b layer (D 128, no softcap), (e) Sq < Sk with a ragged
#: kv_len and a window, (f) the non-causal case; seamless-m4t-medium's:
#: (g) the encoder's and the cross-attention's at phase 19's training
#: batch (2 x 4096 tokens over 4096 frames), (i) the decoder's causal
#: self-attention there, and off the training path, non-causal, (h) Sq <
#: Sk and (j) Sq = 1 at the serving shapes; internvl2-1b's training layer
#: (o), GQA group 7 at D 64, which phase 22 holds
FLASH_BWD_SHAPES = {
    "a": (1, 16, 8, 6144, 6144, 256, True, 0, 50.0, None),
    "b": (1, 16, 8, 6144, 6144, 256, True, 4096, 50.0, None),
    "d": (1, 32, 8, 4096, 4096, 128, True, 0, 0.0, None),
    "e": (2, 16, 8, 100, 300, 256, True, 64, 50.0, (250, 300)),
    "f": (1, 2, 2, 96, 96, 128, False, 0, 0.0, None),
    "g": (2, 16, 16, 4096, 4096, 64, False, 0, 0.0, None),
    "h": (4, 16, 16, 64, 4096, 64, False, 0, 0.0, None),
    "i": (2, 16, 16, 4096, 4096, 64, True, 0, 0.0, None),
    "j": (4, 16, 16, 1, 4096, 64, False, 0, 0.0, None),
    "o": (2, 14, 2, 4352, 4352, 64, True, 0, 0.0, None),
}
#: phase 18: q and k are drawn with this std, so the logits (std ~9) reach
#: where the softcap of 50 bends them and its Jacobian moves dS by percents
#: -- which the bf16 limits can see; q of std 1 would move it by ~4e-4
BWD_INPUT_SCALE = 3.0
#: phase 18: K5's backward against its plain version, per dtype: each
#: row's (last dim's) largest error over that row's largest magnitude,
#: floored at BWD_ROW_FLOOR of the tensor's largest magnitude (a causal
#: first row sees one key, and its dq is 0 up to rounding), and the
#: relative Frobenius error, the largest over dq, dk and dv.  f32: two
#: passes of 3xTF32 products against the plain version evaluated in f64
#: (the inputs, out and lse as the kernels take them): its f32 evaluation
#: is itself up to 1.1e-4 a row off its f64 one at FLASH_BWD_SHAPES
#: (printed beside each f32 record), which the row limit would read as the
#: kernels' error; bf16 rounds each output
#: once, against the plain version in f32.  A control without the
#: softcap's Jacobian (or, without a softcap, without one KV tile) must
#: exceed both, and in f32 so must the kernels with one TF32 product
#: instead of three (terms=1).
BWD_ROW_LIMIT = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_FRO_LIMIT = {"float32": 1e-5, "bfloat16": 1e-2}
BWD_ROW_FLOOR = 1e-2
#: phase 18: gemma2-9b training at full width, f32, depth cut: layers,
#: batch x tokens (past the 4096 window), steps through the Trainer, and
#: the step-0 gradient limit (each leaf over its largest magnitude, as
#: phase 11's step 0)
LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 2, 6144, 6
LM_TRAIN_GRAD_LIMIT = 1e-4
#: phase 19: seamless-m4t-medium serving at full width and depth: requests
#: (each MAX_ENC_FRAMES frames), prompt tokens, greedy decode steps; then
#: training in f32: batch x tokens (frames min(seq, 4096)) and Trainer steps
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_STEPS = 4, 64, 16
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS = 2, 4096, 3
#: phase 20: arctic-480b at full width, depth cut: layers of the bf16
#: serving model and of the f32 check, the f32 check's tokens; the wave's
#: requests (prompt lengths from default_rng(SEED) in MOE_PROMPT_RANGE and
#: one of its upper end, K5's shape (l)), slots, cache and greedy tokens;
#: the free device memory the phase needs before it builds (the f32 layer
#: is 56 GB)
MOE_LAYERS, MOE_F32_LAYERS, MOE_F32_TOKENS = 2, 1, 1024
MOE_REQUESTS, MOE_MAX_BATCH, MOE_CACHE, MOE_TOKENS = 8, 8, 4096, 16
MOE_PROMPT_RANGE = (64, 4080)
MOE_MIN_FREE = 60e9
#: phase 20's route rule (``route_rule``): where K5 and the torch tier
#: pick different experts for a token with no difference upstream of it,
#: the gap between its k-th and (k+1)-th router probability must be under
#: this.  The two tiers' attention outputs
#: differ by K5's rounding: in f32 ~1e-6 relative (ROW_LIMIT), so a router
#: logit (7168 inputs of ~1, weights of std 7168^-0.5) moves by ~1e-6 and
#: a probability (<= ~0.1 for the top experts of 128) by ~1e-7: 1e-5 is
#: 100x that.  In bf16 up to one bf16 ulp (2^-8) an element, so a logit
#: moves by up to ~2e-3 and a probability by ~3e-4: 3e-3 is 10x that.
MOE_TIE_GAP = {"float32": 1e-5, "bfloat16": 3e-3}
#: phase 21: mamba2-2.7b at full width and depth serving a wave: prompt
#: lengths (a 1- and a 2-token prompt shorter than the conv tail, a
#: fraction of a chunk, one chunk, one past it (padded), padded lengths and
#: an exact multiple), slots, greedy tokens, the cache (only its length
#: limit matters: an SSM cache is a state and a conv tail); the SSD check's
#: tokens at the head shape; training at full width, depth cut: layers,
#: batch x tokens, Trainer steps; the f64 yardstick's layers
SSM_PROMPTS = (1, 2, 64, 256, 257, 1000, 2049, 4096)
SSM_MAX_BATCH, SSM_TOKENS, SSM_CACHE = 8, 16, 4200
SSM_CHECK_TOKENS = 1024
SSM_TRAIN_LAYERS, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = \
    8, 2, 4096, 3
SSM_F64_LAYERS = 2
#: phase 21: a bf16 request's last decode logits may be at most this many
#: times farther from the f32 yardstick (a prefill of the same tokens by
#: the same weights in f32) than a bf16 prefill of those tokens is.  Both
#: bf16 branches are 6-7 % off the yardstick at 64 layers of random weights
#: (so 5e-2 between them cannot hold), while the f32 branches agree to
#: 1e-5 (PERF.md §6); a fault of the decode branch moves it O(1) off
SSM_DECODE_SLACK = 1.5
#: phase 22: internvl2-1b at full width and depth: image+prompt requests
#: (each NUM_PATCH_TOKENS patch embeddings and VLM_PROMPT tokens), the cache
#: (patches + prompt + the greedy steps), greedy decode steps; training in
#: f32: batch x (patches + tokens), Trainer steps; the free device memory
#: the serving and the training models need before they are built
VLM_BATCH, VLM_PROMPT, VLM_CACHE, VLM_STEPS = 4, 768, 1040, 16
VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, VLM_TRAIN_STEPS = 2, 4352, 3
VLM_MIN_FREE, VLM_TRAIN_MIN_FREE = 20e9, 50e9
#: phase 22: the dense ServeEngine waves at full width: arch -> (layers,
#: free device memory needed first); requests (prompt lengths from
#: default_rng(SEED) in DENSE_PROMPT_RANGE and one of its upper end, K5's
#: shapes (p) and (q)), greedy tokens, the cache
DENSE_WAVES = {"gemma-7b": (28, 30e9), "deepseek-67b": (2, 15e9)}
DENSE_REQUESTS, DENSE_TOKENS, DENSE_CACHE = 4, 16, 2080
DENSE_PROMPT_RANGE = (64, 2048)
#: phase 21: the chunked scan against the sequential oracle in f32, at the
#: reference's own limits (tests/test_mamba_moe.py): |a - b| <= atol +
#: rtol |b| for every element of y and of the final state
SSD_RTOL, SSD_ATOL = 1e-4, 1e-5
#: phase 18: the shapes whose backward is also timed through a library call
#: (flex_attention compiles for each, so only the main path's global layer
#: and the no-softcap shapes, where scaled_dot_product_attention serves)
LIBRARY_BWD_SHAPES = ("a", "d", "g", "h", "i", "j", "o")
#: K5's backward kernels as the profiler names them: the substrings match
#: both the f32 tf32x3_bwd_* kernels and the bf16 wgmma_bwd_* ones, and
#: neither holds a forward kernel's name (K5_KERNELS)
K5_BWD_KERNELS = ("bwd_dq_kernel", "bwd_dkdv_kernel")
#: K5's bf16 backward kernels, whose every instance must issue bf16 HGMMAs
K5_BWD_BF16_KERNELS = ("wgmma_bwd_dq_kernel", "wgmma_bwd_dkdv_kernel")
#: K5's f32 backward kernels, whose every instance must issue TF32 HGMMAs
K5_BWD_F32_KERNELS = ("tf32x3_bwd_dq_kernel", "tf32x3_bwd_dkdv_kernel")
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
#: phase 8: steps of a loss through each unfused model's compiled forward
#: under autograd (the first captures the forward and backward graphs), also
#: the count each step's time is averaged over
COMPILED_GRAD_CALLS = 5
#: phase 3, K1 and K2 with a bf16 output, per row: the largest error over
#: that row's largest magnitude.  Kernel and plain version round an f32
#: sum once to bf16, and the two f32 sums differ by a few f32 ulps (other
#: addition orders; 3xTF32 against cuBLAS), so an element rounds to the
#: same bf16 or to its neighbour: at most one bf16 ulp, 2^-7 = 7.8e-3 of
#: the row's largest magnitude
AGG_BF16_ROW_LIMIT = 1e-2
#: the int8-agg band (tests/tolerance.py)
INT8_BAND = 2e-2
#: phase 10: the pairs dedup_layout_for_graph matches on Reddit (seed 0) and
#: the edges it removes -- the reference's count on the same graph -- and
#: what dtype / reorder / dedup "auto" resolve to there on the H100
REDDIT_DEDUP = (13647, 89344)
REDDIT_AUTO = ("bf16", "none", "none")
#: phase 10's cases: (name, build_plan decisions, fused layers only)
DECISION_CASES = (
    ("bf16", {"dtype": "bf16"}, False),
    ("int8-agg", {"dtype": "int8-agg"}, False),
    ("degree", {"reorder": "degree"}, False),
    ("pairs", {"dedup": "pairs"}, False),
    ("bf16+pairs", {"dtype": "bf16", "dedup": "pairs"}, True),
    ("auto", {"dtype": "auto", "reorder": "auto", "dedup": "auto"}, False))
#: phase 10: calls each compiled decision plan is timed over
DECISION_CALLS = 5
#: phase 11: GraphSAGE's Reddit setting (Hamilton et al., NeurIPS 2017:
#: K = 2, S1 = 25, S2 = 10, minibatch 512) at the Table-1 SAGE width
TRAIN_KW = dict(hidden=128, batch_size=512, fanouts=(25, 10), lr=0.1,
                seed=SEED)
#: phase 11: steps per training run, and the step the resume splits at
TRAIN_STEPS = 20
RESUME_AT = 10
#: phase 11: steps of each run traced by torch.profiler after its checked
#: steps, captured and eager alike
TRAIN_PROFILE = 3
#: phase 11: K1's backward against the plain version's autograd, per row
#: (K1's f32 limit): each row's largest error over that row's largest
#: magnitude
K1_BWD_ROW_LIMIT = 3e-5
#: phase 3: K1 over long rows, name -> (emax, rows of each block as {row:
#: slots}) at tile 32, sources from 3,000 rows.  T = split_threshold(emax)
#: is 256 at 7,120 slots (phase 11's transposed block 0) and 1,024 at
#: 65,536: rows of T, T + 1, T k and T k + 1 slots, a 7,000-slot hub, a
#: 50,000-slot row, an empty block and a block of short rows
#: (tests/test_torch_cuda.py LONG_ROWS)
LONG_ROWS = {
    "e7120": (7120, [{0: 256, 1: 257, 2: 512, 3: 513, 4: 5, 9: 1, 31: 40},
                     {3: 7000, 4: 50, 30: 7}, {},
                     {r: 3 for r in range(32)}]),
    "e65536": (65536, [{0: 1024, 1: 1025, 2: 3072, 3: 3073, 4: 7000,
                        5: 2}, {7: 50000, 8: 20},
                       {r: r for r in range(32)}]),
}
#: phase 17: timed calls of each ordering's plan over Reddit
PAPER_ITERS = 5
#: phase 12: the first request after warmup() in a fresh process may take
#: at most this many times the median service time of the later ones
WARM_LIMIT = 2.0
#: phase 9: PageRank power iterations timed on Reddit
PAGERANK_ITERS = 20
#: phase 12: the serving traffic mixes, name -> (fanouts, most seeds a
#: request): A the reference's own example (examples/serve_gcn.py), B
#: GraphSAGE's Reddit fanouts (Hamilton et al., NeurIPS 2017)
SERVE_MIXES = {"A": ((5, 5), 16), "B": ((25, 10), 64)}
#: phase 12: requests a wave, the first ones held against the eager
#: oracles, requests in the profiled window, seeds of the deliberate miss
SERVE_REQUESTS, SERVE_ORACLE, SERVE_PROFILE, SERVE_MISS = 50, 8, 10, 96
#: phase 12: served logits against a torch-tier plan on the same card,
#: relative to the torch tier's largest magnitude
SERVE_TOL = 1e-4
#: phase 13's runs: (label, mesh shape, strategy, overlap, dtype)
DIST_CASES = [("allgather", (4,), "allgather", "none", "f32"),
              ("ring/none", (4,), "ring", "none", "f32"),
              ("ring/pipelined", (4,), "ring", "pipelined", "f32"),
              ("ring/auto", (4,), "ring", "auto", "f32"),
              ("ring/pipelined bf16", (4,), "ring", "pipelined", "bf16"),
              ("2d ring/none", (4, 2), "ring", "none", "f32"),
              ("2d ring/pipelined", (4, 2), "ring", "pipelined", "f32")]
#: phase 13: forwards each case's time is averaged over, in each of
#: DIST_ROUNDS rounds (the median round is reported); forwards profiled
DIST_REPS = 5
DIST_ROUNDS = 3
DIST_PROFILED = 3
#: phase 13's world-size-1 NCCL process: the cases it runs at P = 1
NCCL_CASES = [("allgather", "none"), ("ring", "none"), ("ring", "pipelined")]
#: phase 14's runs: (label, mesh shape, strategy, overlap, dtype, whether
#: the gradients go through the int8 error-feedback all-reduce)
DIST_TRAIN_CASES = [
    ("ring/none", (4,), "ring", "none", "f32", False),
    ("ring/pipelined", (4,), "ring", "pipelined", "f32", True),
    ("allgather", (4,), "allgather", "none", "f32", False),
    ("ring/pipelined bf16", (4,), "ring", "pipelined", "bf16", False),
    ("2d ring/pipelined", (4, 2), "ring", "pipelined", "f32", False)]
#: phase 14: an f32 gradient leaf against the float64 yardstick
#: (``gcn_f64_grads``), over the leaf's largest magnitude, a limit for
#: each layer's leaves.  The W and bias gradients of the first layer sum
#: terms that cancel, so any f32 order lands well off the f64 sums: on the
#: H100 the plain versions' own (the torch tier of the same mesh plan)
#: read up to 1.9e-4 in 1-D and 3.3e-4 in 2-D.  The second layer's leaves
#: read 0.95e-6 to 1.14e-6 on every path, the torch tier's too; bf16, the
#: control, reads 0.24 or more on every leaf (PERF.md §6)
GRAD_F32_LIMITS = {"conv0": 1e-3, "conv1": 1e-5}
#: phase 14: SGD steps a run -- step 0 checked against the torch tier,
#: DIST_TRAIN_TIMED timed (forward, backward, update) and the last
#: DIST_TRAIN_PROFILED profiled -- and the learning rate
DIST_TRAIN_STEPS, DIST_TRAIN_TIMED, DIST_TRAIN_PROFILED = 6, 3, 2
DIST_TRAIN_LR = 0.1
#: phase 15: calls of each compiled distributed forward (the first
#: captures, the rest replay)
DIST_COMPILED_CALLS = 5


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


def replay_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Mean device milliseconds of ``fn()`` without the host: ``reps``
    calls captured in one CUDA graph, replayed ``rounds`` times between
    CUDA events (``time_ms`` times launches from the host, which bounds a
    call whose device work is shorter than its Python)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * rounds)


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
               kernel: str = "fused_kernel", operand: str = "TF32") -> dict:
    """A kernel on the tensor cores: ``cuobjdump -sass`` of the built
    library ``name`` shows HGMMA instructions with ``operand`` operands in
    every instance of ``kernel`` (TF32: K2's fused_kernel, K5's
    tf32x3_kernel, tf32x3_bwd_dq_kernel and tf32x3_bwd_dkdv_kernel; BF16:
    K5's wgmma_bwd_dq_kernel and wgmma_bwd_dkdv_kernel).  Returns
    {instance: HGMMA count}; fails if an instance has none."""
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
        elif fn in counts and "HGMMA" in line and operand in line:
            counts[fn] += 1
            example = example or " ".join(line.split("*/", 1)[-1].split())
    print(f"[build] {name} SASS: {len(counts)} instances of {kernel}, "
          f"HGMMA with {operand} operands in each: "
          f"{sorted(counts.values())}; e.g. {example}", flush=True)
    if not counts or not all(counts.values()):
        fail(f"{name}: an instance of {kernel} has no {operand} HGMMA "
             f"({counts})")
    return counts


def check_k2_pairs(counts: dict) -> dict:
    """K2's instances by (x, W) element type: a bf16 W is exact in TF32,
    so each bf16-W instance must hold fewer TF32 HGMMAs than the
    (f32, f32) instance of the same load width and wgmma width (two
    products per k8 step, not three).  ``counts`` is ``check_sass``'s
    {instance: HGMMA count}.  Returns {pair: sorted counts}."""
    import re
    # the mangled template arguments: f (float) or 13__nv_bfloat16, the
    # second written as a substitution (S1_) when it repeats the first
    pat = re.compile(r"fused_kernelI(f|13__nv_bfloat16)"
                     r"(f|13__nv_bfloat16|S\d*_)Li(\d+)ELi(\d+)E")
    short = {"f": "f32", "13__nv_bfloat16": "bf16"}
    by_pair, f32 = {}, {}
    for fn, n in counts.items():
        m = pat.search(fn)
        if not m:
            fail(f"fused_agg_combine: cannot read the instance {fn}")
        tx = short[m.group(1)]
        tw = tx if m.group(2).startswith("S") else short[m.group(2)]
        pair = f"{tx}/{tw}"
        by_pair.setdefault(pair, []).append((int(m.group(3)),
                                             int(m.group(4)), n))
        if pair == "f32/f32":
            f32[(int(m.group(3)), int(m.group(4)))] = n
    out = {p: sorted(n for _, _, n in v) for p, v in by_pair.items()}
    print("[build] fused_agg_combine TF32 HGMMAs per instance by (x, W): "
          + "; ".join(f"{p}: {v}" for p, v in sorted(out.items())),
          flush=True)
    if sorted(out) != ["bf16/bf16", "f32/bf16", "f32/f32"]:
        fail(f"fused_agg_combine: instances {sorted(out)}, expected the "
             f"three (x, W) pairs")
    for pair in ("bf16/bf16", "f32/bf16"):
        for vec, nt, n in by_pair[pair]:
            if not 0 < n < f32.get((vec, nt), 0):
                fail(f"fused_agg_combine {pair} VEC={vec} NT={nt}: {n} TF32 "
                     f"HGMMAs against {f32.get((vec, nt))} with an f32 W")
    return out


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


def check_kernels_bf16(g, spec):
    """Phase 3 in bf16: K1 at Reddit's bf16 shapes (gcn/sage aggregate at
    128 and 41, gin at 602 and 128) over the plans' unfused layout, K2
    with bf16 x and W at the fused layers' shapes (602 -> 128, 128 -> 41,
    128 -> 128) over a bf16 plan's own layouts, and the (f32 x, bf16 W)
    pair at 602 -> 128 over a bf16 dedup plan's level-2 layout, from the
    V + P rows of [x ; partials].  Fails unless each is within the bf16
    band and AGG_BF16_ROW_LIMIT a row of its plain version and a second
    launch equals the first bit for bit.  Returns one record per shape."""
    import torch
    from repro_torch.kernels import fused_agg_combine as k2
    from repro_torch.kernels import seg_agg as k1
    from repro_torch.models.gcn import make_paper_model

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    plans = {name: make_paper_model(name, spec, device="cuda",
                                    fused=True).plan_for(g, dtype="bf16")
             for name in ("gcn", "gin")}
    ded = make_paper_model("gcn", spec, device="cuda", fused=True).plan_for(
        g, dtype="bf16", dedup="pairs").dedup_layout
    agg_bg = plans["gcn"].layers[0].agg_layout
    v, nnz = g.num_vertices, g.num_edges
    adj = torch.sparse_csr_tensor(g.row_ptr, g.src,
                                  torch.ones(nnz, device="cuda", dtype=bf16),
                                  size=(v, v))
    todo = [("seg_agg_bf16", "bf16", 128, 128, agg_bg, v, nnz),
            ("seg_agg_bf16", "bf16", 41, 41, agg_bg, v, nnz),
            ("seg_agg_bf16", "bf16", 602, 602, agg_bg, v, nnz),
            ("fused_agg_combine_bf16", "bf16", 602, 128,
             plans["gcn"].layers[0].blocked, v, nnz),
            ("fused_agg_combine_bf16", "bf16", 128, 41,
             plans["gcn"].layers[1].blocked, v, nnz),
            ("fused_agg_combine_bf16", "bf16", 128, 128,
             plans["gin"].layers[1].blocked, v, nnz),
            ("fused_agg_combine_bf16", "mixed", 602, 128, ded.blocked,
             v + ded.num_pairs, ded.num_edges2)]
    records = []
    for kname, pair, f_in, f_out, bg, rows, slots in todo:
        x = torch.randn((rows, f_in), generator=gen, device="cuda")
        if pair == "bf16":
            x = x.to(bf16)
        note = None
        if kname == "seg_agg_bf16":
            args = (x, bg.src, bg.dstl, bg.mask, None)
            kern = lambda: k1.seg_agg(*args, tile_m=bg.tile_m)  # noqa
            plain = lambda: k1.seg_agg_plain(*args, tile_m=bg.tile_m)  # noqa
            nbytes = (x.numel() + bg.nblocks * bg.tile_m * f_out) * 2 \
                + 3 * bg.src.numel() * 4
            b_ms, b_by = bound(nbytes, slots * f_in)
        else:
            w = (torch.randn((f_in, f_out), generator=gen, device="cuda")
                 * (2.0 / f_in) ** 0.5).to(bf16)
            args = (x, bg.src, bg.dstl, bg.mask, w)
            kern = lambda: k2.fused_agg_combine(  # noqa: E731
                *args, tile_m=bg.tile_m)
            plain = lambda: k2.fused_agg_combine_plain(  # noqa: E731
                *args, tile_m=bg.tile_m)
            nbytes = x.numel() * x.element_size() + (
                w.numel() + bg.nblocks * bg.tile_m * f_out) * 2 \
                + 3 * bg.src.numel() * 4
            prod = 2 * v * f_in * f_out
            b_ms, b_by = bound(nbytes, slots * f_in
                               + prod * F32_FLOPS / TF32X2_FLOPS)
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        tol = BF16_BAND * max(1.0, out_p.float().abs().max().item())
        row, fro = rel_errs(out_k, out_p)
        ok = bool(torch.isfinite(out_k).all().item()) and err <= tol \
            and row <= AGG_BF16_ROW_LIMIT and out_k.dtype == bf16
        same = torch.equal(out_k, kern())
        del out_k
        lib_ms = unfused_ms = None
        if kname == "seg_agg_bf16":
            try:      # a yardstick only: nothing in the port calls it
                lerr = (torch.sparse.mm(adj, x).float()
                        - out_p[:v].float()).abs().max().item()
                if lerr <= tol:
                    lib_ms = time_ms(lambda: torch.sparse.mm(adj, x), 10)
                    note = f"torch.sparse.mm, bf16 CSR, max_abs_err {lerr:.3e}"
                else:
                    note = f"none: torch.sparse.mm differs by {lerr:.3e}"
            except RuntimeError as e:
                note = f"none: torch.sparse.mm on a bf16 CSR matrix raised " \
                    f"{str(e).splitlines()[0][:120]}"
        else:
            note = "none: no single call"
            if pair == "bf16":
                # the unfused composition: seg_agg in bf16, then the product
                # with an f32 accumulator
                unfused_ms = time_ms(lambda: torch.mm(k1.seg_agg(
                    x, agg_bg.src, agg_bg.dstl, agg_bg.mask, None,
                    tile_m=agg_bg.tile_m)[:v], w, out_dtype=torch.float32),
                    10)
        del out_p
        rec = {"name": kname, "pair": pair, "graph": "reddit", "f_in": f_in,
               "f_out": f_out, "tile_m": bg.tile_m, "nblocks": bg.nblocks,
               "emax": bg.emax, "rows": rows, "slots": slots,
               "max_abs_err": err, "tol": tol, "row_rel_err": row,
               "fro_rel_err": fro, "repeat_equal": same,
               "ms": time_ms(kern, 10), "plain_ms": time_ms(plain, 2),
               "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, "library": note,
               "unfused_ms": unfused_ms}
        rec.update(ratios(rec))
        records.append(rec)
        print(f"[kernels] {kname:22s} {pair:5s} reddit {f_in:4d}->"
              f"{f_out:<4d} tile_m={bg.tile_m} layout={bg.nblocks}x{bg.emax} "
              f"rows={rows} max_abs_err={err:.3e} tol={tol:.3e} row_rel_err="
              f"{row:.3e} (limit {AGG_BF16_ROW_LIMIT:.0e}) fro_rel_err="
              f"{fro:.3e} repeat_equal={same} ms={rec['ms']:.4f} plain_ms="
              f"{rec['plain_ms']:.4f} library_ms={lib_ms} [{note}]"
              + (f" seg_agg+torch.mm(out_dtype=f32)_ms={unfused_ms:.4f}"
                 if unfused_ms is not None else "")
              + f" bound_ms={b_ms:.4f} ({b_by}; {nbytes} B) frac_of_bound="
              f"{rec['frac_of_bound']:.4f}", flush=True)
        if not ok:
            fail(f"{kname} {pair} {f_in}->{f_out}: kernel and plain version "
                 f"differ by {err:.3e} (tolerance {tol:.3e}) or a row by "
                 f"{row:.3e} (limit {AGG_BF16_ROW_LIMIT:.0e})")
        if not same:
            fail(f"{kname} {pair} {f_in}->{f_out}: two launches on the same "
                 f"input differ")
        del x
    return records


def long_row_layout(name: str, v: int = 3000, tile_m: int = 32):
    """``LONG_ROWS[name]`` as a blocked layout on the card (sources drawn
    from ``v`` rows, seeded), and each row's length."""
    import numpy as np
    from repro_torch.core.dataflow import block_graph_arrays
    emax, blocks = LONG_ROWS[name]
    lengths = np.zeros(len(blocks) * tile_m, np.int64)
    for b, rows in enumerate(blocks):
        for r, n in rows.items():
            lengths[b * tile_m + r] = n
    dst = np.repeat(np.arange(len(lengths)), lengths)
    src = np.random.default_rng(SEED).integers(0, v, len(dst))
    return block_graph_arrays(src, dst, len(lengths), tile_m, device="cuda",
                              emax=emax), lengths


def in_order_fold(x, bg, w):
    """Each row of ``bg`` as one f32 fold in slot order from 0, on the
    host (numpy): what K1 must give a row of at most T slots, bit for
    bit."""
    import numpy as np
    import torch
    xs = x.float().cpu().numpy()
    src, dstl = bg.src.cpu().numpy(), bg.dstl.cpu().numpy()
    mask = bg.mask.cpu().numpy()
    coef = mask if w is None else mask * w.cpu().numpy()
    out = np.zeros((bg.nblocks * bg.tile_m, xs.shape[1]), np.float32)
    for b, e in zip(*np.nonzero(mask)):
        r = b * bg.tile_m + dstl[b, e]
        out[r] = out[r] + coef[b, e] * xs[src[b, e]]
    return torch.from_numpy(out)


def check_k1_long_rows() -> list:
    """Phase 3, K1's row split: over LONG_ROWS in f32 and bf16, weighted
    and not, at F = 128: each row within K1's per-row limit of the plain
    version (f32 3e-5, bf16 AGG_BF16_ROW_LIMIT), two launches bit for bit,
    every row of at most T slots bit for bit one in-order fold; the
    kernel's time.  Returns one record per case."""
    import torch
    from repro_torch.kernels import seg_agg as k1
    out = []
    for name in LONG_ROWS:
        bg, lengths = long_row_layout(name)
        t = k1.split_threshold(bg.emax)
        short = torch.from_numpy(lengths <= t)
        for dtype in (torch.float32, torch.bfloat16):
            for weighted in (False, True):
                gen = torch.Generator(device="cuda").manual_seed(SEED)
                x = torch.randn((3000, 128), generator=gen,
                                device="cuda").to(dtype)
                w = torch.rand(bg.src.shape, generator=gen, device="cuda") \
                    if weighted else None
                args = (x, bg.src, bg.dstl, bg.mask, w)
                got = k1.seg_agg(*args, tile_m=bg.tile_m)
                same = torch.equal(got, k1.seg_agg(*args, tile_m=bg.tile_m))
                want = k1.seg_agg_plain(*args, tile_m=bg.tile_m)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs().amax(-1)
                mag = want.float().abs().amax(-1)
                row = float((diff / torch.clamp(mag, min=1e-30)).max())
                limit = K1_BWD_ROW_LIMIT if dtype == torch.float32 \
                    else AGG_BF16_ROW_LIMIT
                exact = torch.equal(got.cpu()[short], in_order_fold(
                    x, bg, w).to(dtype)[short])
                rec = {"name": "seg_agg_long_rows", "layout": name,
                       "dtype": str(dtype).split(".")[-1],
                       "weighted": weighted, "emax": bg.emax,
                       "split_threshold": t,
                       "split_rows": int((lengths > t).sum()),
                       "longest_row": int(lengths.max()),
                       "max_abs_err": float(diff.max()),
                       "row_rel_err": row,
                       "ms": time_ms(lambda: k1.seg_agg(  # noqa: E731
                           *args, tile_m=bg.tile_m), 10)}
                out.append(rec)
                print(f"[kernels] seg_agg long rows {name} "
                      f"{rec['dtype']} weighted={weighted}: T = {t}, "
                      f"{rec['split_rows']} split rows (longest "
                      f"{rec['longest_row']} slots); row_rel_err={row:.3e} "
                      f"(limit {limit:.0e}); rows <= T bit for bit one "
                      f"in-order fold: {exact}; two launches equal: {same}; "
                      f"ms={rec['ms']:.4f}", flush=True)
                if row > limit or not same or not exact:
                    fail(f"seg_agg long rows {name} {dtype} weighted="
                         f"{weighted}: row error {row:.3e}, launches equal "
                         f"{same}, short rows in order {exact}")
    return out


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


def nll(logits, y):
    """The mean NLL of the labels ``y`` (``GCNModel.loss_fn``'s)."""
    import torch
    return -torch.log_softmax(logits, dim=-1).gather(
        -1, y.long()[:, None])[:, 0].mean()


def drive_compiled_grad(m, g, x, y, key: str) -> dict:
    """Phase 8's gradient: a loss through plan.compile() of an unfused
    model under autograd (a forward and a backward CUDA graph).  Fails
    unless the grad signature is captured once and replayed on every later
    call of COMPILED_GRAD_CALLS, the loss and every gradient leaf equal
    eager autograd's bit for bit on every call, and the graphs record the
    eager forward's and backward's K1 launches (the backward's over the
    plan's capped transposed layout, built on the host by the eager step
    first).  Returns the measurements."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    plan, params = m.plan_for(g), list(m.parameters())
    fn = plan.compile()
    t0 = time.perf_counter()
    plan.with_transposed(plan.layers[0].agg_layout)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c0 = launch_counts()
    loss = nll(plan.run_model(m.tree(), x), y)
    c1 = launch_counts()
    want = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    c2 = launch_counts()
    eager_peak = torch.cuda.max_memory_allocated() - base
    eager = {k: c2[k] - c0[k] for k in c0}
    eager_bwd = {k: c2[k] - c1[k] for k in c0}
    before = dict(fn.capture_launches)
    traces0, replays0 = fn.num_traces, fn.num_replays
    torch.cuda.reset_peak_memory_stats()
    same = []
    for i in range(COMPILED_GRAD_CALLS):
        if i == 1:
            c3 = launch_counts()
        got_loss = nll(fn(m.tree(), x), y)
        got = torch.autograd.grad(got_loss, params)
        same.append(bool(torch.equal(got_loss, loss)) and all(
            torch.equal(a, b) for a, b in zip(got, want)))
    torch.cuda.synchronize()
    moved = {k: n - c3[k] for k, n in launch_counts().items() if n != c3[k]}
    compiled_peak = torch.cuda.max_memory_allocated() - base
    captured = {k: fn.capture_launches.get(k, 0) - before.get(k, 0)
                for k in eager}
    traces, replays = fn.num_traces - traces0, fn.num_replays - replays0

    def eager_step():
        torch.autograd.grad(nll(plan.run_model(m.tree(), x), y), params)

    def compiled_step():
        torch.autograd.grad(nll(fn(m.tree(), x), y), params)

    ms = time_ms(eager_step, COMPILED_GRAD_CALLS)
    ms_graph = time_ms(compiled_step, COMPILED_GRAD_CALLS)
    rec = {"eager_ms": ms, "graph_ms": ms_graph, "num_traces": traces,
           "num_replays": replays, "eager_launches": eager,
           "eager_backward_launches": eager_bwd,
           "capture_launches": captured, "replays_equal": all(same),
           "transposed_build_s": build_s, "eager_peak_bytes": eager_peak,
           "compiled_peak_bytes": compiled_peak}
    print(f"[compiled] {key:14s} grad: forward+backward eager {ms:.3f} ms, "
          f"compiled {ms_graph:.3f} ms ({ms / ms_graph:.2f}x) over "
          f"{COMPILED_GRAD_CALLS} steps; captures {traces}, replays "
          f"{replays}; K1 launches eager forward "
          f"{eager['seg_agg'] - eager['seg_agg_bwd']} + backward "
          f"{eager_bwd['seg_agg_bwd']}, captured "
          f"{captured['seg_agg']} ({captured['seg_agg_bwd']} backward); "
          f"every call's loss and gradients equal to eager bit for bit: "
          f"{same}; the capped transposed layout built in {build_s:.1f} s; "
          f"peak above the inputs eager {eager_peak / 2**30:.3f} GiB, "
          f"compiled {compiled_peak / 2**30:.3f} GiB", flush=True)
    if not all(same) or (traces, replays) != (1, COMPILED_GRAD_CALLS - 1):
        fail(f"{key} grad: bitwise {same}, {traces} captures, {replays} "
             f"replays")
    if captured != eager or moved:
        fail(f"{key} grad: captured launches {captured} against eager "
             f"forward and backward {eager}; replays moved {moved}")
    return rec


def drive_compiled(models, g, x, y, spec):
    """Phase 8: the six Reddit models through plan.compile() (one CUDA
    graph each).  Fails unless a capture records the eager forward's K1/K2
    launches, the forward is captured once over COMPILED_CALLS calls with a
    replay for every call after the first, every replay's logits equal the
    eager forward's bit for bit, each layer's compile(layer=i) equals
    run_layer, the unfused models' losses through it are differentiable
    (``drive_compiled_grad``), and a torch-tier dynamic plan serves a
    second graph of the same V and E within the f32 band with no recapture
    (another shape raises).  Returns the measurements."""
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
        if not fused:
            out[key + "_grad"] = drive_compiled_grad(m, g, x, y, key)

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
        # phase 8's captures: the forward, and an unfused model's grad
        traces0 = plan.compile().num_traces
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
        if plan.compile().num_traces != traces0:
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


def drive_decisions(models, g, x, forwards):
    """Phase 10: the planner's other decisions for the six Reddit models,
    through plan_for(g, ...) on the cuda tier, each with the launch counts
    zeroed just before its forward and read just after (DECISION_CASES).
    Fails unless every case launches its kernels (the bf16 instances for a
    bf16 plan, the mixed K2 pair for a fused bf16 dedup plan, the f32 ones
    otherwise), its logits are finite and within its band of the torch
    tier's (bf16, int8-agg) or of the naive plan's (degree: f32 band;
    pairs: bit for bit), the dedup layout has the reference's pairs,
    "auto" resolves to REDDIT_AUTO and gives the bf16 plan's logits bit
    for bit, and its compiled forward equals its eager one bit for bit.
    Returns the measurements and the launches of each kernel."""
    import torch
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    out, launches = {}, {}
    for (name, fused), m in models.items():
        key = f"{name}_{'fused' if fused else 'unfused'}"
        kern = "fused_agg_combine" if fused else "seg_agg"
        params = m.tree()
        with torch.inference_mode():
            naive = m.plan_for(g).run_model(params, x)
        results = {}
        for case, kw, fused_only in DECISION_CASES:
            if fused_only and not fused:
                continue
            t0 = time.perf_counter()
            plan = m.plan_for(g, **kw)
            build_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            with torch.inference_mode():
                got = plan.run_model(params, x)
            torch.cuda.synchronize()
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated() - base
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            bf16 = plan.dtype == "bf16"
            want_counts = {kern: 2, kern + "_bf16": 2 if bf16 and (
                fused or plan.dedup == "none") else 0}
            if fused and bf16 and plan.dedup == "pairs":
                want_counts["fused_agg_combine_mixed"] = 2
            note = ""
            with torch.inference_mode():
                if plan.dtype in ("bf16", "int8-agg") and case != "auto":
                    ref = m(g, x, plan=m.plan_for(g, backend="torch", **kw))
                    band = BF16_BAND if bf16 else INT8_BAND
                    err = (got.float() - ref.float()).abs().max().item()
                    tol = band * max(1.0, ref.float().abs().max().item())
                    note = f"vs torch tier {plan.dtype}"
                    del ref
                elif case == "degree":
                    err, tol = max_err(got, naive)
                    note = "natural order vs unreordered cuda plan"
                elif case == "pairs":
                    err, tol = (0.0 if torch.equal(got, naive) else
                                float("inf")), 0.0
                    note = "bitwise vs naive cuda plan"
                else:                                  # auto
                    err, tol = (0.0 if torch.equal(got, results["bf16"][
                        "logits"]) else float("inf")), 0.0
                    note = "bitwise vs the bf16 plan"
            ok = (tuple(got.shape) == tuple(naive.shape)
                  and bool(torch.isfinite(got.float()).all().item())
                  and err <= tol
                  and all(counts[k] == n for k, n in want_counts.items()))
            pairs = None
            if plan.dedup == "pairs":
                lay = plan.dedup_layout
                pairs = (lay.num_pairs, lay.edges_removed)
            fn = plan.compile()
            with torch.inference_mode():
                ms = time_ms(lambda: plan.run_model(params, x), 3)
                replays_equal = all(torch.equal(fn(params, x), got)
                                    for _ in range(2))
                graph_ms = time_ms(lambda: fn(params, x), DECISION_CALLS)
            traces = fn.num_traces
            plan._compiled.clear()
            del fn
            resolved = (plan.dtype, plan.reorder, plan.dedup)
            results[case] = {
                "resolved": resolved, "build_s": build_s, "eager_ms": ms,
                "graph_ms": graph_ms, "peak_bytes": peak,
                "launches": counts, "max_abs_err": err, "tol": tol,
                "pairs": pairs, "replays_equal": replays_equal,
                "logits": got if case == "bf16" else None}
            print(f"[decisions] {name:4s} fused={fused!s:5s} {case:10s} -> "
                  f"dtype={resolved[0]} reorder={resolved[1]} dedup="
                  f"{resolved[2]}"
                  + (f" (pairs {pairs[0]}, edges removed {pairs[1]})"
                     if pairs else "")
                  + f"; launches {counts}; {note} max_abs_err={err:.3e} "
                  f"tol={tol:.3e}; eager {ms:.3f} ms, compiled {graph_ms:.3f}"
                  f" ms (replays equal eager: {replays_equal}), f32 forward "
                  f"{forwards[key]:.3f} ms; peak above the inputs "
                  f"{peak / 2**30:.3f} GiB; planned in {build_s:.1f} s",
                  flush=True)
            if not ok:
                fail(f"{key} {case}: launches {counts} (expected "
                     f"{want_counts}), logits off by {err:.3e} (tolerance "
                     f"{tol:.3e}) or not finite")
            if not replays_equal or traces != 1:
                fail(f"{key} {case}: the compiled forward differs from eager "
                     f"({traces} captures)")
            if pairs is not None and pairs != REDDIT_DEDUP:
                fail(f"{key} {case}: {pairs[0]} pairs and {pairs[1]} edges "
                     f"removed; the reference matches {REDDIT_DEDUP[0]} and "
                     f"removes {REDDIT_DEDUP[1]} on this graph")
            if case == "auto" and resolved != REDDIT_AUTO:
                fail(f"{key}: auto resolved to {resolved}, the reference "
                     f"resolves {REDDIT_AUTO}")
            del got
        del naive
        for r in results.values():
            r.pop("logits")
        out[key] = results
        torch.cuda.empty_cache()
    return out, launches


def check_k1_backward(tr, prep, f: int):
    """Phase 11 (1): K1's backward at width ``f`` as the captured step
    runs it -- K1 over the first block's capped transposed layout at the
    bucket's capacity (the pieces, then the fold-back, empty or not),
    through its autograd Function -- against the plain version's autograd
    on the same card, per row; two launches a gradient, repeat launches
    bit for bit; time of the fold, of the plain version's and of
    torch.sparse.mm on the transposed CSR, and the bound.  Returns the
    record."""
    import numpy as np
    import torch
    from repro_torch.kernels import seg_agg as k1

    _, _, bg, _ = tr._inputs(prep)
    t, fb = bg.transposed, bg.transposed.fold
    dev = tr.device
    rows = tr.bucket.num_inputs
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((rows, f), generator=gen, device=dev)
    gout = torch.randn((bg.nblocks * bg.tile_m, f), generator=gen,
                       device=dev)

    def grad(fn):
        xx = x.clone().requires_grad_()
        out = fn(xx, bg.src, bg.dstl, bg.mask, None, tile_m=bg.tile_m)
        return torch.autograd.grad(out, [xx], gout)[0]

    kernel = lambda: grad(lambda *a, **kw: k1.seg_agg(  # noqa: E731
        *a, transposed=t, **kw))
    before = k1.seg_agg.launches_bwd
    got, again = kernel(), kernel()
    launched = k1.seg_agg.launches_bwd - before
    want = grad(k1.seg_agg_plain)
    torch.cuda.synchronize()
    diff = (got - want).abs().amax(-1)
    mag = want.abs().amax(-1)
    row = float((diff / torch.clamp(mag, min=1e-30)).max().item())
    err = float(diff.max().item())
    if launched != 4:
        fail(f"K1 backward launched {launched} times for two gradients "
             f"(the pieces and the fold-back each)")
    if not torch.equal(got, again):
        fail("K1 backward: two launches on the same input differ")
    if not bool((diff <= K1_BWD_ROW_LIMIT * mag).all().item()):
        fail(f"K1 backward: a row off the plain version's autograd by "
             f"{row:.3e} of its scale (limit {K1_BWD_ROW_LIMIT:.0e})")
    fold = lambda: k1.fold_transposed(gout, t)  # noqa: E731
    plain = lambda: k1.fold_transposed(gout, t, plain=True)  # noqa: E731
    e = prep["edges"]
    src, dst = prep["src"][:e].astype(np.int64), prep["dst"][:e]
    order = np.argsort(src, kind="stable")
    crow = np.zeros(rows + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=rows), out=crow[1:])
    adj_t = torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(dev),
        torch.from_numpy(dst[order].astype(np.int64)).to(dev),
        torch.ones(e, device=dev), size=(rows, gout.shape[0]))
    library = lambda: torch.sparse.mm(adj_t, gout)  # noqa: E731
    lib_err = (library()[:rows] - want).abs().max().item()
    # the function's bytes: the gout rows its edges read, the x rows it
    # writes, and src, dstl and mask of its e edges; the capacity's pad
    # slots and the fold-back are the kernel's cost, not the function's
    gathered = len(np.unique(dst))
    nbytes = (gathered * f + rows * f + 3 * e) * 4
    pad_bytes = 3 * (t.src.numel() + fb.src.numel() - e) * 4
    ops = e * f
    b_ms, b_by = bound(nbytes, ops)
    cut = int((fb.out_rows >= 0).sum().item())
    scratch_used = int((fb.mask != 0).sum().item())
    rec = {"name": "seg_agg_bwd", "graph": "reddit-train-block0",
           "f_in": f, "f_out": f, "tile_m": t.tile_m, "nblocks": t.nblocks,
           "emax": t.emax, "forward_emax": bg.emax, "edges": e,
           "fold_nblocks": fb.nblocks, "fold_emax": fb.emax,
           "scratch_rows": fb.num_vertices, "cut_rows": cut,
           "scratch_rows_used": scratch_used,
           "max_abs_err": err, "row_rel_err": row,
           "library_max_abs_err": lib_err,
           "ms": time_ms(fold, 10), "plain_ms": time_ms(plain, 2),
           "library_ms": time_ms(library, 10),
           "device_ms": replay_ms(fold), "library_device_ms":
           replay_ms(library), "slice_cols": k1.packed_launch(
               f, 4, k1.alignment(gout))[0],
           "split_threshold": k1.packed_split(t.emax, t.tile_m),
           "bytes": nbytes, "ops": ops,
           "pad_slot_bytes": pad_bytes, "bound_ms": b_ms, "bound_by": b_by}
    rec.update(ratios(rec))
    print(f"[train] K1 backward block 0 F={f}: capped transposed layout at "
          f"the bucket's capacity {t.nblocks}x{t.emax} + fold-back "
          f"{fb.nblocks}x{fb.emax} over {fb.num_vertices} scratch rows "
          f"({cut} rows cut into {scratch_used} pieces; forward "
          f"{bg.nblocks}x{bg.emax}), {e} edges; max_abs_err={err:.3e} "
          f"row_rel_err={row:.3e} (limit {K1_BWD_ROW_LIMIT:.0e}); "
          f"ms={rec['ms']:.4f} (two packed launches, "
          f"{rec['slice_cols']}-column slices, split threshold "
          f"{rec['split_threshold']}) plain_ms={rec['plain_ms']:.4f} "
          f"library_ms={rec['library_ms']:.4f} (torch.sparse.mm, transposed "
          f"CSR; max_abs_err {lib_err:.3e}) bound_ms={b_ms:.4f} ({b_by}; "
          f"{nbytes} B, {ops} ops; the capacity's pad slots {pad_bytes} B "
          f"more) frac_of_bound={rec['frac_of_bound']:.4f} vs_library="
          f"{rec['vs_library']:.3f}; device time (CUDA-graph replays, no "
          f"host) {rec['device_ms']:.4f} against torch.sparse.mm's "
          f"{rec['library_device_ms']:.4f}", flush=True)
    del adj_t, gout, x, got, again, want
    return rec


def kernel_window(name: str, prof, wall_ms: float, n: int) -> dict:
    """Per unit (a step or a request) over a profiled window of ``n``
    units that took ``wall_ms`` on the host clock: wall ms, the device's
    busy ms (kernels of the trace), K1's share of it, kernels, and the
    device's idle share (None when the trace holds no kernel).  The trace
    goes to chiprun_out/traces/<name>.json."""
    out_dir = ROOT / "chiprun_out" / "traces"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    kern = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(e["dur"] for e in kern) / 1e3
    k1 = [e for e in kern if "fold_kernel" in e.get("name", "")
          or "row_starts_kernel" in e.get("name", "")]
    return {"n": n, "wall_ms": wall_ms / n, "device_busy_ms": busy / n,
            "k1_ms": sum(e["dur"] for e in k1) / 1e3 / n,
            "k1_kernels": len(k1) / n, "kernels": len(kern) / n,
            "idle_share": 1 - busy / wall_ms if kern else None}


def eager_step(tr) -> tuple:
    """The eager step of trainer ``tr`` on its pipeline's next block
    (``loss_and_grads`` and ``_sgd``, what a captured step is held to),
    timed as ``PlannedSageTrainer.step`` times its stages.  Returns (loss,
    host ms per stage)."""
    import torch
    from repro_torch.models.sage_minibatch import _sgd
    t0 = time.perf_counter()
    batch = tr.pipeline.batch_at(tr.pipeline.step)
    tr.pipeline.step += 1
    t1 = time.perf_counter()
    prep = tr._prepare(batch)
    t2 = time.perf_counter()
    loss, grads = tr.loss_and_grads(prep)
    _sgd(list(tr.model.parameters()), grads, tr.lr)
    value = loss.item()
    torch.cuda.synchronize()
    tr.losses.append(value)
    return value, dict(tr.stage_ms, sample=(t1 - t0) * 1e3,
                       union=(t2 - t1) * 1e3,
                       step=(time.perf_counter() - t0) * 1e3)


def same_state(tr, ref) -> bool:
    """Every parameter of two trainers equal bit for bit."""
    import torch
    return all(torch.equal(p, q) for p, q in zip(tr.model.parameters(),
                                                ref.model.parameters()))


def profiled(name: str, n: int, fn) -> dict:
    """``fn()`` ``n`` times under torch.profiler: ``kernel_window``'s
    per-call numbers (trace in chiprun_out/traces/<name>.json)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return kernel_window(name, prof, wall, n)


def train_run(tr, ref, steps: int, capture: dict, label: str) -> dict:
    """``steps`` steps of trainer ``tr`` through its captured step, each
    beside the eager step of ``ref`` from the same state on the same
    block: the loss and every parameter after it bit for bit.  Step 0
    captures (K1's launches then: the warm-up's and the capture's, twice
    ``capture``); no counter moves at a replay.  Then TRAIN_PROFILE more
    steps of each profiled: the device's busy ms, K1 kernels and idle
    share a step, captured beside eager.  Host ms per stage and step wall
    ms of both.  Returns the measurements."""
    import torch
    from repro_torch.kernels.ops import launch_counts

    def check(i, loss, want):
        if loss != want or not same_state(tr, ref):
            fail(f"{label} step {i}: the captured step's loss {loss!r} or "
                 f"parameters differ from the eager step's ({want!r})")
        if not (loss == loss and abs(loss) < float("inf")):
            fail(f"{label} step {i}: loss {loss} is not finite")

    stages, eager, launched = [], [], dict.fromkeys(capture, 0)
    for i in range(steps):
        before = launch_counts()
        loss = tr.step()
        got = {k: launch_counts()[k] - before[k] for k in capture}
        launched = {k: n + got[k] for k, n in launched.items()}
        want = {k: 2 * n for k, n in capture.items()} if i == 0 \
            else {k: 0 for k in capture}
        if got != want:
            fail(f"{label} step {i}: K1 launches {got} on the host, "
                 f"expected {want}")
        value, st = eager_step(ref)
        check(i, loss, value)
        stages.append(dict(tr.stage_ms, loss=loss))
        eager.append(st)
    if len(tr._steps) != 1 or tr.retraces:
        fail(f"{label}: {len(tr._steps)} step captures, retraces "
             f"{tr.retraces}")
    params = [p.detach().clone() for p in tr.model.parameters()]
    n = TRAIN_PROFILE
    window = profiled(f"train_{label}", n, tr.step)
    window_eager = profiled(f"train_{label}_eager", n,
                            lambda: eager_step(ref))
    check(steps + n - 1, tr.losses[-1], ref.losses[-1])
    if tr.losses != ref.losses:
        fail(f"{label}: the profiled steps' losses differ")
    want_k1 = 2 * (capture["seg_agg"] - capture["seg_agg_bwd"]) + \
        capture["seg_agg_bwd"]
    if window["k1_kernels"] != want_k1:
        fail(f"{label}: {window['k1_kernels']} K1 kernels a replayed step, "
             f"the capture recorded {want_k1}")
    for tag, w in (("captured", window), ("eager", window_eager)):
        print(f"[train] {label} profile of {n} {tag} steps: per step wall "
              f"{w['wall_ms']:.1f} ms, device busy "
              f"{w['device_busy_ms']:.3f} ms (K1 {w['k1_ms']:.3f} ms, "
              f"{w['k1_kernels']:.0f} K1 kernels), {w['kernels']:.0f} "
              f"kernels, device idle "
              + (f"{100 * w['idle_share']:.1f}%"
                 if w["idle_share"] is not None
                 else "not measured (no kernel in the trace)"), flush=True)
    for i, (st, ev) in enumerate(zip(stages, eager)):
        print(f"[train] {label} step {i:2d}: loss {st['loss']:.6f}; host ms "
              f"sample {st['sample']:.1f}, union+pad {st['union']:.1f}, "
              f"layouts {st['layouts']:.1f}, dedup {st['dedup']:.1f}, x "
              f"{st['x']:.1f}; step {st['step']:.1f} (eager "
              f"{ev['step']:.1f}); bit for bit the eager step", flush=True)
    return {"stages": stages, "eager_stages": eager, "profile": window,
            "profile_eager": window_eager, "params": params,
            "launches": launched}


def drive_train(g, x, y, spec):
    """Phase 11: minibatch GraphSAGE training on Reddit through
    PlannedSageTrainer on the cuda tier, each step one replay of the
    bucket's captured step (see the module docstring).  Returns the
    measurements and the K1 backward record."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.sage_minibatch import (PlannedSageTrainer,
                                                   train_minibatch_sage)

    def trainer(**kw):
        return PlannedSageTrainer(g, spec, x, y, device=g.device,
                                  **dict(TRAIN_KW, **kw))

    t0 = time.perf_counter()
    tr = trainer(dedup="none")
    plan = tr.plan
    orders = [lp.order for lp in plan.layers]
    # K1 launches a step: one forward per layer; for each layer whose
    # aggregation operand needs a gradient (layer 1's x does not when it
    # aggregates first) two backward ones over the capacity layout: the
    # pieces and the fold-back
    n_bwd = sum(i > 0 or o == "combine_first" for i, o in enumerate(orders))
    capture = {"seg_agg": plan.num_layers + 2 * n_bwd,
               "seg_agg_bwd": 2 * n_bwd, "fused_agg_combine": 0}
    print(f"[train] bucket {tuple(tr.bucket)} (seeds, inputs, edges), "
          f"plan {plan.describe()[0]['backend']} tier, orders {orders}, "
          f"aggregation tile {plan.agg_tile}; K1 launches a step "
          f"{capture}, recorded once into the step's CUDA graph; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    auto = trainer(dedup="auto").dedup
    print(f"[train] dedup='auto' resolves to {auto!r} on the H100 machine "
          f"model", flush=True)

    # -- (1) K1's backward at the first block, at both widths the steps
    #    run it (layer 1's hidden, layer 2's classes)
    prep0 = tr._prepare(tr.pipeline.batch_at(0))
    bwd = [check_k1_backward(tr, prep0, f)
           for f in (TRAIN_KW["hidden"], spec.num_classes)]

    # -- (2) step 0 against a torch-tier step on the same card and block
    tt = trainer(dedup="none", backend="torch")
    loss_c, grads_c = tr.loss_and_grads(prep0)
    loss_t, grads_t = tt.loss_and_grads(prep0)
    # each gradient leaf within the band of its own largest magnitude
    # (the leaves are far below 1, so max_err's floor of 1 would not do)
    errs = [((gc - gt).abs().max().item(),
             F32_BAND * SCALE * gt.abs().max().item())
            for gc, gt in zip(grads_c, grads_t)]
    loss_c, loss_t = loss_c.item(), loss_t.item()
    loss_err = abs(loss_c - loss_t)
    print(f"[train] step 0 vs torch tier: loss {loss_c:.7f} / "
          f"{loss_t:.7f}; gradients max_abs_err "
          + ", ".join(f"{e:.3e} (tol {t:.3e})" for e, t in errs), flush=True)
    if loss_err > F32_BAND * SCALE * max(1.0, abs(loss_t)) or \
            any(e > t for e, t in errs):
        fail("train: step 0's loss or gradients off the torch tier")
    del tt, grads_c, grads_t

    # -- predict's one capture, before training: pairs and none must agree
    #    bit for bit on the same parameters
    tp = trainer(dedup="pairs")
    p_none, p_pairs = tr.predict(step=0), tp.predict(step=0)
    if not np.array_equal(p_none, p_pairs):
        fail("train: predict with dedup='pairs' differs from 'none'")

    # -- (3) training through the captured step, none then pairs, each
    #    step bit for bit an eager step's from the same state
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    runs = {}
    for label, cur in (("none", tr), ("pairs", tp)):
        t0 = time.perf_counter()
        run = train_run(cur, trainer(dedup=label), TRAIN_STEPS, capture,
                        label)
        run["seconds"] = time.perf_counter() - t0
        run["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        (cap,) = cur._steps.values()
        run["captured_launches"] = cap.launches
        torch.cuda.reset_peak_memory_stats()
        runs[label] = run
    run_none, run_pairs = runs["none"], runs["pairs"]
    run_pairs["last_pairs"] = tp.last_pairs
    for label, run in runs.items():
        for key, st in (("mean_ms", run["stages"][1:]),
                        ("eager_mean_ms", run["eager_stages"][1:])):
            run[key] = {k: sum(s[k] for s in st) / len(st)
                        for k in ("sample", "union", "layouts", "dedup",
                                  "x", "step")}
        mean, ev = run["mean_ms"], run["eager_mean_ms"]
        print(f"[train] {label}: {TRAIN_STEPS} captured steps (one capture, "
              f"{TRAIN_STEPS - 1} replays, retraces 0) each bit for bit "
              f"the eager step, in {run['seconds']:.1f} s with the eager "
              f"steps beside them; mean of steps 1-: host ms sample "
              f"{mean['sample']:.1f}, union+pad {mean['union']:.1f}, "
              f"layouts {mean['layouts']:.1f}, dedup {mean['dedup']:.1f}, "
              f"x {mean['x']:.1f}, step {mean['step']:.1f} (eager: "
              f"layouts {ev['layouts']:.1f}, dedup {ev['dedup']:.1f}, x "
              f"{ev['x']:.1f}, step {ev['step']:.1f}); launches on the "
              f"host {run['launches']} (warm-up and capture), captured a "
              f"step {run['captured_launches']}; peak memory "
              f"{run['peak_bytes'] / 2**30:.2f} GiB above the inputs"
              + (f"; {tp.last_pairs} pairs in the last block"
                 if label == "pairs" else ""), flush=True)
    gap = max(abs(a - b) for a, b in zip(tr.losses, tp.losses))
    print(f"[train] pairs vs none losses: largest difference {gap:.3e}",
          flush=True)
    if gap > 1e-4 * max(abs(v) for v in tr.losses) + 1e-5:
        fail(f"train: pairs and none losses differ by {gap:.3e}")
    del tp

    # -- (4) resume through captured steps: 10 steps, save, a fresh
    #    trainer restores, 10 more -- the uninterrupted run's first 20
    ck = Checkpointer(str(ROOT / "build" / "train_ckpt"), keep=1)
    a = trainer(dedup="none")
    a.train(RESUME_AT)
    a.save(ck, blocking=True)
    del a
    b = trainer(dedup="none")
    at = b.restore(ck)
    b.train(TRAIN_STEPS - RESUME_AT)
    same = b.losses == tr.losses[:TRAIN_STEPS] and all(
        torch.equal(p, q) for p, q in zip(b.model.parameters(),
                                          run_none["params"]))
    print(f"[train] resume at step {at} through captured steps: losses and "
          f"parameters {'bit for bit' if same else 'DIFFERENT from'} the "
          f"uninterrupted run's; retraces {b.retraces}", flush=True)
    if not same or at != RESUME_AT or b.retraces:
        fail("train: the resumed run differs from the uninterrupted one")
    del b
    for run in runs.values():
        del run["params"]

    # -- (5) predict: one capture, replays bit for bit the eager forward
    for step in (TRAIN_STEPS, TRAIN_STEPS + 1, TRAIN_STEPS + 2):
        prep = tr._prepare(tr.pipeline.batch_at(step))
        xx, gg, glay, ded = tr._inputs(prep, backward=False)
        with torch.no_grad():
            eager = tr.plan.run_model(tr.params, xx, graph=gg,
                                      graph_layout=glay, dedup_layout=ded)
            got = tr.fwd(tr.params, xx, gg, dedup=ded, layout=glay)
        if not torch.equal(got, eager):
            fail(f"train: predict's replay at step {step} differs from the "
                 f"eager forward")
    print(f"[train] predict: {tr.fwd.num_traces} capture, "
          f"{tr.fwd.num_replays} replays, each bit for bit the eager "
          f"forward; retraces {tr.retraces}", flush=True)
    if tr.fwd.num_traces != 1 or tr.retraces:
        fail("train: predict captured more than once")

    # -- the step's replay alone (it trains tr on, so it comes last)
    (cap,) = tr._steps.values()
    run_none["replay_ms"] = time_ms(cap.graph.replay, 10)
    print(f"[train] the captured step's replay: {run_none['replay_ms']:.3f} "
          f"ms (CUDA events), against a captured step's "
          f"{run_none['mean_ms']['step']:.1f} ms on the host clock and the "
          f"eager step's {run_none['eager_mean_ms']['step']:.1f}", flush=True)

    # -- (6) the per-block demo
    reset_launch_counts()
    t0 = time.perf_counter()
    _, demo_losses, _ = train_minibatch_sage(g, spec, x, y, steps=3,
                                             device=g.device)
    demo = launch_counts()
    print(f"[train] train_minibatch_sage: 3 steps, losses "
          f"{[round(v, 5) for v in demo_losses]}, K1 launches "
          f"{demo['seg_agg']} ({demo['seg_agg_bwd']} backward), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not all(np.isfinite(demo_losses)) or demo["seg_agg_bwd"] < 3:
        fail("train: the per-block demo did not train through K1")
    return {"orders": orders, "capture": capture, "auto": auto,
            "launches": run_none["launches"], "none": run_none,
            "pairs": run_pairs, "k1_bwd": bwd, "step0_grad_errs": errs,
            "demo": demo_losses}


def drive_paper(g, x) -> dict:
    """Phase 17: the paper launchers' functions -- gcn_phase_ordering over
    the whole of Reddit, quickstart on its reduced Cora (see the module
    docstring).  Returns their numbers."""
    import numpy as np
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch import gcn_phase_ordering, quickstart

    reset_launch_counts()
    po = gcn_phase_ordering.phase_ordering(g, x, PAPER_ITERS)
    launched = launch_counts()
    paper = gcn_phase_ordering.PAPER
    r = po["ratios"]
    tol = F32_BAND * SCALE * max(1.0, po["unfused_scale"])
    print(f"[paper] Table 4 on Reddit (V={g.num_vertices}, E={g.num_edges}"
          f", 602 -> 128): data-access reduction "
          f"{r['data_access_reduction']:.4f}x (paper {paper['data']}x), "
          f"computation reduction {r['computation_reduction']:.4f}x (paper "
          f"{paper['ops']}x); planner order {po['decision']['order']} on "
          f"the {po['decision']['backend']} tier; combine-first "
          f"{po['combine_first_ms']:.3f} ms, aggregate-first "
          f"{po['aggregate_first_ms']:.3f} ms, speedup {po['speedup']:.3f}x "
          f"(paper, measured: {paper['speedup']}x); fused through K2 "
          f"{po['fused_ms']:.3f} ms, max_abs_err vs unfused "
          f"{po['fused_err']:.3e} (tol {tol:.3e}); launches {launched}",
          flush=True)
    if po["decision"]["order"] != "combine_first" or \
            po["fused_backend"] != "cuda" or po["fused_err"] > tol or \
            not launched["fused_agg_combine"] or not launched["seg_agg"]:
        fail("paper: the phase-ordering views did not run K1 and K2 on the "
             "card, or the fused plan is off the unfused one")
    qs = quickstart.quickstart("cuda", quickstart.STEPS)
    losses = qs["losses"]
    print(f"[paper] quickstart on {qs['spec'].name} (V="
          f"{qs['spec'].num_vertices}, F={qs['spec'].feature_len}): order "
          f"{qs['costs']['order']}, data-access reduction "
          f"{qs['ratios']['data_access_reduction']:.4f}x; plan.compile() "
          f"bit for bit the report's output: {qs['compiled_equal']}; "
          f"{len(losses)} steps through plan.compile(), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {qs['traces']} traces; "
          f"accuracy {qs['accuracy']:.3f}", flush=True)
    if not (qs["compiled_equal"] and np.isfinite(losses).all()
            and losses[-1] < losses[0] and qs["traces"] == 2):
        fail("paper: quickstart's compiled forward or training failed")
    return {"ratios": {k: r[k] for k in ("data_access_reduction",
                                         "computation_reduction")},
            "order": po["decision"]["order"],
            "combine_first_ms": po["combine_first_ms"],
            "aggregate_first_ms": po["aggregate_first_ms"],
            "speedup": po["speedup"], "fused_ms": po["fused_ms"],
            "fused_err": po["fused_err"], "launches": launched,
            "quickstart": {"losses": losses, "accuracy": qs["accuracy"],
                           "report": qs["report"].to_dict()}}


def serve_run(g_host, x, spec, name: str, mix: str) -> dict:
    """Phase 12, one model under one traffic mix: a GraphServeEngine on
    the cuda tier (see the module docstring for the checks).  Returns the
    measurements."""
    import numpy as np
    import torch
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.gcn import PAPER_MODELS
    from repro_torch.serve import (GraphRequest, GraphServeEngine,
                                   default_buckets)
    from torch.profiler import ProfilerActivity, profile

    fanouts, most = SERVE_MIXES[mix]
    label = f"{name}/{mix}"
    cfg, dev, v = PAPER_MODELS[name], x.device, spec.num_vertices
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng = GraphServeEngine(
        g_host, cfg, None, x, spec.num_classes, fanouts=fanouts,
        buckets=default_buckets(fanouts, seed_levels=(4, 16, 64),
                                max_inputs=v),
        max_batch=8, seed=SEED, device=dev)
    eng.params = eng.init_params(torch.Generator().manual_seed(SEED))
    traces = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = launch_counts()
    if set(traces.values()) != {1} or warm["seg_agg"] == 0 or \
            warm["fused_agg_combine"]:
        fail(f"serve {label}: warm-up traces {traces}, launches {warm}: "
             f"each bucket must capture once, through K1 only")
    # -- K1's launches in each capture against an eager forward of the
    #    same plan over the bucket's template
    captured = {}
    for b in eng.buckets:
        plan, fn = eng._bucket_plan(b)
        t = plan.g
        before = launch_counts()
        with torch.no_grad():
            plan.run_model(eng.params, torch.zeros(
                (b.num_inputs, eng.in_dim), device=dev), graph=t,
                graph_layout=eng._layout(plan, b, t.src.cpu().numpy(),
                                         t.dst.cpu().numpy()))
        eager = {k: n - before[k] for k, n in launch_counts().items()}
        cap = fn.capture_launches
        captured[eng._bucket_name(b)] = cap["seg_agg"]
        if cap["seg_agg"] != eager["seg_agg"] or \
                cap["seg_agg"] != plan.num_layers or \
                cap["fused_agg_combine"] or eager["fused_agg_combine"]:
            fail(f"serve {label}: bucket {tuple(b)} captured {cap}, its "
                 f"eager forward launched {eager}; expected seg_agg once "
                 f"a layer ({plan.num_layers})")

    # -- the wave: SERVE_REQUESTS requests, seeds without replacement
    rng = np.random.default_rng(SEED)

    def seeds():
        return rng.choice(v, size=int(rng.integers(1, most + 1)),
                          replace=False)

    reqs = [GraphRequest(rid=i, seeds=seeds())
            for i in range(SERVE_REQUESTS)]
    before = launch_counts()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    torch.cuda.synchronize()
    eager_in_wave = {k: n - before[k] for k, n in launch_counts().items()}
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated() - base
    if len(done) != SERVE_REQUESTS or st["retraces"] or \
            st["bucket_misses"] or any(eager_in_wave.values()):
        fail(f"serve {label}: {len(done)} served, retraces "
             f"{st['retraces']}, misses {st['bucket_misses']}, kernel "
             f"launches outside the captured graphs {eager_in_wave}")
    hits = {eng._bucket_name(b): n for b, n in eng._bucket_hits.items()}
    replayed_k1 = sum(hits[k] * n for k, n in captured.items())
    for r in done:
        if r.logits.shape != (len(r.seeds), spec.num_classes) or \
                not np.isfinite(r.logits).all():
            fail(f"serve {label}: request {r.rid}: logits "
                 f"{r.logits.shape} not finite or of the wrong shape")

    # -- the oracles: the first requests against the bucket plan's eager
    #    forward over the padded block (bit for bit) and over the
    #    unpadded one (the f32 band)
    by_rid = {r.rid: r for r in done}
    same_unpadded, oracle_err = 0, 0.0
    for rid in range(SERVE_ORACLE):
        r = by_rid[rid]
        if not np.array_equal(r.logits, eng.run_eager(r.prep, padded=True)):
            fail(f"serve {label}: request {rid}: the replay differs from "
                 f"the eager forward over the same padded block")
        un = eng.run_eager(r.prep)
        same_unpadded += int(np.array_equal(r.logits, un))
        err = float(np.abs(r.logits - un).max())
        oracle_err = max(oracle_err, err)
        if err > F32_BAND * SCALE * max(1.0, float(np.abs(un).max())):
            fail(f"serve {label}: request {rid}: the replay is {err:.3e} "
                 f"off the eager forward over the unpadded block")

    # -- every request against a torch-tier plan on the same card
    tplans, tier_err = {}, 0.0
    for r in done:
        b = r.bucket
        if b not in tplans:
            tplans[b] = build_plan(eng._plans[b].g, cfg, eng.in_dim,
                                   spec.num_classes, backend="torch",
                                   fused=False, device=dev)
        with torch.no_grad():
            out = tplans[b].run_model(eng.params,
                                      eng._gather(r.prep.frontier),
                                      graph=r.prep.graph.to(dev))
        ref = out[torch.from_numpy(r.prep.seed_pos.astype(np.int64))
                  .to(dev)].cpu().numpy()
        err = float(np.abs(r.logits - ref).max())
        tier_err = max(tier_err, err / float(np.abs(ref).max()))
        if err > SERVE_TOL * float(np.abs(ref).max()):
            fail(f"serve {label}: request {r.rid}: {err:.3e} off the torch "
                 f"tier (tolerance {SERVE_TOL} of {np.abs(ref).max():.3e})")
    del tplans

    # -- the largest bucket's compiled call and its copy of x, timed
    big = eng.buckets[-1]
    plan, fn = eng._bucket_plan(big)
    xx, gg, lay = eng._pad_into(eng.prepare(seeds()), big)
    with torch.no_grad():
        call_ms = time_ms(lambda: fn(eng.params, xx, gg, layout=lay), 20)
    dst = torch.empty_like(xx)
    copy_ms = time_ms(lambda: dst.copy_(xx), 20)
    del dst, xx, gg, lay

    # -- a profiled window of SERVE_PROFILE more requests, served one at a
    #    time: each one's service time (no queueing) beside its bucket and
    #    its real frontier
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    w0 = time.perf_counter()
    service = []
    for i in range(SERVE_PROFILE):
        r = GraphRequest(rid=SERVE_REQUESTS + i, seeds=seeds())
        t1 = time.perf_counter()
        eng.submit(r)
        eng.run()                        # ends with the logits on the host
        service.append(((time.perf_counter() - t1) * 1e3, len(r.seeds),
                        r.frontier_size, r.bucket.num_seeds))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - w0) * 1e3
    prof.__exit__(None, None, None)
    window = kernel_window(f"serve_{name}_{mix}", prof, wall, SERVE_PROFILE)

    # -- the deliberate miss (mix A): served eagerly through a per-request
    #    plan, counted, and within the band of the torch tier
    miss = None
    if mix == "A":
        r = GraphRequest(rid=-1, seeds=rng.choice(v, size=SERVE_MISS,
                                                  replace=False))
        before = launch_counts()
        eng.submit(r)
        eng.run()
        launched = launch_counts()["seg_agg"] - before["seg_agg"]
        tp = build_plan(r.prep.graph.to(dev), cfg, eng.in_dim,
                        spec.num_classes, backend="torch", fused=False,
                        device=dev)
        with torch.no_grad():
            ref = tp.run_model(eng.params, eng._gather(r.prep.frontier))
        ref = ref[torch.from_numpy(r.prep.seed_pos.astype(np.int64))
                  .to(dev)].cpu().numpy()
        err = float(np.abs(r.logits - ref).max())
        miss = {"frontier": r.frontier_size, "edges": r.edge_count,
                "k1_launches": launched, "max_abs_err": err}
        print(f"[serve] {label} miss: {SERVE_MISS} seeds, frontier "
              f"{r.frontier_size}, {r.edge_count} edges, served eagerly "
              f"({launched} K1 launches), vs torch tier {err:.3e}; misses "
              f"{eng.stats()['bucket_misses']}", flush=True)
        if r.bucket is not None or eng.stats()["bucket_misses"] != 1 or \
                launched != plan.num_layers or \
                err > SERVE_TOL * float(np.abs(ref).max()):
            fail(f"serve {label}: the {SERVE_MISS}-seed miss was not "
                 f"served eagerly through K1 within the band")

    report = eng.workload_report()
    sweeps = eng.stats()["cache_sweeps"]
    h = st["host_ms"]
    print(f"[serve] {label}: buckets {[tuple(b) for b in eng.buckets]}, "
          f"hits {hits}; warm-up {warm_s:.1f} s, K1 per capture "
          f"{captured}; {SERVE_REQUESTS} requests p50 {st['p50_ms']:.2f} / "
          f"p95 {st['p95_ms']:.2f} / p99 {st['p99_ms']:.2f} ms, "
          f"{st['throughput_rps']:.1f} req/s; K1 launches replayed "
          f"{replayed_k1}, outside the graphs 0; retraces 0, misses 0",
          flush=True)
    print(f"[serve] {label}: host ms a request: sample {h['sample']:.2f}, "
          f"union {h['union']:.2f}, pad {h['pad']:.2f}, layouts "
          f"{h['layouts']:.2f}, gather {h['gather']:.2f}, replay+readback "
          f"{h['replay']:.2f}; bucket {tuple(big)} call {call_ms:.4f} ms "
          f"(x copy-in {copy_ms:.4f}); peak memory {peak / 2**20:.1f} MiB "
          f"above the inputs", flush=True)
    print(f"[serve] {label}: oracle (first {SERVE_ORACLE}): replay bit for "
          f"bit the padded eager forward, {same_unpadded} of "
          f"{SERVE_ORACLE} bit for bit the unpadded one (largest "
          f"difference {oracle_err:.3e}); vs torch tier {tier_err:.3e} of "
          f"the largest magnitude; profile of {SERVE_PROFILE} requests: "
          f"wall {window['wall_ms']:.2f} ms, device busy "
          f"{window['device_busy_ms']:.3f} ms (K1 {window['k1_ms']:.3f}), "
          f"{window['kernels']:.0f} kernels a request, device idle "
          + (f"{100 * window['idle_share']:.1f}%"
             if window["idle_share"] is not None
             else "not measured (no kernel in the trace)")
          + f"; report valid, {sweeps} cache sweeps", flush=True)
    print(f"[serve] {label}: service ms (seeds, real frontier, bucket "
          f"seeds) one at a time under the profiler: " + ", ".join(
              f"{ms:.2f} ({n}, {f}, {b})" for ms, n, f, b in service),
          flush=True)
    out = {"buckets": [tuple(b) for b in eng.buckets], "hits": hits,
           "warmup_s": warm_s, "captured_k1": captured,
           "replayed_k1": replayed_k1, "stats": {
               k: st[k] for k in ("p50_ms", "p95_ms", "p99_ms",
                                  "throughput_rps", "host_ms", "steps")},
           "peak_bytes": peak, "call_ms": call_ms, "copy_ms": copy_ms,
           "oracle_unpadded_bitwise": same_unpadded,
           "oracle_max_diff": oracle_err, "torch_tier_rel_err": tier_err,
           "profile": window, "service": service, "miss": miss,
           "report_serving": report.serving}
    del eng, report
    return out


def serve_fresh(mode: str) -> None:
    """``chip_smoke.py --serve-fresh MODE``, in a fresh process: one
    GraphServeEngine (gcn, mix A) on Reddit on the cuda tier, warmed by
    ``warmup()`` (MODE "warmup") or by its bucket captures alone (MODE
    "captures": the warm-up before it drove the request path), then
    phase 12's wave of SERVE_REQUESTS requests, all submitted at once.
    Prints one JSON line: each request's service time on the host clock
    (its admission, which samples, plus its padding, gather, replay and
    readback, without queueing) with its stages, the wave's p50."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph.datasets import load_dataset
    from repro_torch.models.gcn import PAPER_MODELS
    from repro_torch.serve import (GraphRequest, GraphServeEngine,
                                   default_buckets)
    torch.backends.cuda.matmul.allow_tf32 = False
    g, x, _, spec = load_dataset("reddit", seed=SEED, device="cuda")
    fanouts, most = SERVE_MIXES["A"]
    eng = GraphServeEngine(
        g.to("cpu"), PAPER_MODELS["gcn"], None, x, spec.num_classes,
        fanouts=fanouts, buckets=default_buckets(
            fanouts, seed_levels=(4, 16, 64), max_inputs=spec.num_vertices),
        max_batch=8, seed=SEED, device="cuda")
    eng.params = eng.init_params(torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    if mode == "warmup":
        eng.warmup()
    else:
        eng._capture_buckets()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # each request's service time: its admission (prepare) and its
    # run_prepared, keyed by request
    svc, rid_of = {}, {}
    admit, run = eng._admit_into_slot, eng.run_prepared

    def timed_admit(slot, req):
        t = time.perf_counter()
        out = admit(slot, req)
        svc[req.rid] = {"ms": (time.perf_counter() - t) * 1e3,
                        **{k: eng.stage_ms[k] for k in ("sample", "union")}}
        rid_of[id(req.prep)] = req.rid
        return out

    def timed_run(prep):
        t = time.perf_counter()
        out = run(prep)
        rec = svc[rid_of[id(prep)]]
        rec["ms"] += (time.perf_counter() - t) * 1e3
        rec.update({k: eng.stage_ms[k]
                    for k in ("pad", "layouts", "gather", "replay")})
        return out
    eng._admit_into_slot, eng.run_prepared = timed_admit, timed_run
    rng = np.random.default_rng(SEED)
    for i in range(SERVE_REQUESTS):
        eng.submit(GraphRequest(rid=i, seeds=rng.choice(
            spec.num_vertices, size=int(rng.integers(1, most + 1)),
            replace=False)))
    done = eng.run()
    torch.cuda.synchronize()
    st = eng.stats()
    if len(done) != SERVE_REQUESTS or st["retraces"] or st["bucket_misses"]:
        fail(f"fresh serve ({mode}): {len(done)} served, retraces "
             f"{st['retraces']}, misses {st['bucket_misses']}")
    first = svc[0]
    rest = sorted(svc[i]["ms"] for i in range(1, SERVE_REQUESTS))
    print(json.dumps({"mode": mode, "warm_s": warm_s, "first": first,
                      "median_rest_ms": rest[len(rest) // 2],
                      "p50_ms": st["p50_ms"], "host_ms": st["host_ms"]}))


def check_serve_fresh() -> dict:
    """Phase 12's warm-up check: ``serve_fresh`` in a fresh process after
    the captures alone, which shows the stage that held the first-use
    costs, and after ``warmup()``, whose first request must take at most
    WARM_LIMIT times the median service time of the later ones.  Returns
    both runs' records."""
    out = {}
    for mode in ("captures", "warmup"):
        res = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-fresh",
             mode], capture_output=True, text=True, timeout=600, cwd=ROOT)
        if res.returncode != 0:
            fail(f"fresh serve ({mode}) exited {res.returncode}: "
                 f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
        rec = out[mode] = json.loads(res.stdout.strip().splitlines()[-1])
        f = rec["first"]
        print(f"[serve] fresh process, gcn/A after {mode}: first request "
              f"{f['ms']:.2f} ms (sample {f['sample']:.2f}, union "
              f"{f['union']:.2f}, pad {f['pad']:.2f}, layouts "
              f"{f['layouts']:.2f}, gather {f['gather']:.2f}, "
              f"replay+readback {f['replay']:.2f}), median of the other "
              f"{SERVE_REQUESTS - 1} {rec['median_rest_ms']:.2f} ms; wave "
              f"p50 {rec['p50_ms']:.2f} ms; warm-up {rec['warm_s']:.2f} s",
              flush=True)
    rec = out["warmup"]
    if rec["first"]["ms"] > WARM_LIMIT * rec["median_rest_ms"]:
        fail(f"serve: after warmup() the first request took "
             f"{rec['first']['ms']:.2f} ms, over {WARM_LIMIT} x the median "
             f"{rec['median_rest_ms']:.2f} ms")
    return out


def drive_serve(g, x, spec) -> dict:
    """Phase 12: GCN node-prediction serving on Reddit, the three Table-1
    models under both traffic mixes (see the module docstring)."""
    import torch
    from repro_torch.core.plan import clear_plan_cache
    g_host = g.to("cpu")                 # sampled on the host, copied once
    out = {"fresh": check_serve_fresh()}
    for name in ("gcn", "sage", "gin"):
        for mix in SERVE_MIXES:
            out[f"{name}/{mix}"] = serve_run(g_host, x, spec, name, mix)
            clear_plan_cache()           # the engine's plans and graphs
            torch.cuda.empty_cache()
    return out


def dist_expected_k1(plan) -> int:
    """K1 launches of one forward of a distributed plan: a launch per held
    shard a layer, P of them on the ring (one a hop)."""
    node_ax = plan.axes[0] if plan.partition_kind == "2d" else plan.axis
    hops = plan.mesh.axis_size(node_ax) if plan.strategy == "ring" else 1
    return plan.num_layers * len(plan.mesh.coords) * hops


def dist_wire(plan) -> list:
    """``schedule_wire_bytes`` of each layer of a distributed plan."""
    from repro_torch.core.distributed import schedule_wire_bytes
    two_d = plan.partition_kind == "2d"
    return [schedule_wire_bytes(
        plan.partition, lp.din if lp.order == "aggregate_first" else lp.dout,
        strategy=plan.strategy, overlap=plan.overlap, dtype=plan.dtype,
        combine_out_len=lp.dout if two_d else None)["total_bytes"]
        for lp in plan.layers]


def dist_window(name: str, prof, wall_ms: float, n: int) -> dict:
    """Per forward over a profiled window of ``n`` distributed forwards:
    wall ms, the device's busy ms (the union of kernel and copy intervals
    in the trace), K1's kernels' ms, the ring's copies' ms, the ms in
    which a copy ran beside a kernel (the overlap the pipelined schedule
    is for), kernels and copies, and the idle share.  The trace goes to
    chiprun_out/traces/<name>.json."""
    out_dir = ROOT / "chiprun_out" / "traces"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    kern = [e for e in events if e.get("cat") == "kernel"]
    copy = [e for e in events if e.get("cat") == "gpu_memcpy"]

    def union(evs):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs)
        total, end = 0.0, -1e300
        for a, b in spans:
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    busy = union(kern + copy) / 1e3
    k_ms, c_ms = union(kern) / 1e3, sum(e["dur"] for e in copy) / 1e3
    k1 = sum(e["dur"] for e in kern
             if "fold_kernel" in e.get("name", "")
             or "row_starts_kernel" in e.get("name", "")) / 1e3
    return {"n": n, "wall_ms": wall_ms / n, "device_busy_ms": busy / n,
            "k1_ms": k1 / n, "copy_ms": c_ms / n,
            "copy_beside_kernel_ms": (k_ms + union(copy) / 1e3 - busy) / n,
            "kernels": len(kern) / n, "copies": len(copy) / n,
            "idle_share": 1 - busy / wall_ms}


def check_k1_bf16_f32(plan) -> list:
    """K1's bf16-in/f32-out entry at phase 13's bf16 shapes: each of the
    plan's 16 ring sub-layouts (shard p, owner o) over a random bf16 slab
    of a block's rows, F = 128 (layer 0's exchange) and 41 (layer 1's),
    against its plain version (the f32 fold of the same rows): the f32
    band and ROW_LIMIT a row, a repeat launch bit for bit.  Times summed
    over the 16 launches (one layer's halo sums), beside their bound and
    torch.sparse.mm on each sub-layout's bf16 CSR matrix (bf16 output: the
    same sums rounded once).  Returns one record per F."""
    import torch
    from repro_torch.kernels import seg_agg as k1
    pg = plan.partition
    block, nsh = pg.block_size, pg.num_shards
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    f32 = torch.float32
    records = []
    for f in (128, 41):
        x = torch.randn((block, f), generator=gen, device="cuda").to(
            torch.bfloat16)
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
               "slots": 0}
        err = row = fro = 0.0
        tol, same, lib_err, lib_note = 0.0, True, 0.0, None
        for p in range(nsh):
            src, dstl = pg.shard_edges(p)
            for o, lay in enumerate(plan.shard_layouts[p]):
                args = (x, lay.src, lay.dstl, lay.mask, None)
                kern = lambda: k1.seg_agg(  # noqa: E731
                    *args, tile_m=lay.tile_m, out_dtype=f32)
                plain = lambda: k1.seg_agg_plain(  # noqa: E731
                    *args, tile_m=lay.tile_m, out_dtype=f32)
                out_k, out_p = kern(), plain()
                torch.cuda.synchronize()
                e = (out_k - out_p).abs().max().item()
                t = F32_BAND * SCALE * max(1.0, out_p.abs().max().item())
                r, fr = rel_errs(out_k, out_p)
                if not (bool(torch.isfinite(out_k).all().item())
                        and out_k.dtype == f32 and e <= t
                        and r <= ROW_LIMIT["float32"]):
                    fail(f"seg_agg_bf16_f32 F={f} sub-layout ({p}, {o}): "
                         f"kernel and plain version differ by {e:.3e} "
                         f"(tolerance {t:.3e}) or a row by {r:.3e}")
                same = same and torch.equal(out_k, kern())
                err, row, fro, tol = max(err, e), max(row, r), max(fro, fr), \
                    max(tol, t)
                # the same sums by a library call: a bf16 CSR matrix of the
                # sub-layout's edges times the slab
                sel = (src // block) == o
                cnt = torch.bincount(torch.from_numpy(dstl[sel]),
                                     minlength=block)
                crow = torch.zeros(block + 1, dtype=torch.int64)
                crow[1:] = torch.cumsum(cnt, 0)
                adj = torch.sparse_csr_tensor(
                    crow.cuda(), torch.from_numpy(src[sel] - o * block).cuda(),
                    torch.ones(int(sel.sum()), device="cuda",
                               dtype=torch.bfloat16), size=(block, block))
                if lib_note is None:
                    try:      # a yardstick only: nothing in the port calls it
                        lib = torch.sparse.mm(adj, x)
                        lib_err = max(lib_err, (lib.float() - out_p[:block])
                                      .abs().max().item())
                        tot["library_ms"] += time_ms(
                            lambda: torch.sparse.mm(adj, x), 10)
                        del lib
                    except RuntimeError as e:
                        lib_note = f"none: torch.sparse.mm on a bf16 CSR " \
                            f"matrix raised {str(e).splitlines()[0][:120]}"
                tot["ms"] += time_ms(kern, 10)
                tot["plain_ms"] += time_ms(plain, 2)
                slots = int(lay.mask.sum().item())
                tot["slots"] += slots
                tot["bytes"] += x.numel() * 2 + lay.nblocks * lay.tile_m * f \
                    * 4 + 3 * lay.src.numel() * 4
                del out_k, out_p, adj
        if not same:
            fail(f"seg_agg_bf16_f32 F={f}: two launches on the same input "
                 f"differ")
        lib_tol = BF16_BAND * max(1.0, tol / (F32_BAND * SCALE))
        if lib_note is None:
            lib_note = f"torch.sparse.mm, bf16 CSR (bf16 out), max_abs_err " \
                f"{lib_err:.3e}" if lib_err <= lib_tol else \
                f"none: torch.sparse.mm differs by {lib_err:.3e}"
        lib_ok = lib_note.startswith("torch")
        b_ms, b_by = bound(tot["bytes"], tot["slots"] * f)
        rec = {"name": "seg_agg_bf16_f32", "graph": "reddit", "f_in": f,
               "f_out": f, "layouts": nsh * nsh, "rows": block,
               "slots": tot["slots"], "max_abs_err": err, "tol": tol,
               "row_rel_err": row, "fro_rel_err": fro, "repeat_equal": same,
               "ms": tot["ms"], "plain_ms": tot["plain_ms"],
               "bytes": tot["bytes"], "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": tot["library_ms"] if lib_ok else None,
               "library": lib_note}
        rec.update(ratios(rec))
        records.append(rec)
        print(f"[dist] seg_agg_bf16_f32 F={f}: {nsh * nsh} ring sub-layouts "
              f"of {block} rows, {tot['slots']} slots: max_abs_err="
              f"{err:.3e} tol={tol:.3e} row_rel_err={row:.3e} (limit "
              f"{ROW_LIMIT['float32']:.0e}) fro_rel_err={fro:.3e} "
              f"repeat_equal={same} ms={tot['ms']:.4f} plain_ms="
              f"{tot['plain_ms']:.4f} library_ms={rec['library_ms']} "
              f"[{rec['library']}] bound_ms={b_ms:.4f} ({b_by}; "
              f"{tot['bytes']} B) frac_of_bound={rec['frac_of_bound']:.4f}",
              flush=True)
        del x
    return records


def drive_distributed(g, x, spec, ref, local_ms: float) -> dict:
    """Phase 13: phase 4's gcn through distributed plans on LocalMeshes of
    this card (DIST_CASES), then the world-size-1 NCCL process (see the
    module docstring).  ``ref`` is phase 4's f32 logits of the same model,
    ``local_ms`` its forward time."""
    import torch
    from repro_torch.core.characterize import collective_bytes
    from repro_torch.core.distributed import LocalMesh
    from repro_torch.core.plan import clear_plan_cache
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.gcn import make_paper_model
    from torch.profiler import ProfilerActivity, profile

    m = make_paper_model("gcn", spec, backend="auto", device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    meshes = {(4,): LocalMesh((4,), ("data",)),
              (4, 2): LocalMesh((4, 2), ("node", "feat"))}
    keep, runs, k1_recs, launches_bf16_f32 = {}, {}, [], None
    for label, shape, strategy, overlap, dtype in DIST_CASES:
        mesh = meshes[shape]
        t0 = time.perf_counter()
        plan = m.plan_for(g, mesh=mesh, strategy=strategy, overlap=overlap,
                          dtype=dtype)
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        mesh.reset_counts()
        with torch.inference_mode():
            out = m(g, x, plan=plan)
        torch.cuda.synchronize()
        counts = launch_counts()
        counted = collective_bytes(mesh)
        peak = torch.cuda.max_memory_allocated() - base
        want_k1 = dist_expected_k1(plan)
        wire = dist_wire(plan)
        if dtype == "bf16":
            launches_bf16_f32 = counts["seg_agg_bf16_f32"]
            want_counts = (want_k1, want_k1, 0)
        else:
            want_counts = (want_k1, 0, 0)
        got_counts = (counts["seg_agg"], counts["seg_agg_bf16_f32"],
                      counts["fused_agg_combine"])
        if got_counts != want_counts:
            fail(f"{label}: launches (seg_agg, seg_agg_bf16_f32, "
                 f"fused_agg_combine) {got_counts}, expected {want_counts}")
        if counted["total"] != sum(wire):
            fail(f"{label}: the mesh counted {counted['total']} B a shard, "
                 f"the schedule moves {sum(wire)}")
        with torch.inference_mode():
            again = m(g, x, plan=plan)
        same = torch.equal(out, again)
        del again
        if tuple(out.shape) != tuple(ref.shape) or \
                not bool(torch.isfinite(out).all().item()):
            fail(f"{label}: logits {tuple(out.shape)} not finite or of the "
                 f"wrong shape")
        if dtype == "bf16":
            err = (out.float() - ref).abs().max().item()
            tol = BF16_BAND * max(1.0, ref.abs().max().item())
        else:
            err, tol = max_err(out, ref)
        with torch.inference_mode():
            rounds = sorted(time_ms(lambda: m(g, x, plan=plan), DIST_REPS)
                            for _ in range(DIST_ROUNDS))
            ms = rounds[DIST_ROUNDS // 2]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for _ in range(DIST_PROFILED):
                    m(g, x, plan=plan)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) * 1e3
        win = dist_window("dist_" + label.replace("/", "_").replace(" ", "_"),
                          prof, wall, DIST_PROFILED)
        # per layer: the probe raises unless the mesh counted what the
        # schedule moves
        rep = plan.instrument().run_model(m.tree(), x).validate()
        if rep.mismatches(plan):
            fail(f"{label}: describe() against the records: "
                 f"{rep.mismatches(plan)}")
        layer_ms = [r.wall_time_s * 1e3 for r in rep.records]
        runs[label] = {
            "mesh": list(shape), "strategy": strategy,
            "overlap": plan.overlap, "dtype": dtype,
            "orders": [lp.order for lp in plan.layers],
            "block": plan._node_partition.block_size,
            "build_s": build_s, "k1_launches": counts["seg_agg"],
            "counted_bytes": counted, "wire_per_layer": wire,
            "halo_bytes": [r.collective_bytes for r in rep.records],
            "exposed_s": [r.exposed_collective_time for r in rep.records],
            "overlapped_s": [r.overlapped_collective_time
                             for r in rep.records],
            "max_abs_err": err, "tol": tol, "repeat_equal": same,
            "ms": ms, "ms_rounds": rounds, "vs_local": ms / local_ms,
            "layer_ms_synced": layer_ms, "peak_bytes": peak,
            "profiled": win}
        print(f"[dist] {label:20s} mesh={shape} overlap={plan.overlap} "
              f"orders={runs[label]['orders']} block={runs[label]['block']} "
              f"build {build_s:.1f} s; K1 {counts['seg_agg']} launches "
              f"(bf16->f32 {counts['seg_agg_bf16_f32']}); counted "
              f"{counted['total']} B a shard = schedule {wire}; logits vs "
              f"phase 4 max_abs_err={err:.3e} tol={tol:.3e}; repeat_equal="
              f"{same}; forward {ms:.3f} ms ({ms / local_ms:.2f}x phase 4's "
              f"{local_ms:.3f}; rounds {['%.3f' % t for t in rounds]}); "
              f"layers synced {['%.3f' % t for t in layer_ms]} ms; peak "
              f"{peak / 2**30:.3f} GiB above the inputs", flush=True)
        print(f"[dist] {label:20s} profiled {DIST_PROFILED} forwards: wall "
              f"{win['wall_ms']:.3f} ms, device busy "
              f"{win['device_busy_ms']:.3f} (K1 {win['k1_ms']:.3f}, copies {win['copy_ms']:.3f}, a copy "
              f"beside a kernel {win['copy_beside_kernel_ms']:.3f}), "
              f"{win['kernels']:.0f} kernels and {win['copies']:.0f} copies a "
              f"forward, idle {win['idle_share']:.3f}", flush=True)
        if err > tol or not same:
            fail(f"{label}: logits off phase 4's by {err:.3e} (tolerance "
                 f"{tol:.3e}) or two calls differ")
        if label in ("ring/none", "2d ring/none"):
            keep[label] = out
        elif label in ("ring/pipelined", "2d ring/pipelined"):
            twin = keep.pop(label.replace("pipelined", "none"))
            if not torch.equal(out, twin):
                fail(f"{label}: not bit for bit the single-buffered ring")
            print(f"[dist] {label}: bit for bit the single-buffered ring",
                  flush=True)
            del twin
        if dtype == "bf16":
            k1_recs = check_k1_bf16_f32(plan)
        del out, plan, rep
        torch.cuda.empty_cache()
    if runs["ring/auto"]["overlap"] != "pipelined":
        fail(f"ring/auto resolved to {runs['ring/auto']['overlap']}; "
             f"choose_overlap on the H100 preset prices pipelined")
    clear_plan_cache()
    torch.cuda.empty_cache()
    nccl = check_dist_nccl(ref)
    return {"runs": runs, "k1_bf16_f32": k1_recs, "nccl": nccl,
            "launches_bf16_f32": launches_bf16_f32}


def check_dist_nccl(ref) -> dict:
    """Phase 13's fresh process: ``chip_smoke.py --dist-nccl`` (a
    world-size-1 NCCL group, the plan at P = 1 on a ProcessGroupMesh
    against LocalMesh((1,)) bit for bit); its logits against phase 4's in
    the f32 band."""
    import torch
    out_dir = ROOT / "build" / "dist"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", NCCL_IB_DISABLE="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--dist-nccl", str(out_dir)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith("[nccl]"):
            print(line, flush=True)
    if proc.returncode != 0:
        fail(f"--dist-nccl exited {proc.returncode}:\n{proc.stdout[-2000:]}"
             f"\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in res["cases"]:
        if name == "train":
            continue
        got = torch.load(out_dir / f"{name}.pt").cuda()
        err, tol = max_err(got, ref)
        res["cases"][name].update(max_abs_err_phase4=err, tol=tol)
        print(f"[dist] nccl P=1 {name}: ProcessGroupMesh bit for bit "
              f"LocalMesh((1,)); vs phase 4 max_abs_err={err:.3e} "
              f"tol={tol:.3e}", flush=True)
        if err > tol:
            fail(f"nccl P=1 {name}: logits off phase 4's by {err:.3e}")
    res["wall_s"] = wall
    print(f"[dist] the NCCL process took {wall:.1f} s", flush=True)
    return res


def nccl_train_step(m, g, x, y, pgm, local) -> dict:
    """Phase 14 in the NCCL process: one SGD step of the ring/none plan at
    P = 1 on the ProcessGroupMesh -- the loss, each gradient (summed over
    the world of one by NCCL's all-reduce) and the int8 error-feedback
    all-reduce's output and residual -- bit for bit a LocalMesh((1,))
    step's; K1's backward launches as the partition implies."""
    import torch
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.optim.compression import (init_residuals,
                                               make_compressed_allreduce)
    names = [n for n, _ in m.named_parameters()]
    params = [p for _, p in m.named_parameters()]
    res = []
    for mesh in (pgm, local):
        plan = m.plan_for(g, mesh=mesh, strategy="ring", overlap="none")
        loss = m.loss_fn(g, x, y, plan=plan)
        reset_launch_counts()
        mesh.reset_counts()
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        k1b = launch_counts()["seg_agg_bwd"]
        tree = dict(zip(names, grads))
        out, resid = make_compressed_allreduce(mesh, "data")(
            tree, init_residuals(tree))
        res.append((loss, grads, out, resid, k1b, mesh.collective_bytes(),
                    dist_expected_k1_bwd(plan)))
    (lp, gp, op, rp, kp, bp, want), (ll, gl, ol, rl, kl, _, _) = res
    # compiled under autograd: the forward and backward graphs capture the
    # assemble's all-gather and the replicated parameters' all-reduce
    # (the forward phase compiled this plan without a gradient already)
    fn = m.plan_for(g, mesh=pgm, strategy="ring", overlap="none").compile()
    traces0, k1b0 = fn.num_traces, fn.capture_launches.get("seg_agg_bwd", 0)
    comp = []
    for _ in range(3):
        lc = nll(fn(m.tree(), x), y)
        gc = torch.autograd.grad(lc, params)
        comp.append(bool(torch.equal(lc, lp)) and all(
            torch.equal(a, b) for a, b in zip(gc, gp)))
    traces = fn.num_traces - traces0
    k1b = fn.capture_launches["seg_agg_bwd"] - k1b0
    print(f"[nccl] train ring-none compiled: captures {traces}; loss and "
          f"gradients bit for bit eager {comp}; captured K1 backward {k1b}",
          flush=True)
    if not all(comp) or traces != 1 or k1b != want:
        fail(f"nccl compiled train step: bitwise {comp}, {traces} "
             f"captures, K1 backward {k1b} against {want}")
    same = bool(torch.equal(lp, ll)) and all(
        torch.equal(a, b) for a, b in zip(gp, gl)) and all(
        torch.equal(op[n], ol[n]) and torch.equal(rp[n], rl[n])
        for n in names)
    psum = sum(p.numel() * 4 for p in params)
    print(f"[nccl] train ring-none: loss {lp.item():.6f}; K1 backward {kp} "
          f"launches; the backward counted {bp['total']} B (an all-reduce of "
          f"the {psum} B of gradients, then the int8 wire's); gradients and "
          f"the int8 error-feedback all-reduce bit for bit LocalMesh((1,)) "
          f"{same}", flush=True)
    if not same or kp != kl or kp != want:
        fail(f"nccl train step: bitwise={same}, K1 backward {kp} / {kl} "
             f"against {want}")
    return {"bitwise_local": same, "loss": lp.item(), "k1_bwd": kp,
            "counted_backward": bp, "compiled_bitwise": all(comp)}


def dist_nccl(out_dir: str) -> None:
    """``chip_smoke.py --dist-nccl DIR``: a world-size-1 NCCL group from a
    FileStore (no network), phase 4's gcn on Reddit through a
    ProcessGroupMesh((1,)) plan per NCCL_CASES, each bit for bit a
    LocalMesh((1,)) plan's and its counted bytes as scheduled (plus the
    logits' gather at egress).  Saves each PG plan's logits to DIR and
    prints one JSON line last."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.distributed import LocalMesh, ProcessGroupMesh
    from repro_torch.graph.datasets import load_dataset
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.gcn import make_paper_model
    torch.backends.cuda.matmul.allow_tf32 = False
    store = Path(out_dir) / "store"
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    init_s = time.perf_counter() - t0
    g, x, y, spec = load_dataset("reddit", seed=SEED, device="cuda")
    m = make_paper_model("gcn", spec, backend="auto", device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    pgm = ProcessGroupMesh((1,), ("data",), device="cuda")
    local = LocalMesh((1,), ("data",), device="cuda")
    cases = {}
    for strategy, overlap in NCCL_CASES:
        name = f"{strategy}-{overlap}"
        plan = m.plan_for(g, mesh=pgm, strategy=strategy, overlap=overlap)
        reset_launch_counts()
        pgm.reset_counts()
        with torch.inference_mode():
            out = m(g, x, plan=plan)
            torch.cuda.synchronize()
            k1n = launch_counts()["seg_agg"]
            counted = pgm.collective_bytes()["total"]
            want = m(g, x, plan=m.plan_for(g, mesh=local, strategy=strategy,
                                           overlap=overlap))
        egress = out.numel() * out.element_size()
        sched = sum(dist_wire(plan)) + egress
        same = torch.equal(out, want)
        print(f"[nccl] {name}: K1 {k1n} launches, counted {counted} B = "
              f"schedule + egress {sched}; bit for bit LocalMesh((1,)) "
              f"{same}", flush=True)
        if not same or counted != sched or k1n != dist_expected_k1(plan):
            fail(f"nccl {name}: bitwise={same}, counted {counted} against "
                 f"{sched}, K1 {k1n} against {dist_expected_k1(plan)}")
        # compiled: the graph captures the assemble's NCCL all-gather
        fn = plan.compile()
        with torch.inference_mode():
            reps = [torch.equal(fn(m.tree(), x), out) for _ in range(3)]
        cap = fn.capture_collectives.get("total")
        print(f"[nccl] {name} compiled: captures {fn.num_traces}, replays "
              f"{fn.num_replays}, bit for bit eager {reps}; captured K1 "
              f"{fn.capture_launches['seg_agg']}, collectives {cap} B = "
              f"{sched}", flush=True)
        if not all(reps) or fn.num_traces != 1 or cap != sched or \
                fn.capture_launches["seg_agg"] != k1n:
            fail(f"nccl {name} compiled: replays {reps}, {fn.num_traces} "
                 f"captures, collectives {cap} against {sched}")
        torch.save(out.cpu(), Path(out_dir) / f"{name}.pt")
        cases[name] = {"bitwise_local": same, "counted": counted,
                       "k1_launches": k1n, "compiled_bitwise": all(reps),
                       "capture_bytes": cap}
    cases["train"] = nccl_train_step(m, g, x, y, pgm, local)
    dist.destroy_process_group()
    print(json.dumps({"backend": "nccl", "world_size": 1, "init_s": init_s,
                      "cases": cases}))


def dist_expected_k1_bwd(plan) -> int:
    """K1 launches of one backward of a distributed plan: for each layer
    and held shard, its owner's P transposed sub-layouts (one a hop on the
    ring, all P after the all-gather), each the pieces' launch and, where
    a row was cut, the fold-back's."""
    node_ax = plan.axes[0] if plan.partition_kind == "2d" else plan.axis
    tl = plan.shard_transposed()
    return plan.num_layers * sum(
        1 + (lay.fold is not None) for c in plan.mesh.coords
        for lay in tl[plan.mesh.index(c, node_ax)])


#: the caps phase 14 builds the 16 capped transposed sub-layouts at, K1's
#: backward over each timed beside TRANSPOSE_CAP's
CAP_SWEEP = (1024, 2048, 4096)

#: PR 23's capped layouts of phase 14's 16 ring sub-layouts, every block
#: row stored and every row folded back (PERF.md section 6, PR 23 run 4):
#: slots in pieces and in fold-backs, and K1 launches a layer's backward
PR23_LAYOUT = {"piece_slots": 13415424, "fold_slots": 1699968,
               "launches": 32}


def transposed_slots(plan) -> dict:
    """The halos' backward layouts of a plan (its held owners' capped
    transposed sub-layouts, built here on first need and timed): their
    slots, the cut rows with their scratch rows and fold-backs, the rows
    stored in place (empty ones, and those over T, which one fold unit
    folds whole), beside what the uncapped ones would hold -- counted from
    the partition, never built: each (shard p, owner o) sub-layout's
    blocks of ``tile`` source rows times its longest block's edges rounded
    up to 8."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import TRANSPOSE_CAP, shard_tile
    from repro_torch.kernels import seg_agg as k1
    t0 = time.perf_counter()
    tl = plan.shard_transposed()
    build_s = time.perf_counter() - t0
    pg = plan._node_partition
    block, nsh = pg.block_size, pg.num_shards
    tile = shard_tile(block)
    nblocks = -(-block // tile)
    uncapped = 0
    for p in range(nsh):
        src, _ = pg.shard_edges(p)
        for o in range(nsh):
            cnt = np.bincount((src[src // block == o] - o * block) // tile,
                              minlength=nblocks)
            uncapped += nblocks * max(8, -(-int(cnt.max()) // 8) * 8)
    lays = [lay for per in tl.values() for lay in per]
    folds = [lay.fold for lay in lays if lay.fold is not None]
    pieces = sum(lay.nblocks * lay.emax for lay in lays)
    fold_slots = sum(f.nblocks * f.emax for f in folds)
    edges = int(pg.mask.sum().item())
    # the rows the pieces' launch stores in place: those over T are folded
    # whole by one fold unit (a cut row's pieces may be split)
    whole_over_t = longest_whole = empty = unused = 0
    for lay in lays:
        m = lay.mask != 0
        brow = (torch.arange(lay.nblocks, device=m.device)[:, None]
                * lay.tile_m + lay.dstl)[m].long()
        lens = torch.bincount(brow, minlength=lay.nblocks * lay.tile_m)
        dest = lay.out_rows.reshape(-1)
        whole = (dest >= 0) & (dest < lay.num_vertices)
        whole_over_t += int((whole & (lens > k1.split_threshold(lay.emax)))
                            .sum().item())
        longest_whole = max(longest_whole, int(lens[whole].max().item()))
        empty += int((whole & (lens == 0)).sum().item())
        unused += int((dest < 0).sum().item())
    return {"layouts": len(lays), "edges": edges, "build_s": build_s,
            "slots": pieces + fold_slots, "piece_slots": pieces,
            "fold_slots": fold_slots, "uncapped_slots": uncapped,
            "bytes_12": 12 * (pieces + fold_slots),
            "uncapped_bytes_12": 12 * uncapped,
            "cap": TRANSPOSE_CAP, "blocks": sum(lay.nblocks for lay in lays),
            "max_emax": max(lay.emax for lay in lays),
            "with_fold_back": len(folds),
            "cut_rows": sum(int((f.out_rows >= 0).sum().item())
                            for f in folds),
            "scratch_rows": sum(f.num_vertices for f in folds),
            "max_fold_emax": max((f.emax for f in folds), default=0),
            "empty_rows": empty, "unused_block_rows": unused,
            "whole_rows_over_t": whole_over_t,
            "longest_whole_row": longest_whole, "pr23": PR23_LAYOUT}


def packed_fold(g, t, width: int, blocks_first: bool):
    """``fold_transposed``'s launches over the capped layout ``t`` at
    another slice width and CTA order (phase 14's sweep; uncounted): the
    same sums, bit for bit, as neither changes what a fold unit adds."""
    import torch
    from repro_torch.kernels import seg_agg as k1
    n, fb = t.num_vertices, t.fold
    out = torch.empty((n + (0 if fb is None else fb.num_vertices),
                       g.shape[1]), dtype=torch.float32, device=g.device)
    k1._launch(g, t.src, t.dstl, t.mask, None, t.tile_m, width,
               blocks_first=blocks_first, out_dtype=torch.float32, out=out,
               out_rows=t.out_rows, split_from=n,
               split=k1.packed_split(t.emax, t.tile_m))
    if fb is not None:
        k1._launch(out[n:], fb.src, fb.dstl, fb.mask, None, fb.tile_m,
                   width, blocks_first=blocks_first, out=out,
                   out_rows=fb.out_rows, split_from=n,
                   split=k1.packed_split(fb.emax, fb.tile_m))
    return out


def check_k1_bwd_shards(plan, f: int) -> dict:
    """Phase 14's kernel check: K1's backward over each of the plan's 16
    capped transposed ring sub-layouts (shard p, owner o) -- the pieces'
    launch and, where a row was cut, the fold-back's -- over a random f32
    gradient slab of p's rows at width ``f``, against its plain version
    (the same folds and row maps in plain PyTorch) per row; two launches
    bit for bit; one launch a sub-layout, or two with a cut row.  Summed
    over the 16 (one layer's backward sums): kernel ms, plain ms,
    torch.sparse.mm over each transposed CSR matrix, and the bound over
    the edges' src, dstl and mask, the gradient rows they read and the
    rows written.  Then the sweep of ``packed_launch``'s settings: slices
    of 64 columns and of ``PACKED_SLICE``, in each CTA order, over the 16
    on the device alone, bit for bit the launches' sums; and the 16 built
    at each cap of ``CAP_SWEEP``, timed alike."""
    import numpy as np
    import torch
    from repro_torch.core.dataflow import _transposed
    from repro_torch.core.distributed import TRANSPOSE_CAP, shard_tile
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import seg_agg as k1
    pg = plan._node_partition
    block, nsh = pg.block_size, pg.num_shards
    tl = plan.shard_transposed()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "ops": 0}
    err = row = lib_err = top = 0.0
    same, n_launch, want_launch, slabs, adjs = True, 0, 0, {}, {}
    sub_edges = {}
    for p in range(nsh):
        src, dstl = pg.shard_edges(p)
        g = slabs[p] = torch.randn((block, f), generator=gen, device="cuda")
        for o in range(nsh):
            t = tl[o][p]
            kern = lambda: k1.fold_transposed(g, t)  # noqa: E731
            plain = lambda: kops.seg_agg_transposed(  # noqa: E731
                t, g, backend="torch")
            before = k1.seg_agg.launches_bwd
            got = kern()[:block]
            n_launch += k1.seg_agg.launches_bwd - before
            want_launch += 1 + (t.fold is not None)
            want = plain()
            torch.cuda.synchronize()
            diff = (got - want).abs().amax(-1)
            mag = want.abs().amax(-1)
            if not bool((diff <= K1_BWD_ROW_LIMIT * mag).all().item()):
                fail(f"K1 backward over transposed sub-layout ({p}, {o}) "
                     f"F={f}: a row off the plain version by "
                     f"{(diff / mag.clamp(min=1e-30)).max().item():.3e}")
            err = max(err, diff.max().item())
            row = max(row, (diff / mag.clamp(min=1e-30)).max().item())
            top = max(top, mag.max().item())
            same = same and torch.equal(got, kern()[:block])
            sel = src // block == o
            s_loc = (src[sel] - o * block).astype(np.int64)
            d_loc = dstl[sel].astype(np.int64)
            sub_edges[p, o] = (s_loc, d_loc)
            order = np.argsort(s_loc, kind="stable")
            crow = np.zeros(block + 1, np.int64)
            np.cumsum(np.bincount(s_loc, minlength=block), out=crow[1:])
            adj_t = adjs[p, o] = torch.sparse_csr_tensor(
                torch.from_numpy(crow).cuda(),
                torch.from_numpy(d_loc[order]).cuda(),
                torch.ones(len(s_loc), device="cuda"), size=(block, block))
            lib_err = max(lib_err, (torch.sparse.mm(adj_t, g) - want)
                          .abs().max().item())
            tot["library_ms"] += time_ms(lambda: torch.sparse.mm(adj_t, g),
                                         5)
            tot["ms"] += time_ms(kern, 5)
            tot["plain_ms"] += time_ms(plain, 1)
            e = len(s_loc)
            tot["bytes"] += (len(np.unique(d_loc)) * f + block * f
                             + 3 * e) * 4
            tot["ops"] += e * f
            del adj_t, got, want
    if not same or n_launch != want_launch:
        fail(f"K1 backward over the sub-layouts F={f}: repeat equal {same}, "
             f"{n_launch} launches for {nsh * nsh} sub-layouts (expected "
             f"{want_launch}: the pieces, and a fold-back where a row was "
             f"cut)")
    # the same launches (and 16 library calls) on the device alone:
    # captured in one CUDA graph, replayed
    pairs = [(p, o) for p in range(nsh) for o in range(nsh)]
    device_ms = replay_ms(lambda: [k1.fold_transposed(slabs[p], tl[o][p])
                                   for p, o in pairs], reps=2, rounds=3)
    library_device_ms = replay_ms(lambda: [torch.sparse.mm(adjs[p, o],
                                                           slabs[p])
                                           for p, o in pairs], reps=2,
                                  rounds=3)
    # the sweep: slices of 64 columns and of PACKED_SLICE, each in both CTA
    # orders; every setting's sums bit for bit the launches'
    chosen = k1.packed_launch(f, 4, 16)
    sweep = []
    for width in sorted({min(f, 64), min(f, k1.PACKED_SLICE)}):
        for blocks_first in (True, False):
            sums_equal = all(torch.equal(
                packed_fold(slabs[p], tl[o][p], width, blocks_first),
                k1.fold_transposed(slabs[p], tl[o][p])) for p, o in pairs)
            ms = replay_ms(lambda: [packed_fold(slabs[p], tl[o][p], width,
                                                blocks_first)
                                    for p, o in pairs], reps=2, rounds=3)
            sweep.append({"slice_cols": width, "blocks_first": blocks_first,
                          "device_ms": ms, "sums_equal": sums_equal,
                          "chosen": (width, blocks_first) == chosen})
            if not sums_equal:
                fail(f"K1 backward over the sub-layouts F={f}: slices of "
                     f"{width} columns, blocks_first={blocks_first}, "
                     f"changed the sums")
    # the caps: the 16 sub-layouts built at each (as
    # shard_transposed_layouts builds them at TRANSPOSE_CAP), K1's backward
    # over them on the device alone
    caps = []
    for cap in CAP_SWEEP:
        lays = {(p, o): tl[o][p] if cap == TRANSPOSE_CAP else _transposed(
            s, d, np.arange(len(s)), block, shard_tile(block), "cuda", cap)
            for (p, o), (s, d) in sub_edges.items()}
        caps.append({"cap": cap, "slots": sum(
            t.nblocks * t.emax for t in lays.values()),
            "device_ms": replay_ms(lambda: [k1.fold_transposed(
                slabs[p], lays[p, o]) for p, o in pairs], reps=2,
                rounds=3)})
        del lays
    del slabs, adjs
    b_ms, b_by = bound(tot["bytes"], tot["ops"])
    tol = F32_BAND * SCALE * max(1.0, top)
    rec = {"name": "seg_agg_bwd_shards", "graph": "reddit", "f_in": f,
           "f_out": f, "layouts": nsh * nsh, "launches_checked": n_launch,
           "max_abs_err": err, "row_rel_err": row, "repeat_equal": same,
           "library_max_abs_err": lib_err, "library_tol": tol,
           "ms": tot["ms"],
           "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
           "library": "torch.sparse.mm, each sub-layout's transposed CSR",
           "device_ms": device_ms, "library_device_ms": library_device_ms,
           "bytes": tot["bytes"], "ops": tot["ops"], "bound_ms": b_ms,
           "bound_by": b_by, "sweep": sweep, "caps": caps}
    rec.update(ratios(rec))
    print(f"[dist-train] K1 backward over the {nsh * nsh} capped transposed "
          f"ring sub-layouts F={f}: max_abs_err={err:.3e} row_rel_err="
          f"{row:.3e} (limit {K1_BWD_ROW_LIMIT:.0e}); repeat_equal={same}; "
          f"{n_launch} launches over {nsh * nsh} sub-layouts (the pieces, "
          f"{n_launch - nsh * nsh} fold-backs); ms={tot['ms']:.4f} "
          f"plain_ms={tot['plain_ms']:.4f} library_ms="
          f"{tot['library_ms']:.4f} (torch.sparse.mm, max_abs_err "
          f"{lib_err:.3e}, tol {tol:.3e}) bound_ms={b_ms:.4f} ({b_by}; "
          f"{tot['bytes']} B) "
          f"frac_of_bound={rec['frac_of_bound']:.4f} vs_library="
          f"{rec['vs_library']:.3f}; on the device alone (CUDA-graph "
          f"replays) {device_ms:.4f} against torch.sparse.mm's "
          f"{library_device_ms:.4f}; sweep (slice columns, blocks first: "
          f"device ms): " + ", ".join(
              f"({r['slice_cols']}, {r['blocks_first']}: "
              f"{r['device_ms']:.4f}{' chosen' if r['chosen'] else ''})"
              for r in sweep) + "; caps (slots: device ms): " + ", ".join(
              f"{r['cap']} ({r['slots']}: {r['device_ms']:.4f})"
              for r in caps), flush=True)
    if lib_err > tol:
        fail(f"torch.sparse.mm off the plain version by {lib_err:.3e}")
    return rec


def gcn_f64_grads(g, x, y, params) -> tuple:
    """The yardstick of phase 14's gradients: phase 4's gcn (two
    combine-first GCN layers, mean over the in-neighbours and the vertex,
    the bias after, ReLU between) and its mean NLL in plain PyTorch in
    float64 on this card, apart from the port -- (loss, each parameter's
    gradient in ``params`` order).  The neighbour sums run in chunks of
    edges through ``index_add_``; at f64 their atomics' order is far
    below the f32 errors measured against it."""
    import torch
    f64 = torch.float64
    leaves = [p.detach().to(f64).requires_grad_() for p in params]
    src, dst = g.src.long(), g.dst.long()
    rdeg = 1.0 / (g.in_deg.to(f64) + 1.0)[:, None]
    step = 1 << 21
    h = x.to(f64)
    for i in range(0, len(leaves), 2):
        hw = h @ leaves[i]
        agg = torch.zeros_like(hw)
        for e in range(0, len(src), step):
            agg = agg.index_add(0, dst[e:e + step], hw[src[e:e + step]])
        h = (agg + hw) * rdeg + leaves[i + 1]
        if i + 2 < len(leaves):
            h = torch.relu(h)
    loss = -torch.log_softmax(h, -1).gather(-1, y.long()[:, None]).mean()
    return loss.item(), torch.autograd.grad(loss, leaves)


def drive_dist_train(g, x, y, spec) -> dict:
    """Phase 14: phase 4's gcn trained on full-width Reddit through
    distributed plans on LocalMeshes of this card (DIST_TRAIN_CASES), then
    K1's backward over the 16 capped transposed sub-layouts against its
    plain version (see the module docstring)."""
    import torch
    from repro_torch.core.characterize import collective_bytes
    from repro_torch.core.distributed import LocalMesh
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.gcn import make_paper_model
    from repro_torch.optim.compression import (init_residuals,
                                               make_compressed_allreduce)
    from torch.profiler import ProfilerActivity, profile

    m = make_paper_model("gcn", spec, backend="auto", device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    names = [n for n, _ in m.named_parameters()]
    params = [p for _, p in m.named_parameters()]
    init = [p.detach().clone() for p in params]
    # the yardsticks: for f32 the model's gradients in float64 apart from
    # the port (GRAD_F32_LIMITS); for bf16 the torch tier's autograd of the
    # same mesh plan on this card (the plain versions) -- a bf16 gradient
    # sums terms that cancel, so where its forward rounds moves it by a
    # large part of its size (the local bf16 plan's is off the f64 one by
    # several times a leaf's largest magnitude).  Each run also prints the
    # torch tier's own distance from the f64 gradients
    ref64 = gcn_f64_grads(g, x, y, params)
    meshes = {(4,): LocalMesh((4,), ("data",)),
              (4, 2): LocalMesh((4, 2), ("node", "feat"))}
    runs, keep, layouts, k1_recs, bwd_launches = {}, {}, None, [], None
    for label, shape, strategy, overlap, dtype, ef in DIST_TRAIN_CASES:
        mesh = meshes[shape]
        with torch.no_grad():
            for p, v in zip(params, init):
                p.copy_(v)
        plan = m.plan_for(g, mesh=mesh, strategy=strategy, overlap=overlap,
                          dtype=dtype)
        node_ax = plan.axes[0] if plan.partition_kind == "2d" else plan.axis
        lay = transposed_slots(plan)
        if layouts is None and shape == (4,):
            layouts = lay
            print(f"[dist-train] the {lay['layouts']} capped transposed "
                  f"sub-layouts: {lay['slots']} slots ({lay['piece_slots']} "
                  f"pieces + {lay['fold_slots']} fold-back; "
                  f"{lay['slots'] / lay['edges']:.3f}x the {lay['edges']} "
                  f"edges; PR 23's {PR23_LAYOUT['piece_slots']} + "
                  f"{PR23_LAYOUT['fold_slots']}), {lay['bytes_12']} B at 12 "
                  f"B a slot, {lay['blocks']} blocks, emax at most "
                  f"{lay['max_emax']}; {lay['cut_rows']} cut rows in "
                  f"{lay['scratch_rows']} scratch rows, fold-backs in "
                  f"{lay['with_fold_back']} of {lay['layouts']} (emax at "
                  f"most {lay['max_fold_emax']}); stored in place: "
                  f"{lay['empty_rows']} empty rows, "
                  f"{lay['whole_rows_over_t']} rows over T (the longest "
                  f"{lay['longest_whole_row']} slots); "
                  f"{lay['unused_block_rows']} block rows unused; built in "
                  f"{lay['build_s']:.1f} s; uncapped they would "
                  f"hold {lay['uncapped_slots']} slots "
                  f"({lay['uncapped_slots'] / lay['edges']:.1f}x, "
                  f"{lay['uncapped_bytes_12']} B)", flush=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        mesh.reset_counts()
        loss = m.loss_fn(g, x, y, plan=plan)
        torch.cuda.synchronize()
        fwd_c, fwd_b = launch_counts(), collective_bytes(mesh)
        reset_launch_counts()
        mesh.reset_counts()
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        bwd_c, bwd_b = launch_counts(), collective_bytes(mesh)
        peak = torch.cuda.max_memory_allocated() - base
        want_f, want_b = dist_expected_k1(plan), dist_expected_k1_bwd(plan)
        got = (fwd_c["seg_agg"], bwd_c["seg_agg"], bwd_c["seg_agg_bwd"],
               fwd_c["fused_agg_combine"] + bwd_c["fused_agg_combine"])
        if got != (want_f, want_b, want_b, 0):
            fail(f"{label}: K1 launches (forward, backward, counted "
                 f"backward, K2) {got}, expected "
                 f"{(want_f, want_b, want_b, 0)}")
        if dtype == "bf16" and (fwd_c["seg_agg_bf16_f32"],
                                bwd_c["seg_agg_bf16_f32"]) != \
                (want_f, want_b // 2):
            fail(f"{label}: bf16->f32 launches {fwd_c['seg_agg_bf16_f32']} / "
                 f"{bwd_c['seg_agg_bf16_f32']}")
        run_bwd = bwd_c["seg_agg_bwd"]
        # the backward's wire: the halo's bytes as the forward's; on the
        # 2-D mesh one (block, fb_out) all-gather a layer for the
        # psum_scatter
        pgn = plan._node_partition
        rs_adj = sum(pgn.block_size * plan.partition.feature_block(lp.dout)
                     * 4 for lp in plan.layers) \
            if plan.partition_kind == "2d" else 0
        wire = dist_wire(plan)
        if fwd_b["total"] != sum(wire) or \
                bwd_b["collective-permute"] != fwd_b["collective-permute"] \
                or bwd_b["all-gather"] != fwd_b["all-gather"] + rs_adj or \
                bwd_b["reduce-scatter"] or bwd_b["all-reduce"]:
            fail(f"{label}: counted forward {fwd_b} / backward {bwd_b} "
                 f"against the schedule {wire}")
        tloss = m.loss_fn(g, x, y, plan=m.plan_for(
            g, mesh=mesh, strategy=strategy, overlap=overlap, dtype=dtype,
            backend="torch"))
        tier = (tloss.item(), torch.autograd.grad(tloss, params))
        del tloss
        if dtype == "bf16":
            (ref_loss, ref_g), band, yard = tier, BF16_BAND, "torch tier"
        else:
            (ref_loss, ref_g), band, yard = ref64, None, "f64"
        leaf_err = {}
        for n, a, b, t, r in zip(names, grads, ref_g, tier[1], ref64[1]):
            top = b.abs().max().item()
            e = (a.double() - b.double()).abs().max().item() / top
            lim = GRAD_F32_LIMITS[n.split(".")[0]] if band is None \
                else band
            leaf_err[n] = {"rel_err": e, "limit": lim,
                           "torch_tier_vs_f64": (t.double() - r).abs().max()
                           .item() / r.abs().max().item(),
                           "vs_f64": (a.double() - r).abs().max().item()
                           / r.abs().max().item()}
            if not (e <= lim and bool(torch.isfinite(a).all().item())):
                fail(f"{label}: gradient {n} off the {yard} one by {e:.3e} "
                     f"of its largest magnitude (limit {lim:.0e})")
        if abs(loss.item() - ref_loss) > F32_BAND * SCALE * max(
                1.0, abs(ref_loss)):
            fail(f"{label}: loss {loss.item()} against the {yard}'s "
                 f"{ref_loss}")
        bitwise = None
        if label in ("ring/none",):
            keep[label] = grads
        elif label == "ring/pipelined":
            bitwise = all(torch.equal(a, b) for a, b in
                          zip(grads, keep.pop("ring/none")))
            if not bitwise:
                fail("ring/pipelined: step 0's gradients not bit for bit "
                     "the single-buffered ring's")
        print(f"[dist-train] {label:20s} step 0: loss {loss.item():.7f} "
              f"({yard} {ref_loss:.7f}); K1 forward {got[0]} / backward "
              f"{got[1]} launches (pieces, and fold-backs of cut rows); "
              f"backward counted "
              f"{bwd_b['total']} B a shard (forward {fwd_b['total']}); "
              f"gradients vs the {yard} ones over each leaf's largest "
              f"magnitude (limit): "
              + ", ".join(f"{n} {v['rel_err']:.2e} ({v['limit']:.0e})"
                          for n, v in leaf_err.items())
              + "; vs f64: this run "
              + ", ".join(f"{v['vs_f64']:.2e}" for v in leaf_err.values())
              + ", the torch tier's "
              + ", ".join(f"{v['torch_tier_vs_f64']:.2e}"
                          for v in leaf_err.values())
              + ("" if bitwise is None else
                 f"; bit for bit ring/none: {bitwise}")
              + f"; peak {peak / 2**30:.3f} GiB above the inputs",
              flush=True)
        # the rest of the run: SGD (through the int8 error-feedback
        # all-reduce when ef), timed, then profiled
        allreduce = make_compressed_allreduce(mesh, node_ax) if ef else None
        residuals = init_residuals(dict(zip(names, params)))

        def update(gr):
            nonlocal residuals
            if allreduce is not None:
                tree, residuals = allreduce(dict(zip(names, gr)), residuals)
                gr = [tree[n] for n in names]
            with torch.no_grad():
                for p, d in zip(params, gr):
                    p.sub_(DIST_TRAIN_LR * d)

        update(grads)
        del grads
        losses, times, prof = [loss.item()], [], None
        for i in range(1, DIST_TRAIN_STEPS):
            if i == DIST_TRAIN_STEPS - DIST_TRAIN_PROFILED:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                window = time.perf_counter()
            c0 = launch_counts()
            t0 = time.perf_counter()
            loss = m.loss_fn(g, x, y, plan=plan)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            c1 = launch_counts()
            gr = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            c2 = launch_counts()
            update(gr)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            losses.append(loss.item())
            run_bwd += c2["seg_agg_bwd"] - c1["seg_agg_bwd"]
            if (c1["seg_agg"] - c0["seg_agg"], c2["seg_agg"] - c1["seg_agg"],
                    c2["seg_agg_bwd"] - c1["seg_agg_bwd"]) != \
                    (want_f, want_b, want_b):
                fail(f"{label} step {i}: K1 launches off the partition's")
            if not (losses[-1] == losses[-1] and abs(losses[-1]) < 1e30):
                fail(f"{label} step {i}: loss {losses[-1]} is not finite")
            if i <= DIST_TRAIN_TIMED:
                times.append(((t3 - t0) * 1e3, (t1 - t0) * 1e3,
                              (t2 - t1) * 1e3))
            del gr
        wall = (time.perf_counter() - window) * 1e3
        prof.__exit__(None, None, None)
        win = dist_window("dist_train_" + label.replace("/", "_")
                          .replace(" ", "_"), prof, wall,
                          DIST_TRAIN_PROFILED)
        step_ms = sorted(t[0] for t in times)[len(times) // 2]
        bwd_share = sum(t[2] for t in times) / sum(t[0] for t in times)
        runs[label] = {
            "mesh": list(shape), "strategy": strategy,
            "overlap": plan.overlap, "dtype": dtype, "int8_ef": ef,
            "losses": losses, "k1_forward": got[0], "k1_backward": got[1],
            "counted_forward": fwd_b, "counted_backward": bwd_b,
            "wire_per_layer": wire, "grad_err": leaf_err,

            "bitwise_none": bitwise, "peak_bytes": peak,
            "step_ms": step_ms, "steps_ms": times, "backward_share":
            bwd_share, "transposed_build_s": lay["build_s"],
            "profiled": win}
        print(f"[dist-train] {label:20s} losses "
              f"{['%.5f' % v for v in losses]}"
              + (" (int8 error-feedback all-reduce)" if ef else "")
              + f"; step {step_ms:.3f} ms on the host clock (median of "
              f"{len(times)}; forward "
              f"{sorted(t[1] for t in times)[len(times) // 2]:.3f}, "
              f"backward {sorted(t[2] for t in times)[len(times) // 2]:.3f}"
              f", backward share {bwd_share:.3f}); profiled "
              f"{DIST_TRAIN_PROFILED} steps: wall {win['wall_ms']:.3f} ms, "
              f"device busy {win['device_busy_ms']:.3f} (K1 "
              f"{win['k1_ms']:.3f}, copies {win['copy_ms']:.3f}, a copy "
              f"beside a kernel {win['copy_beside_kernel_ms']:.3f}), "
              f"{win['kernels']:.0f} kernels a step, idle "
              f"{win['idle_share']:.3f}", flush=True)
        if label == "ring/none":
            bwd_launches = run_bwd
            k1_recs = [check_k1_bwd_shards(plan, f) for f in (128, 41)]
        del plan, loss
        torch.cuda.empty_cache()
    with torch.no_grad():
        for p, v in zip(params, init):
            p.copy_(v)
    return {"runs": runs, "layouts": layouts, "k1_bwd_shards": k1_recs,
            "bwd_launches": bwd_launches}


def dist_compiled_forward(m, g, x, mesh, label, shape, strategy, overlap,
                          dtype) -> dict:
    """Phase 15, one forward case: see ``drive_dist_compiled``."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from torch.profiler import ProfilerActivity, profile
    plan = m.plan_for(g, mesh=mesh, strategy=strategy, overlap=overlap,
                      dtype=dtype)
    params = m.tree()
    with torch.inference_mode():
        eager = m(g, x, plan=plan)
    fn = plan.compile()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        first = fn(params, x)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        c0, b0 = launch_counts(), mesh.collective_bytes()["total"]
        same = [torch.equal(first, eager)]
        same += [torch.equal(fn(params, x), eager)
                 for _ in range(DIST_COMPILED_CALLS - 1)]
        torch.cuda.synchronize()
        traces, replays = fn.num_traces, fn.num_replays
    moved = {k: n - c0[k] for k, n in launch_counts().items() if n != c0[k]}
    moved_bytes = mesh.collective_bytes()["total"] - b0
    peak = torch.cuda.max_memory_allocated() - base
    # what the graph keeps: its pool and its static buffers
    resident = torch.cuda.memory_allocated() - base - \
        first.numel() * first.element_size()
    captured = fn.capture_launches
    coll = fn.capture_collectives
    want_k1, wire = dist_expected_k1(plan), dist_wire(plan)
    want = {"seg_agg": want_k1,
            "seg_agg_bf16_f32": want_k1 if dtype == "bf16" else 0,
            "seg_agg_bwd": 0, "fused_agg_combine": 0}
    got = {k: captured.get(k, 0) for k in want}
    with torch.inference_mode():
        eager_ms = sorted(time_ms(lambda: m(g, x, plan=plan), DIST_REPS)
                          for _ in range(DIST_ROUNDS))
        graph_ms = sorted(time_ms(lambda: fn(params, x), DIST_REPS)
                          for _ in range(DIST_ROUNDS))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(DIST_PROFILED):
                fn(params, x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        win = dist_window("dist_compiled_" + label.replace("/", "_")
                          .replace(" ", "_"), prof, wall, DIST_PROFILED)
        layers_equal, h = [], plan._ingress(x)
        for i in range(plan.num_layers):
            sub = params[f"conv{i}"]
            want_h = plan.run_layer(sub, h, layer=i)
            fl = plan.compile(layer=i)
            layers_equal.append(all(torch.equal(fl(sub, h), want_h)
                                    for _ in range(2)))
            h = torch.relu(want_h)
    em, gm = eager_ms[DIST_ROUNDS // 2], graph_ms[DIST_ROUNDS // 2]
    rec = {"mesh": list(shape), "strategy": strategy,
           "overlap": plan.overlap, "dtype": dtype, "eager_ms": em,
           "graph_ms": gm, "eager_ms_rounds": eager_ms,
           "graph_ms_rounds": graph_ms, "capture_s": capture_s,
           "num_traces": traces, "num_replays": replays,
           "capture_launches": got, "capture_bytes": coll.get("total"),
           "wire_per_layer": wire, "replays_equal": all(same),
           "layers_equal": layers_equal, "peak_bytes": peak,
           "graph_resident_bytes": resident, "profiled": win}
    print(f"[dist-compiled] {label:20s} captures {traces}, replays "
          f"{replays} (capture {capture_s:.2f} s); every replay bit "
          f"for bit eager {all(same)}; layers {layers_equal}; captured K1 "
          f"{got['seg_agg']} (bf16->f32 {got['seg_agg_bf16_f32']}) = "
          f"{want_k1}; captured collectives {coll.get('total')} B a shard "
          f"= schedule {sum(wire)}, replays moved counters {moved} and "
          f"{moved_bytes} B; forward eager {em:.3f} ms, compiled {gm:.3f} "
          f"({em / gm:.2f}x; rounds {['%.3f' % t for t in graph_ms]}); "
          f"profiled {DIST_PROFILED} replays: wall {win['wall_ms']:.3f} ms, "
          f"device busy {win['device_busy_ms']:.3f} (K1 {win['k1_ms']:.3f},"
          f" copies {win['copy_ms']:.3f}), {win['kernels']:.0f} kernels a "
          f"forward, idle {win['idle_share']:.3f}; peak {peak / 2**30:.3f} "
          f"GiB above the inputs, the graph keeps {resident / 2**30:.3f} "
          f"GiB", flush=True)
    if not (all(same) and all(layers_equal)) or \
            (traces, replays) != (1, DIST_COMPILED_CALLS - 1):
        fail(f"dist-compiled {label}: replays bit for bit {same}, layers "
             f"{layers_equal}, {traces} captures, {replays} replays")
    if got != want or coll.get("total") != sum(wire) or moved or \
            moved_bytes:
        fail(f"dist-compiled {label}: captured launches {got} against "
             f"{want}, collectives {coll} against the schedule {wire}; "
             f"replays moved {moved} and {moved_bytes} B")
    return rec


def dist_compiled_train(m, g, x, y, mesh, label, shape, strategy, overlap,
                        dtype, ef, init) -> dict:
    """Phase 15, one training case: see ``drive_dist_compiled``."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.optim.compression import (init_residuals,
                                               make_compressed_allreduce)
    from torch.profiler import ProfilerActivity, profile
    names = [n for n, _ in m.named_parameters()]
    params = [p for _, p in m.named_parameters()]
    with torch.no_grad():
        for p, v in zip(params, init):
            p.copy_(v)
    plan = m.plan_for(g, mesh=mesh, strategy=strategy, overlap=overlap,
                      dtype=dtype)
    node_ax = plan.axes[0] if plan.partition_kind == "2d" else plan.axis
    # the forward cases compiled some of these plans without a gradient
    fn = plan.compile()
    traces0, replays0 = fn.num_traces, fn.num_replays
    launches0, coll0 = dict(fn.capture_launches), fn.capture_collectives
    allreduce = make_compressed_allreduce(mesh, node_ax) if ef else None
    residuals = init_residuals(dict(zip(names, params)))

    def update(gr):
        nonlocal residuals
        if allreduce is not None:
            tree, residuals = allreduce(dict(zip(names, gr)), residuals)
            gr = [tree[n] for n in names]
        with torch.no_grad():
            for p, d in zip(params, gr):
                p.sub_(DIST_TRAIN_LR * d)

    def eager_step():
        gr = torch.autograd.grad(m.loss_fn(g, x, y, plan=plan), params)
        update(gr)

    def compiled_step():
        gr = torch.autograd.grad(nll(fn(m.tree(), x), y), params)
        update(gr)

    losses, same, moved, moved_bytes = [], [], {}, 0
    for step in range(DIST_TRAIN_STEPS):
        want_loss = m.loss_fn(g, x, y, plan=plan)
        want = torch.autograd.grad(want_loss, params)
        torch.cuda.synchronize()
        if step == 0:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        c0, b0 = launch_counts(), mesh.collective_bytes()["total"]
        t0 = time.perf_counter()
        loss = nll(fn(m.tree(), x), y)
        got = torch.autograd.grad(loss, params)
        if step == 0:
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
        else:           # a replay's forward and backward move no counter
            for k, n in launch_counts().items():
                if n != c0[k]:
                    moved[k] = moved.get(k, 0) + n - c0[k]
            moved_bytes += mesh.collective_bytes()["total"] - b0
        same.append(bool(torch.equal(loss, want_loss)) and all(
            torch.equal(a, b) for a, b in zip(got, want)))
        losses.append(loss.item())
        update(got)
        del want, got
    captured = {k: fn.capture_launches.get(k, 0) - launches0.get(k, 0)
                for k in ("seg_agg", "seg_agg_bwd")}
    cap_bytes = fn.capture_collectives.get("total", 0) - \
        coll0.get("total", 0)
    traces, replays = fn.num_traces - traces0, fn.num_replays - replays0
    want_f, want_b = dist_expected_k1(plan), dist_expected_k1_bwd(plan)
    got_k1 = (captured.get("seg_agg", 0) - captured.get("seg_agg_bwd", 0),
              captured.get("seg_agg_bwd", 0))
    timed = {}
    for name, step_fn in (("eager", eager_step), ("compiled", compiled_step),
                          ("compiled", compiled_step),
                          ("eager", eager_step)):
        for _ in range(DIST_TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn()
            torch.cuda.synchronize()
            timed.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(DIST_TRAIN_PROFILED):
            compiled_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    win = dist_window("dist_compiled_train_" + label.replace("/", "_")
                      .replace(" ", "_"), prof, wall, DIST_TRAIN_PROFILED)
    med = {k: sorted(v)[len(v) // 2] for k, v in timed.items()}
    rec = {"mesh": list(shape), "strategy": strategy,
           "overlap": plan.overlap, "dtype": dtype, "int8_ef": ef,
           "losses": losses, "steps_equal": same,
           "num_traces": traces, "num_replays": replays,
           "capture_k1": got_k1, "capture_bytes": cap_bytes,
           "capture_s": capture_s,
           "eager_step_ms": med["eager"], "graph_step_ms": med["compiled"],
           "steps_ms": timed, "peak_bytes": peak, "profiled": win}
    print(f"[dist-compiled] train {label:20s} losses "
          f"{['%.5f' % v for v in losses]}"
          + (" (int8 error-feedback all-reduce)" if ef else "")
          + f"; every step's loss and gradients bit for bit eager {same}; "
          f"captures {traces}, replays {replays} (capture "
          f"{capture_s:.2f} s); captured K1 forward {got_k1[0]} = {want_f}, "
          f"backward {got_k1[1]} = {want_b}; captured collectives "
          f"{cap_bytes} B a shard; step on the host"
          f" clock eager {med['eager']:.3f} ms, compiled "
          f"{med['compiled']:.3f} ({med['eager'] / med['compiled']:.2f}x); "
          f"profiled {DIST_TRAIN_PROFILED} compiled steps: wall "
          f"{win['wall_ms']:.3f} ms, device busy {win['device_busy_ms']:.3f}"
          f" (K1 {win['k1_ms']:.3f}), {win['kernels']:.0f} kernels a step, "
          f"idle {win['idle_share']:.3f}; peak {peak / 2**30:.3f} GiB above "
          f"the inputs", flush=True)
    if not all(same) or (traces, replays) != (1, DIST_TRAIN_STEPS - 1):
        fail(f"dist-compiled train {label}: steps bit for bit {same}, "
             f"{traces} captures, {replays} replays")
    if got_k1 != (want_f, want_b) or moved or moved_bytes:
        fail(f"dist-compiled train {label}: captured K1 {got_k1} against "
             f"{(want_f, want_b)}; replays moved {moved} and {moved_bytes} "
             f"B")
    return rec


def drive_dist_compiled(g, x, y, spec) -> dict:
    """Phase 15: plan.compile() of phase 13's and phase 14's distributed
    plans (DIST_CASES, DIST_TRAIN_CASES) on LocalMeshes of this card, over
    the layouts phases 13 and 14 built.  A forward case fails unless one
    capture serves DIST_COMPILED_CALLS calls, every replay equal to the
    eager forward bit for bit, the graph records K1's launches as the
    partition implies and the mesh counted, while capturing, the bytes
    schedule_wire_bytes prices a forward (a replay moves no counter), and
    compile(layer=i) equals run_layer.  A training case fails unless each
    of DIST_TRAIN_STEPS SGD steps through the compiled forward and
    backward (int8 error feedback where the case has it) gives the loss
    and every gradient leaf of an eager step on the same parameters bit
    for bit, and the backward graph records K1's backward launches.
    Times (compiled against eager), device busy and idle share over a
    profiled window, peak memory."""
    import torch
    from repro_torch.core.distributed import LocalMesh
    from repro_torch.models.gcn import make_paper_model
    m = make_paper_model("gcn", spec, backend="auto", device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    init = [p.detach().clone() for p in m.parameters()]
    meshes = {(4,): LocalMesh((4,), ("data",)),
              (4, 2): LocalMesh((4, 2), ("node", "feat"))}
    forward, train = {}, {}
    for label, shape, strategy, overlap, dtype in DIST_CASES:
        forward[label] = dist_compiled_forward(
            m, g, x, meshes[shape], label, shape, strategy, overlap, dtype)
        torch.cuda.empty_cache()
    for label, shape, strategy, overlap, dtype, ef in DIST_TRAIN_CASES:
        train[label] = dist_compiled_train(
            m, g, x, y, meshes[shape], label, shape, strategy, overlap,
            dtype, ef, init)
        torch.cuda.empty_cache()
    return {"forward": forward, "train": train}


def analysis_cells(g, x, spec):
    """Phase 16's plans, built on the Reddit graph of the earlier phases:
    yields ``(case, plan, params, lint_plan kwargs, donation)``, where
    ``donation`` asks for a captured ``compile(donate=True)`` checked bit
    for bit against the eager forward.  Phase 4's gcn/sage/gin unfused and
    fused in f32; phase 10's decisions (DECISION_CASES) for each of them;
    the dynamic plan of phase 12's gcn/A smallest bucket over its runtime
    layout; phase 13's mesh plans (DIST_CASES).  The plans are built one
    case at a time, their layouts shared through the plan caches."""
    import torch
    from repro_torch.core.distributed import LocalMesh
    from repro_torch.models.gcn import PAPER_MODELS, make_paper_model
    from repro_torch.serve import GraphServeEngine, default_buckets

    def model(name, fused=False):
        return make_paper_model(
            name, spec, backend="auto", device="cuda", fused=fused,
            generator=torch.Generator().manual_seed(SEED))

    for name in ("gcn", "sage", "gin"):
        for fused in (False, True):
            m = model(name, fused)
            key = f"{name} {'fused' if fused else 'unfused'}"
            yield key, m.plan_for(g), m.tree(), {}, name == "gcn"
            for case, kw, fused_only in DECISION_CASES:
                if fused_only and not fused:
                    continue
                yield f"{key} {case}", m.plan_for(g, **kw), m.tree(), {}, \
                    False
    # phase 12's gcn under mix A: its smallest bucket's plan, dynamic over
    # the runtime layout of the bucket's template
    fanouts, _ = SERVE_MIXES["A"]
    eng = GraphServeEngine(
        g.to("cpu"), PAPER_MODELS["gcn"], None, x, spec.num_classes,
        fanouts=fanouts, buckets=default_buckets(
            fanouts, seed_levels=(4, 16, 64), max_inputs=spec.num_vertices),
        max_batch=8, seed=SEED, device=x.device)
    eng.params = eng.init_params(torch.Generator().manual_seed(SEED))
    b = eng.buckets[0]
    plan, _ = eng._bucket_plan(b)
    t = plan.g
    layout = eng._layout(plan, b, t.src.cpu().numpy(), t.dst.cpu().numpy())
    yield f"serve gcn/A bucket {tuple(b)}", plan, eng.params, {
        "dynamic": True, "dynamic_args": (t, layout, None),
        "x": torch.zeros((b.num_inputs, eng.in_dim), device=x.device)}, \
        False
    del eng
    m = model("gcn")
    meshes = {(4,): LocalMesh((4,), ("data",)),
              (4, 2): LocalMesh((4, 2), ("node", "feat"))}
    for label, shape, strategy, overlap, dtype in DIST_CASES:
        yield f"dist {label}", m.plan_for(
            g, mesh=meshes[shape], strategy=strategy, overlap=overlap,
            dtype=dtype), m.tree(), {}, overlap == "pipelined" and \
            dtype == "f32"


def drive_analysis(g, x, spec) -> dict:
    """Phase 16: ``repro_torch.analysis`` on the card.  Its self-test (every
    rule catches its plant, the pragmas suppress), its matrix on the cuda
    device (both tiers; the donation cells captured), then the full-width
    Reddit plans of ``analysis_cells``: each linted from fake-tensor traces
    of its eager and compiled forwards (K1 and K2 opaque nodes) with the
    launch counts zeroed just before and read just after -- every count
    must stay 0 -- and no error finding; a mesh plan's bytes counted
    across the trace equal schedule_wire_bytes, and so do those its
    capture counted where phase 15's capture is still cached.  The
    donation cases then capture compile(donate=True) and compile(): two
    replays of the first in the graph's static output, of the second in
    fresh storage, the replay bit for bit the eager forward, K1 (K2 when
    fused) launched, the capture's collective bytes as scheduled.
    Nothing is caught: a failed rule fails the phase."""
    import torch
    from repro_torch.analysis import run_matrix
    from repro_torch.analysis.selftest import run_selftest
    from repro_torch.analysis.trace_lint import (donation_replays,
                                                 lint_plan, plan_label)
    from repro_torch.core.plan import clear_plan_cache
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    detected, _ = run_selftest()
    missed = sorted(r for r, ok in detected.items() if not ok)
    print(f"[analysis] selftest: {len(detected) - len(missed)} of "
          f"{len(detected)} rules caught their plants", flush=True)
    if missed:
        fail(f"analysis: rules missed their plants: {missed}")
    report, small = run_matrix("cuda")
    counts = report.counts()
    print(f"[analysis] matrix on the card: {small} cells, {counts}",
          flush=True)
    if not report.ok(strict=True):
        fail("analysis: the matrix on the card has errors:\n"
             + report.render())
    cells, traced, out = 0, 0, {"selftest": detected, "matrix": counts}
    totals = dict(counts)
    for case, plan, params, kw, donation in analysis_cells(g, x, spec):
        t1 = time.perf_counter()
        reset_launch_counts()
        rep = lint_plan(plan, params=params, x=kw.pop("x", x), **kw)
        torch.cuda.synchronize()
        moved = sum(launch_counts().values())
        traced += moved
        cells += 1
        for sev, n in rep.counts().items():
            totals[sev] += n
        print(f"[analysis] {case:34s} {plan_label(plan)}: "
              f"{rep.counts()}, launches across the traces {moved}, "
              f"{time.perf_counter() - t1:.2f} s", flush=True)
        if moved or not rep.ok(strict=True):
            fail(f"analysis {case}: {moved} launches across its traces, "
                 f"findings:\n{rep.render()}")
        if donation:
            reset_launch_counts()
            rep = lint_plan(plan, params=params, x=x, donate=True)
            launched = launch_counts()
            with torch.inference_mode():
                eager = plan.run_model(params, x)
            replay, _, _ = donation_replays(plan, params, x, True)
            same = torch.equal(replay, eager)
            kern = "fused_agg_combine" if plan.layers[0].fused \
                else "seg_agg"
            coll = plan.compile(donate=True).capture_collectives
            print(f"[analysis] {case:34s} donation: {rep.counts()}, "
                  f"replay bit for bit eager {same}, launches "
                  f"{ {k: n for k, n in launched.items() if n} }"
                  + (f", captured bytes {coll['total']} (checked against "
                     f"schedule_wire_bytes)" if coll else ""), flush=True)
            if not rep.ok(strict=True) or not same or not launched[kern]:
                fail(f"analysis {case}: donation findings:\n"
                     f"{rep.render()}\nreplay equal eager {same}, "
                     f"launches {launched}")
            out[case] = {"donation": rep.counts(), "bitwise": same}
            del eager, replay
        del plan
    clear_plan_cache()
    torch.cuda.empty_cache()
    took = time.perf_counter() - t0
    print(f"[analysis] cells={cells} errors={totals['error']} "
          f"warnings={totals['warning']} info={totals['info']} "
          f"traced_launches={traced} took {took:.1f} s", flush=True)
    if totals["error"] or traced:
        fail("analysis: errors or traced launches")
    out.update(cells=cells, totals=totals, traced_launches=traced,
               seconds=took)
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


def flash_library(shape, q, k, v, want, tol, gqa: bool = False):
    """(milliseconds, note) of one PyTorch call computing the same function
    as K5 at ``shape`` -- held against the plain version's ``want`` within
    ``tol`` -- or (None, reason).  A yardstick: the port never calls
    these.  ``gqa``: scaled_dot_product_attention reads the KV heads itself
    (``enable_gqa=True``) instead of K/V expanded beforehand."""
    import torch
    import torch.nn.functional as F
    b, hq, hkv, sq, sk, d, causal, window, cap, kv_len = shape

    def timed(fn, note):
        err = (fn().float() - want.float()).abs().max().item()
        if not err <= tol:
            return None, f"none: {note} differs from the plain version by " \
                f"{err:.3e}"
        return time_ms(fn, 5), f"{note}, max_abs_err {err:.3e}"

    # SDPA aligns a causal mask top-left, K5 right: the same function when
    # Sq = Sk or without the mask
    if kv_len is None and (sq == sk or not causal) and cap == 0 \
            and window == 0:
        if gqa:
            return timed(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True),
                "scaled_dot_product_attention, enable_gqa=True")
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


def check_flash(names=None, gqa: bool = False):
    """Phase 5: K5 against its plain version at FLASH_SHAPES (or the shapes
    ``names`` of it: phase 20 checks its (l) so), f32 and bf16.  Fails
    unless every launch meets the band and the per-row and Frobenius
    limits, the drop-tile control (and in f32 the one-TF32-product control)
    fails both limits, and a second launch equals the first bit for bit.
    ``gqa`` goes to ``flash_library``.  Returns one record per (shape,
    dtype)."""
    import torch
    from repro_torch.kernels import flash_attention as k5

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = []
    for name in names or FLASH_SHAPES:
        shape = FLASH_SHAPES[name]
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
            # the row logsumexp the backward needs: out bit for bit the
            # same, lse against the plain version's
            out_l, lse_k = k5.flash_attention(q, k, v, kvl, return_lse=True,
                                              **kw)
            lse_p = k5.flash_attention_plain(q, k, v, kvl, return_lse=True,
                                             **kw)[1]
            torch.cuda.synchronize()
            lse_same = torch.equal(out_l, out_k)
            seen = lse_p > -1e29
            lse_err = (lse_k - lse_p)[seen].abs().max().item() \
                if bool(seen.any()) else 0.0
            lse_masked = bool((lse_k[~seen] <= -1e29).all())
            del out_l, lse_k, lse_p, seen
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
            lib_ms, lib_note = flash_library(shape, q, k, v, out_p, tol,
                                             gqa)
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
                   "out_equal_with_lse": lse_same, "lse_err": lse_err,
                   "lse_masked_rows_ok": lse_masked,
                   "ms": ms, "plain_ms": time_ms(plain, 2),
                   "pairs": pairs, "bytes": nbytes, "ops": ops,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms, "library": lib_note,
                   "tflops": ops / ms / 1e9}
            if dtype == torch.float32:
                rec["bound_f32fma_ms"] = bound(nbytes, ops, F32_FLOPS)[0]
            rec.update(ratios(rec))
            if name == "a":
                # what storing the row logsumexp costs
                rec["ms_lse"] = time_ms(lambda: k5.flash_attention(
                    q, k, v, kvl, return_lse=True, **kw), 5)
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
                     if "ms_one_tf32" in rec else "")
                  + (f" ms_lse={rec['ms_lse']:.4f}" if "ms_lse" in rec
                     else "")
                  + f" out_equal_with_lse={lse_same} lse_err={lse_err:.3e}"
                  f" (limit {LSE_LIMIT[dname]:.0e}) lse_masked_rows_ok="
                  f"{lse_masked}", flush=True)
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
            if not (lse_same and lse_masked and lse_err <= LSE_LIMIT[dname]):
                fail(f"flash_attention ({name}) {dtype}: with the lse, out "
                     f"equal {lse_same}, lse off the plain version's by "
                     f"{lse_err:.3e} (limit {LSE_LIMIT[dname]:.0e}), masked "
                     f"rows {lse_masked}")
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


def timed_engine():
    """A ``ServeEngine`` subclass that records per request the prefill's
    last-position logits, the logits its last token was sampled from, its
    prefill time and the time to first token, and per step the decode time
    and any K5 launch (phases 6, 20 and 21)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.serve.engine import ServeEngine

    class TimedEngine(ServeEngine):

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.first_logits, self.prefill_ms, self.ttft_ms = {}, {}, {}
            self.last_logits = {}
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
            self.last_logits[req.rid] = np.array(logits, np.float32)
            return super()._sample(logits, req)

        def _step(self):
            n, t0 = k5.flash_attention.launches, time.perf_counter()
            done = super()._step()                  # ends in a host copy
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.decode_launches += k5.flash_attention.launches - n
            return done

    return TimedEngine


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
    from repro_torch.serve.engine import Request

    TimedEngine = timed_engine()
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


def bwd_rel_errs(got, want) -> tuple[float, float]:
    """(largest per-row error over the row's largest magnitude floored at
    BWD_ROW_FLOOR of the tensor's, relative Frobenius error), each the
    largest over the gradients in ``got`` against ``want``."""
    import torch
    row = fro = 0.0
    for a, b in zip(got, want):
        a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
        diff = (a - b).abs().amax(-1)
        mag = b.abs().amax(-1).clamp_min(
            BWD_ROW_FLOOR * b.abs().max().item()).clamp_min(1e-30)
        row = max(row, (diff / mag).max().item())
        fro = max(fro, ((a - b).norm() / b.norm().clamp_min(1e-30)).item())
    return row, fro


def bwd_control(shape, q, k, v, dout):
    """A control that is wrong on purpose: K5's gradients computed densely
    one head at a time in f32, without the softcap's Jacobian where there
    is a softcap, else without the KV tile of 64 keys that holds the middle
    key of the shortest sequence (as ``drop_tile_control``).
    ``bwd_rel_errs`` must see it above BWD_ROW_LIMIT and BWD_FRO_LIMIT."""
    import torch
    b, hq, hkv, sq, sk, d, causal, window, cap, kv_len = shape
    g = hq // hkv
    lens = kv_len or (sk,) * b
    t0 = min(lens) // 2 // 64 * 64
    kpos = torch.arange(sk, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for bi, n in enumerate(lens):
        qpos = (n - sq + torch.arange(sq, device=q.device))[:, None]
        keep = (kpos < n).expand(sq, sk)
        if cap == 0:
            keep = keep & ((kpos < t0) | (kpos >= t0 + 64))
        if causal:
            keep = keep & (kpos <= qpos)
        if window > 0:
            keep = keep & (kpos > qpos - window)
        for h in range(hq):
            kh, vh = k[bi, h // g].float(), v[bi, h // g].float()
            qs = (q[bi, h] * d ** -0.5).float()
            s = qs @ kh.T
            if cap > 0:
                s = cap * torch.tanh(s / cap)
            p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
            p = p.nan_to_num(0.0)
            do = dout[bi, h].float()
            dp = do @ vh.T
            ds = p * (dp - (dp * p).sum(-1, keepdim=True))
            dq[bi, h] = ds @ kh * d ** -0.5
            dk[bi, h // g] += ds.T @ qs
            dv[bi, h // g] += p.T @ do
    return dq, dk, dv


def bwd_library(shape, q, k, v, dout, want, tol):
    """(milliseconds, note) of one PyTorch backward computing K5's
    gradients at ``shape`` -- flex_attention's (compiled, tanh score_mod,
    causal / window block mask) where there is a softcap,
    scaled_dot_product_attention's without one -- held against the plain
    version's ``want`` within ``tol`` of each gradient's largest
    magnitude, or (None, reason).  The backward's time is a forward with
    its backward less the forward alone (a compiled backward may donate
    its buffers, so one graph cannot be run twice).  A yardstick: the
    port never calls these."""
    import torch
    import torch.nn.functional as F
    b, hq, hkv, sq, sk, d, causal, window, cap, kv_len = shape
    if kv_len is not None or (sq != sk and (causal or cap or window)):
        return None, "none: no PyTorch call computes this shape's function"
    g = hq // hkv
    try:
        if cap == 0 and window == 0:
            ke = k.repeat_interleave(g, dim=1).requires_grad_()
            ve = v.repeat_interleave(g, dim=1).requires_grad_()
            qe = q.detach().clone().requires_grad_()

            def fwd():
                return F.scaled_dot_product_attention(qe, ke, ve,
                                                      is_causal=causal)
            note = "scaled_dot_product_attention backward, K/V expanded"

            def fold(gr):   # the expanded K/V's gradients summed per group
                return gr[0], gr[1].unflatten(1, (hkv, g)).sum(2), \
                    gr[2].unflatten(1, (hkv, g)).sum(2)
        elif causal:
            from torch.nn.attention.flex_attention import (
                create_block_mask, flex_attention)

            def score_mod(score, bi, hi, qi, ki):
                return cap * torch.tanh(score / cap)

            def mask_mod(bi, hi, qi, ki):
                m = ki <= qi
                return m & (ki > qi - window) if window > 0 else m

            block_mask = create_block_mask(mask_mod, None, None, sq, sk,
                                           device=q.device)
            qe, ke, ve = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            flex = torch.compile(flex_attention)

            def fwd():
                return flex(qe, ke, ve, score_mod=score_mod,
                            block_mask=block_mask, enable_gqa=True)
            note = "flex_attention backward (torch.compile), tanh " \
                "score_mod, block mask"
            fold = tuple
        else:
            return None, "none: no PyTorch call computes this shape's " \
                "function"
        args = (qe, ke, ve)
        got = fold(torch.autograd.grad(fwd(), args, dout))
        errs = [(a.float() - w.float()).abs().max().item() /
                max(w.float().abs().max().item(), 1e-30)
                for a, w in zip(got, want)]
        if max(errs) > tol:
            return None, f"none: {note} differs from the plain version " \
                f"by {max(errs):.3e} of a gradient's largest magnitude"
        both = time_ms(lambda: torch.autograd.grad(fwd(), args, dout), 3)
        ms = both - time_ms(fwd, 3)
        return ms, f"{note} (forward and backward {both:.4f} ms less the " \
            f"forward), error {max(errs):.3e}"
    except Exception as e:  # a yardstick only: K5's checks do not need it
        return None, f"none: the library call did not run ({type(e).__name__}" \
            f": {str(e).splitlines()[0][:160] if str(e) else ''})"


def check_flash_bwd(names=None):
    """Phase 18, first part: K5's backward kernels against
    ``flash_attention_bwd_plain`` at FLASH_BWD_SHAPES (or the shapes
    ``names`` of it: phase 22 checks its (o) so) in f32 and bf16, from
    K5's own forward (out and lse).  Fails unless every call is finite and
    within BWD_ROW_LIMIT / BWD_FRO_LIMIT, the control exceeds both (in f32
    also the kernels with one TF32 product, terms=1), and a second call
    equals the first bit for bit.  Returns one record per (shape,
    dtype)."""
    import torch
    from repro_torch.kernels import flash_attention as k5

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = []
    for name in names or FLASH_BWD_SHAPES:
        shape = FLASH_BWD_SHAPES[name]
        b, hq, hkv, sq, sk, d, causal, window, cap, kv_len = shape
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            q, k = ((torch.randn(shp, generator=gen, device="cuda")
                     * BWD_INPUT_SCALE).to(dtype)
                    for shp in ((b, hq, sq, d), (b, hkv, sk, d)))
            v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda",
                            dtype=dtype)
            dout = torch.randn((b, hq, sq, d), generator=gen, device="cuda",
                               dtype=dtype)
            kvl = None if kv_len is None else torch.tensor(
                kv_len, dtype=torch.int32, device="cuda")
            kw = dict(causal=causal, window=window, softcap=cap)
            with torch.no_grad():
                out, lse = k5.flash_attention(q, k, v, kvl, return_lse=True,
                                              **kw)
            kern = lambda: k5.flash_attention_bwd(  # noqa: E731
                q, k, v, out, lse, dout, kvl, **kw)
            plain = lambda: k5.flash_attention_bwd_plain(  # noqa: E731
                q, k, v, out, lse, dout, kvl, **kw)
            n0 = k5.flash_attention_bwd.launches
            got = kern()
            # f32: the yardstick is the plain version in f64 (BWD_ROW_LIMIT)
            want = plain() if dtype == torch.bfloat16 else \
                k5.flash_attention_bwd_plain(
                    *(t.double() for t in (q, k, v, out)), lse,
                    dout.double(), kvl, **kw)
            torch.cuda.synchronize()
            launched = k5.flash_attention_bwd.launches - n0
            finite = all(bool(torch.isfinite(t).all().item()) for t in got)
            same = all(torch.equal(x, y) for x, y in zip(got, kern()))
            row, fro = bwd_rel_errs(got, want)
            c_row, c_fro = bwd_rel_errs(bwd_control(shape, q, k, v, dout),
                                        want)
            # f32: the kernels with one TF32 product instead of three, and
            # the plain version's own f32 evaluation against its f64 one
            t_row = t_fro = p_row = p_fro = None
            if dtype == torch.float32:
                t_row, t_fro = bwd_rel_errs(k5.flash_attention_bwd(
                    q, k, v, out, lse, dout, kvl, terms=1, **kw), want)
                p_row, p_fro = bwd_rel_errs(plain(), want)
            err = max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(got, want))
            del got
            elt = q.element_size()
            pairs = unmasked_pairs(sq, sk, causal, window,
                                   kv_len or (sk,) * b)
            # five products of 2 Sq Sk D over the unmasked pairs: dP, dV,
            # dQ, dK and the recomputed S (the kernels form S and dP in both
            # passes: seven)
            ops = 10 * d * hq * pairs
            # read q, out, dout, k, v, lse, kv_len once; write dq, dk, dv
            nbytes = 4 * (q.numel() + k.numel()) * elt + 4 * b * hq * sq \
                + 4 * b
            peak = TF32X3_FLOPS if dtype == torch.float32 else BF16_FLOPS
            b_ms, b_by = bound(nbytes, ops, peak)
            ms = time_ms(kern, 3)
            plain_ms = time_ms(plain, 1)
            if name in LIBRARY_BWD_SHAPES:
                lib_ms, lib_note = bwd_library(
                    shape, q, k, v, dout, want,
                    BF16_BAND if dtype == torch.bfloat16 else 1e-2)
            else:
                lib_ms, lib_note = None, "not timed at this shape"
            del want
            rec = {"name": "flash_attention_bwd", "shape": name,
                   "dtype": dname, "b": b, "hq": hq, "hkv": hkv, "sq": sq,
                   "sk": sk, "d": d, "causal": causal, "window": window,
                   "softcap": cap, "kv_len": kv_len, "max_abs_err": err,
                   "row_rel_err": row, "fro_rel_err": fro,
                   "control": "no softcap Jacobian" if cap > 0
                   else "a KV tile dropped",
                   "control_row_rel_err": c_row,
                   "control_fro_rel_err": c_fro,
                   "terms1_row_rel_err": t_row, "terms1_fro_rel_err": t_fro,
                   "plain_f32_row_rel_err": p_row,
                   "plain_f32_fro_rel_err": p_fro,
                   "repeat_equal": same,
                   "launches_a_call": launched, "ms": ms,
                   "plain_ms": plain_ms, "pairs": pairs, "bytes": nbytes,
                   "ops": ops, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_f32fma_ms": bound(nbytes, ops, F32_FLOPS)[0],
                   "library_ms": lib_ms, "library": lib_note,
                   "tflops": ops / ms / 1e9}
            rec.update(ratios(rec))
            records.append(rec)
            print(f"[lm-train] K5 backward ({name}) {dname:8s} B={b} Hq={hq}"
                  f" Hkv={hkv} Sq={sq} Sk={sk} D={d} causal={causal} "
                  f"window={window} cap={cap} kv_len={kv_len} "
                  f"max_abs_err={err:.3e} row_rel_err={row:.3e} "
                  f"fro_rel_err={fro:.3e} (limits "
                  f"{BWD_ROW_LIMIT[dname]:.0e}/{BWD_FRO_LIMIT[dname]:.0e}; "
                  f"control {rec['control']} {c_row:.3e}/{c_fro:.3e}"
                  + (f"; one TF32 product {t_row:.3e}/{t_fro:.3e}; the "
                     f"plain version in f32 {p_row:.3e}/{p_fro:.3e}"
                     if t_row is not None else "") + ") "
                  f"repeat_equal={same} launches={launched} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms} "
                  f"[{lib_note}] bound_ms={b_ms:.4f} ({b_by}; {nbytes} B, "
                  f"{ops} ops) bound_f32fma_ms={rec['bound_f32fma_ms']:.4f} "
                  f"achieved {rec['tflops']:.2f} TFLOP/s frac_of_bound="
                  f"{rec['frac_of_bound']:.4f} vs_library="
                  f"{rec['vs_library']}", flush=True)
            if not finite or launched != 2:
                fail(f"flash_attention_bwd ({name}) {dname}: finite={finite}"
                     f", {launched} launches (expected 2)")
            if row > BWD_ROW_LIMIT[dname] or fro > BWD_FRO_LIMIT[dname]:
                fail(f"flash_attention_bwd ({name}) {dname}: a row off by "
                     f"{row:.3e} or {fro:.3e} relative Frobenius error "
                     f"(limits {BWD_ROW_LIMIT[dname]:.0e}, "
                     f"{BWD_FRO_LIMIT[dname]:.0e})")
            if c_row <= BWD_ROW_LIMIT[dname] or \
                    c_fro <= BWD_FRO_LIMIT[dname]:
                fail(f"flash_attention_bwd ({name}) {dname}: the check "
                     f"cannot see the control ({rec['control']}: "
                     f"{c_row:.3e}, {c_fro:.3e})")
            if t_row is not None and (t_row <= BWD_ROW_LIMIT[dname] or
                                      t_fro <= BWD_FRO_LIMIT[dname]):
                fail(f"flash_attention_bwd ({name}) {dname}: the check "
                     f"cannot see one TF32 product instead of three "
                     f"({t_row:.3e}, {t_fro:.3e})")
            if not same:
                fail(f"flash_attention_bwd ({name}) {dname}: two calls on "
                     f"the same input differ")
            del q, k, v, dout, out, lse
            torch.cuda.empty_cache()
    return records


def k5_shares(name: str) -> dict:
    """K5's forward and backward kernels' device ms in the profiler trace
    ``chiprun_out/traces/<name>.json`` (written by ``kernel_window``)."""
    events = json.loads((ROOT / "chiprun_out" / "traces" /
                         f"{name}.json").read_text())
    events = events.get("traceEvents", events)
    kern = [e for e in events if e.get("cat") == "kernel"]

    def ms(names):
        return sum(e["dur"] for e in kern
                   if any(n in e.get("name", "") for n in names)) / 1e3
    return {"k5_fwd_ms": ms(K5_KERNELS), "k5_bwd_ms": ms(K5_BWD_KERNELS)}


def k5_zero() -> None:
    """K5's launch counters, forward and backward, in all and by shape,
    set to 0."""
    from repro_torch.kernels import flash_attention as k5
    for fn in (k5.flash_attention, k5.flash_attention_bwd):
        fn.launches = 0
        fn.by_shape.clear()


def k5_by_shape():
    """K5's launches since ``k5_zero`` by the wrapper's ``launch_key``: a
    Counter, the forward's under ("fwd",) + key, the backward's under
    ("bwd",) + key."""
    from collections import Counter

    from repro_torch.kernels import flash_attention as k5
    out = Counter()
    for part, fn in (("fwd", k5.flash_attention),
                     ("bwd", k5.flash_attention_bwd)):
        out.update({(part,) + key: n for key, n in fn.by_shape.items()})
    return out


def drive_lm_trainer(tcfg, tag: str, label: str, desc: str, loss_fn,
                     want: tuple, steps: int, batch: int, seq: int) -> dict:
    """Phases 18 and 19's training on the card through launch/train_lm.py's
    functions: ``tcfg`` in f32 at ``batch`` x ``seq`` TokenPipeline tokens
    (seed 0).  Step 0's loss and every gradient leaf against the torch tier
    from the same weights (``loss_fn(params, batch, attn_impl)``);
    ``steps`` steps of ``make_train_step`` under ``Trainer``; a profiled
    step; two steps of the config's own bf16, for K5's bf16 backward, the
    second timed and profiled with its own peak memory.  ``want`` is a
    step's K5 (forward, backward) launches, asserted at step 0, over the
    Trainer's steps and in the first bf16 step.  Prints as ``[label]``
    (``desc`` names the run), writes the traces ``<tag>`` and
    ``<tag>_bf16``.  Returns the measurements, ``by_shape`` the Trainer's
    and the first bf16 step's K5 launches (``k5_by_shape``)."""
    import dataclasses

    import torch
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.launch import train_lm

    ckpt = str(ROOT / "build" / tag)
    trainer = train_lm.make_trainer(
        tcfg, steps=steps, batch=batch, seq=seq, ckpt_dir=ckpt,
        device="cuda", log_every=1, checkpoint_every=0)
    tb = {k: torch.as_tensor(v, device="cuda")
          for k, v in trainer.pipeline.batch_at(0).items()}

    # -- step 0 against the torch tier, from the same weights
    state = trainer.make_state()
    leaves = {n: p.requires_grad_(True) for n, p in state.params.items()}
    torch.cuda.synchronize()
    k5_zero()
    t0 = time.perf_counter()
    loss_c, _ = loss_fn(leaves, tb, "auto")
    grads_c = torch.autograd.grad(loss_c, list(leaves.values()))
    torch.cuda.synchronize()
    step0_ms = (time.perf_counter() - t0) * 1e3
    launches0 = (k5.flash_attention.launches,
                 k5.flash_attention_bwd.launches)
    loss_t, _ = loss_fn(leaves, tb, "torch")
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    loss_err = abs(loss_c.item() - loss_t.item())
    loss_tol = F32_BAND * SCALE * max(1.0, abs(loss_t.item()))
    leaf_errs = {n: ((a - w).abs().max() / w.abs().max().clamp_min(1e-30))
                 .item() for n, a, w in zip(leaves, grads_c, grads_t)}
    worst = max(leaf_errs, key=leaf_errs.get)
    print(f"[{label}] {desc}: step 0 loss {loss_c.item():.6f} vs torch tier "
          f"{loss_t.item():.6f} (|diff| {loss_err:.3e}, tol {loss_tol:.3e});"
          f" worst gradient leaf {worst} {leaf_errs[worst]:.3e} of its "
          f"largest magnitude (limit {LM_TRAIN_GRAD_LIMIT:.0e}) over "
          f"{len(leaf_errs)} leaves; K5 launches forward {launches0[0]}, "
          f"backward {launches0[1]} (expected {want}); loss and gradients "
          f"{step0_ms:.1f} ms host", flush=True)
    if launches0 != want:
        fail(f"{label} step 0 launched K5 {launches0} times, expected "
             f"{want}")
    if not (loss_err <= loss_tol and
            leaf_errs[worst] <= LM_TRAIN_GRAD_LIMIT):
        fail(f"{label} step 0: loss off the torch tier by {loss_err:.3e} "
             f"or gradient leaf {worst} by {leaf_errs[worst]:.3e}")
    del state, leaves, grads_c, grads_t, loss_c, loss_t, tb
    torch.cuda.empty_cache()

    # -- steps through the Trainer
    events = []
    step_fn = trainer.step_fn

    def timed_step(st, bt):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = step_fn(st, bt)
        e1.record()
        events.append((e0, e1))
        return out
    trainer.step_fn = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5_zero()
    result = trainer.run()
    torch.cuda.synchronize()
    launches = (k5.flash_attention.launches, k5.flash_attention_bwd.launches)
    by_shape = k5_by_shape()
    peak = torch.cuda.max_memory_allocated()
    hist = result["history"]
    losses = [h["loss"] for h in hist]
    host_ms = [h["dt"] * 1e3 for h in hist]
    dev_ms = [a.elapsed_time(b) for a, b in events]
    for h, d_ms in zip(hist, dev_ms):
        print(f"[{label}] step {h['step']}: loss {h['loss']:.6f} "
              f"grad_norm {h['grad_norm']:.4f} lr {h['lr']:.3e}; host "
              f"{h['dt'] * 1e3:.1f} ms, CUDA events {d_ms:.1f} ms",
              flush=True)
    want_run = tuple(steps * n for n in want)
    print(f"[{label}] Trainer: {len(hist)} steps, K5 launches forward "
          f"{launches[0]}, backward {launches[1]} (expected {want_run}); "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    if launches != want_run:
        fail(f"{label}: the Trainer's steps launched K5 {launches} times, "
             f"expected {want_run}")
    if len(losses) != steps or not all(
            x == x and abs(x) < float("inf") for x in losses):
        fail(f"{label}: losses {losses} are not {steps} finite values")

    # -- one profiled step from the trained state
    holder = {"state": result["state"]}
    nxt = trainer.pipeline.batch_at(steps)

    def one():
        holder["state"] = step_fn(holder["state"], nxt)[0]
    prof = profiled(tag, 1, one)
    prof.update(k5_shares(tag))
    busy = prof["device_busy_ms"]
    if prof["idle_share"] is None:   # the trace holds no kernel
        print(f"[{label}] profiled step: the profiler saw no kernel; device"
              f" shares not measured", flush=True)
    else:
        print(f"[{label}] profiled f32 step: wall {prof['wall_ms']:.1f} ms, "
              f"device busy {busy:.1f} ms, idle share "
              f"{prof['idle_share']:.4f}, {prof['kernels']:.0f} kernels; K5 "
              f"forward {prof['k5_fwd_ms']:.2f} ms "
              f"({prof['k5_fwd_ms'] / busy:.2%} of busy), K5 backward "
              f"{prof['k5_bwd_ms']:.2f} ms ({prof['k5_bwd_ms'] / busy:.2%})",
              flush=True)
    del holder, result, trainer
    torch.cuda.empty_cache()

    # -- two steps in the config's own bf16, for K5's bf16 backward
    tr16 = train_lm.make_trainer(
        dataclasses.replace(tcfg, dtype="bfloat16"), steps=1, batch=batch,
        seq=seq, ckpt_dir=ckpt, device="cuda", checkpoint_every=0)
    h16 = {"state": tr16.make_state()}
    torch.cuda.synchronize()
    k5_zero()
    h16["state"], m16 = tr16.step_fn(h16["state"], tr16.pipeline.batch_at(0))
    torch.cuda.synchronize()
    launches16 = (k5.flash_attention.launches,
                  k5.flash_attention_bwd.launches)
    by_shape += k5_by_shape()
    loss16 = m16["loss"].item()
    # a second step, timed and profiled, with its own peak memory: the
    # first one built and warmed the kernels
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    b1 = tr16.pipeline.batch_at(1)

    def one16():
        e0.record()
        h16["state"], h16["m"] = tr16.step_fn(h16["state"], b1)
        e1.record()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof16 = profiled(tag + "_bf16", 1, one16)
    peak16 = torch.cuda.max_memory_allocated()
    prof16.update(k5_shares(tag + "_bf16"))
    host16, dev16 = prof16["wall_ms"], e0.elapsed_time(e1)
    loss16b = h16["m"]["loss"].item()
    busy16 = prof16["device_busy_ms"]
    print(f"[{label}] bf16 steps: losses {loss16:.6f} {loss16b:.6f}, K5 "
          f"launches forward {launches16[0]}, backward {launches16[1]} in "
          f"the first (expected {want}); the second (profiled) "
          f"{host16:.1f} ms host, CUDA events {dev16:.1f} ms, peak memory "
          f"{peak16 / 2**30:.2f} GiB (reset just before it)", flush=True)
    if prof16["idle_share"] is None:   # the trace holds no kernel
        print(f"[{label}] profiled bf16 step: the profiler saw no kernel; "
              f"device shares not measured", flush=True)
    else:
        print(f"[{label}] profiled bf16 step: device busy {busy16:.1f} ms, "
              f"idle share {prof16['idle_share']:.4f}, "
              f"{prof16['kernels']:.0f} kernels; K5 forward "
              f"{prof16['k5_fwd_ms']:.2f} ms "
              f"({prof16['k5_fwd_ms'] / busy16:.2%} of busy), K5 backward "
              f"{prof16['k5_bwd_ms']:.2f} ms "
              f"({prof16['k5_bwd_ms'] / busy16:.2%})", flush=True)
    if launches16 != want or not (loss16 == loss16 and loss16b == loss16b):
        fail(f"{label} bf16 step: K5 launches {launches16} (expected "
             f"{want}), losses {loss16} {loss16b}")
    del h16, tr16
    torch.cuda.empty_cache()
    return {"params": tcfg.param_count(), "batch": batch, "seq": seq,
            "step0_loss_err": loss_err, "step0_loss_tol": loss_tol,
            "step0_worst_leaf": worst,
            "step0_worst_leaf_err": leaf_errs[worst],
            "step0_launches": launches0, "step0_host_ms": step0_ms,
            "losses": losses, "host_ms": host_ms, "device_ms": dev_ms,
            "launches": launches, "peak_bytes": peak, "profile": prof,
            "bf16_launches": launches16, "bf16_losses": [loss16, loss16b],
            "bf16_step_host_ms": host16, "bf16_step_device_ms": dev16,
            "bf16_peak_bytes": peak16, "bf16_profile": prof16,
            "by_shape": by_shape}


def drive_lm_train():
    """Phase 18, second part: the LM training path on the card -- gemma2-9b
    at full width in f32, LM_TRAIN_LAYERS layers, batch LM_TRAIN_BATCH x
    LM_TRAIN_SEQ tokens, LM_TRAIN_STEPS Trainer steps, through
    ``drive_lm_trainer``; a step launches K5's forward once and its
    backward kernels twice a layer.  Returns the measurements."""
    from repro_torch.launch import train_lm
    from repro_torch.models.transformer import TransformerLM, lm_loss

    cfg = train_lm.make_config("gemma2-9b", width="full",
                               layers=LM_TRAIN_LAYERS)
    n_layers = cfg.num_layers
    skel = TransformerLM(cfg, device="meta")

    def loss_fn(params, bt, impl):
        return lm_loss(skel, bt["tokens"], bt["labels"], params=params,
                       attn_impl=impl)
    out = drive_lm_trainer(
        cfg, "lm_train", "lm-train",
        f"{cfg.name} f32 full width, {n_layers} layers, "
        f"{cfg.param_count() / 1e9:.3f} B params, batch {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ}", loss_fn, (n_layers, 2 * n_layers),
        LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    out["layers"] = n_layers
    # the kernels line takes this phase's K5 launches in all; by shape
    # (keys of tuples, not JSON) only phase 19 reads them
    del out["by_shape"]
    return out


def logits_close(got, want, vocab: int, label: str) -> dict:
    """Phase 6's hold of bf16 logits over the ``vocab`` real ids (a padded
    id's logit is -1e30, which would set the scale): max-abs within
    BF16_BAND of the largest magnitude and the relative Frobenius error
    within LOGIT_FRO_LIMIT, both finite.  Returns the numbers; fails
    outside."""
    import torch
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    err = (got - want).abs().max().item()
    tol = BF16_BAND * max(1.0, want.abs().max().item())
    fro = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    if not (bool(torch.isfinite(got).all().item()) and err <= tol
            and fro <= LOGIT_FRO_LIMIT):
        fail(f"{label}: off by {err:.3e} (tolerance {tol:.3e}) or {fro:.3e} "
             f"relative Frobenius error (limit {LOGIT_FRO_LIMIT:.0e})")
    return {"max_abs_err": err, "tol": tol, "fro_rel_err": fro}


def drive_encdec():
    """Phase 19: seamless-m4t-medium (the audio family's enc-dec stack) at
    full width and depth, random weights from a seeded generator, through
    launch/steps.py's entry points; K5 on every attention but a decode
    step's self-attention.  Serving in bf16, then f32 checks, then training
    in f32 and one bf16 step.  Returns the measurements, with the K5
    main-path segments' K5 launches by shape as the wrapper counted them
    (``by_shape``, "[bwd/]<dtype>/<shape name>" over FLASH_SHAPES and
    FLASH_BWD_SHAPES).  Fails if a segment launched K5 at a shape that
    phase 5 (forward) or 18 (backward) does not hold."""
    import dataclasses
    from collections import Counter

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.configs.seamless_m4t_medium import MAX_ENC_FRAMES
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.launch import steps, train_lm
    from repro_torch.models import encdec

    cfg = get_config("seamless-m4t-medium")
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    b, n_prompt, n_steps = ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_STEPS
    t0 = time.perf_counter()
    model = encdec.init_encdec(cfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[encdec] {cfg.name}: {n_enc} + {n_dec} layers, d_model "
          f"{cfg.d_model}, {cfg.attention.num_heads} heads of "
          f"{cfg.attention.head_dim}, {n_params} parameters in {cfg.dtype} "
          f"(param_count {cfg.param_count()}), made on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED)
    # the frames in the model's dtype, as the reference's input specs give
    # them; the pipeline's scale
    frames32 = torch.as_tensor(rng.standard_normal(
        (b, MAX_ENC_FRAMES, cfg.d_model)).astype(np.float32) * 0.02,
        device="cuda")
    frames = frames32.to(torch.bfloat16)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (b, n_prompt)), device="cuda")
    cache = n_prompt + n_steps
    prefill = steps.make_prefill_step(cfg, cache)
    decode = steps.make_decode_step(cfg)
    batch = {"frames": frames, "tokens": prompts}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    # K5 launches: a prefill one per encoder layer (g), per decoder
    # self-attention (k: causal, the prompt) and per cross-attention (h); a
    # decode step one per cross-attention (j)
    want_prefill, want_step = n_enc + 2 * n_dec, n_dec
    # the main path's launches by shape, each segment's read just after it
    measured = Counter()
    with torch.inference_mode():
        prefill(model, batch)                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k5_zero()
        ev[0].record()
        lg, caches, memory, length = prefill(model, batch)
        ev[1].record()
        torch.cuda.synchronize()
        prefill_launches = k5.flash_attention.launches
        measured += k5_by_shape()
        prefill_ms = ev[0].elapsed_time(ev[1])
        first = lg[:, -1]
        tok = first.argmax(-1)
        fed, step_ms, step_logits, step_launches = [], [], [], []
        for _ in range(n_steps):
            fed.append(tok)
            k5_zero()
            ev[0].record()
            lg, caches, length = decode(model, {
                "token": tok[:, None], "caches": caches, "memory": memory,
                "length": length})
            ev[1].record()
            torch.cuda.synchronize()
            step_launches.append(k5.flash_attention.launches)
            measured += k5_by_shape()
            step_ms.append(ev[0].elapsed_time(ev[1]))
            step_logits.append(lg[:, -1])
            tok = lg[:, -1].argmax(-1)
        peak = torch.cuda.max_memory_allocated()
        toks = torch.stack(fed, 1)
        # the decode consistency of the reference's serving test: each
        # step's logits against one decode_stack over prompt + fed tokens
        full, _ = encdec.decode_stack(model, torch.cat([prompts, toks], 1),
                                      memory)
        cons = logits_close(torch.stack([first] + step_logits, 1),
                            full[:, n_prompt - 1:], cfg.vocab_size,
                            "encdec decode consistency (bf16)")
        # the padded ids' logits stay masked
        masked = bool((full[..., cfg.vocab_size:] <= -1e29).all().item())
        del full
        # the cuda tier's prefill logits against the torch tier's
        k5_zero()
        ref = steps.make_prefill_step(cfg, cache, attn_impl="torch")(
            model, batch)[0][:, -1]
        torch_launches = k5.flash_attention.launches
        tier = logits_close(first, ref, cfg.vocab_size,
                            "encdec prefill vs torch tier")
        prof_prefill = profiled("encdec_prefill", 1, lambda: prefill(
            model, batch))
        prof_prefill.update(k5_shares("encdec_prefill"))
        prof_step = profiled("encdec_decode_step", 1, lambda: decode(
            model, {"token": tok[:, None], "caches": caches,
                    "memory": memory, "length": length - 1}))
        prof_step.update(k5_shares("encdec_decode_step"))
    dec_ms = sorted(step_ms)
    tps = b * n_steps / (sum(step_ms) / 1e3)
    wave_tps = b * (n_steps + 1) / ((prefill_ms + sum(step_ms)) / 1e3)
    print(f"[encdec] serve bf16: {b} requests x {MAX_ENC_FRAMES} frames, "
          f"{n_prompt}-token prompts: prefill {prefill_ms:.2f} ms (CUDA "
          f"events), {n_steps} greedy decode steps median "
          f"{dec_ms[n_steps // 2]:.3f} ms, mean "
          f"{sum(step_ms) / n_steps:.3f} ms; {tps:.1f} tokens/s decoding, "
          f"{wave_tps:.1f} tokens/s with the prefill; peak memory "
          f"{peak / 2**30:.2f} GiB; K5 launches prefill {prefill_launches} "
          f"(expected {n_enc} encoder + {n_dec} self + {n_dec} cross = "
          f"{want_prefill}), decode steps {sorted(set(step_launches))} "
          f"(expected {want_step} cross), torch tier {torch_launches}",
          flush=True)
    print(f"[encdec] prefill logits vs torch tier max_abs_err="
          f"{tier['max_abs_err']:.3e} tol={tier['tol']:.3e} fro_rel_err="
          f"{tier['fro_rel_err']:.3e} (limit {LOGIT_FRO_LIMIT:.0e}); decode "
          f"consistency (prefill's and {n_steps} steps' logits vs one "
          f"decode_stack) max_abs_err={cons['max_abs_err']:.3e} tol="
          f"{cons['tol']:.3e} fro_rel_err={cons['fro_rel_err']:.3e}",
          flush=True)
    for name, pr in (("prefill", prof_prefill), ("decode step", prof_step)):
        if pr["idle_share"] is None:
            print(f"[encdec] profiled {name}: the profiler saw no kernel; "
                  f"device shares not measured", flush=True)
        else:
            print(f"[encdec] profiled {name}: wall {pr['wall_ms']:.2f} ms, "
                  f"device busy {pr['device_busy_ms']:.2f} ms, idle share "
                  f"{pr['idle_share']:.4f}, {pr['kernels']:.0f} kernels, K5 "
                  f"{pr['k5_fwd_ms']:.3f} ms "
                  f"({pr['k5_fwd_ms'] / pr['device_busy_ms']:.2%} of busy)",
                  flush=True)
    if prefill_launches != want_prefill or \
            set(step_launches) != {want_step} or torch_launches:
        fail(f"encdec: K5 launches prefill {prefill_launches}, decode "
             f"steps {step_launches}, torch tier {torch_launches}; expected "
             f"{want_prefill}, {want_step} each, 0")
    if not (masked and bool(((toks >= 0) & (toks < cfg.vocab_size))
                            .all().item())):
        fail(f"encdec: padded ids unmasked ({not masked}) or greedy tokens "
             f"outside [0, {cfg.vocab_size})")
    serve = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
             "tokens_per_s": tps, "wave_tokens_per_s": wave_tps,
             "peak_bytes": peak, "prefill_launches": prefill_launches,
             "step_launches": step_launches, "vs_torch_tier": tier,
             "decode_consistency": cons, "profile_prefill": prof_prefill,
             "profile_decode_step": prof_step}
    del model, caches, memory, lg, ref, first, step_logits
    torch.cuda.empty_cache()

    # -- f32: phase 7's hold of the prefill logits, one decode step
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = encdec.init_encdec(cfg32, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    batch32 = {"frames": frames32, "tokens": prompts}
    with torch.inference_mode():
        k5_zero()
        got, c32, mem32, len32 = steps.make_prefill_step(cfg32, cache)(
            m32, batch32)
        lg32, _, _ = steps.make_decode_step(cfg32)(
            m32, {"token": prompts[:, :1], "caches": c32, "memory": mem32,
                  "length": len32})
        torch.cuda.synchronize()
        launches32 = k5.flash_attention.launches
        measured += k5_by_shape()
        want = steps.make_prefill_step(cfg32, cache, attn_impl="torch")(
            m32, batch32)[0]
        full32, _ = encdec.decode_stack(
            m32, torch.cat([prompts, prompts[:, :1]], 1), mem32)
    v = cfg.vocab_size   # the padded ids' -1e30 would set the scale
    err, tol = max_err(got[..., :v], want[..., :v])
    err_d, tol_d = max_err(lg32[:, -1, :v], full32[:, -1, :v])
    print(f"[encdec] f32 prefill logits vs torch tier max_abs_err={err:.3e} "
          f"tol={tol:.3e}; a decode step vs decode_stack max_abs_err="
          f"{err_d:.3e} tol={tol_d:.3e}; K5 launches {launches32} (expected "
          f"{want_prefill + want_step})", flush=True)
    if launches32 != want_prefill + want_step:
        fail(f"encdec f32: K5 launches {launches32}, expected "
             f"{want_prefill + want_step}")
    if not (bool(torch.isfinite(got).all().item()) and err <= tol
            and err_d <= tol_d):
        fail(f"encdec f32: prefill logits off the torch tier by {err:.3e} "
             f"(tolerance {tol:.3e}) or a decode step off decode_stack by "
             f"{err_d:.3e} (tolerance {tol_d:.3e})")
    f32 = {"prefill_max_abs_err": err, "prefill_tol": tol,
           "decode_max_abs_err": err_d, "decode_tol": tol_d,
           "launches": launches32}
    del m32, c32, mem32, got, want, full32, lg32
    torch.cuda.empty_cache()

    # -- training: f32 at full width and depth through launch/train_lm.py;
    # a step's K5 launches: forward one per attention, then the
    # checkpointed layers' recomputation again; backward two per attention
    tcfg = train_lm.make_config(cfg.name, width="full")
    skel = encdec.EncDecLM(tcfg, device="meta")
    n_attn = n_enc + 2 * n_dec

    def loss_fn(params, bt, impl):
        return encdec.encdec_loss(skel, bt["frames"], bt["tokens"],
                                  bt["labels"], params=params,
                                  attn_impl=impl)
    train = drive_lm_trainer(
        tcfg, "encdec_train", "encdec",
        f"train {tcfg.name} f32, {n_enc} + {n_dec} layers, "
        f"{tcfg.param_count() / 1e6:.1f} M params, batch "
        f"{ENCDEC_TRAIN_BATCH} x {ENCDEC_TRAIN_SEQ} tokens over "
        f"{min(ENCDEC_TRAIN_SEQ, MAX_ENC_FRAMES)} frames", loss_fn,
        (2 * n_attn, 2 * n_attn), ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_BATCH,
        ENCDEC_TRAIN_SEQ)
    measured += train.pop("by_shape")

    by_shape = named_shapes(measured, "encdec", "prefill, decode steps, "
                            "f32 prefill and step, Trainer steps, first "
                            "bf16 training step")
    return {"params": n_params, "serve": serve, "f32": f32, "train": train,
            "by_shape": by_shape}


def named_shapes(measured, label: str, segments: str) -> dict:
    """A phase's K5 launches by shape (``k5_by_shape`` keys, summed over its
    main-path segments) by name: each key to the FLASH_SHAPES (forward) or
    FLASH_BWD_SHAPES (backward) entry of its function, at its own batch
    where the table has it, else at the table's, as
    "[bwd/]<dtype>/<shape name>".  Fails if a launch falls on no entry: a
    shape that no check holds."""
    from collections import Counter
    by_shape, lines = Counter(), []
    for key, n in sorted(measured.items(), key=str):
        part, dtype, b_, *rest = key
        table = FLASH_SHAPES if part == "fwd" else FLASH_BWD_SHAPES
        names = [nm for nm, shp in table.items()
                 if shp[9] is None and tuple(shp[1:9]) == tuple(rest)]
        names = [nm for nm in names if table[nm][0] == b_] or names
        if not names:
            fail(f"{label}: K5 {part} launched {n} times at {key}, a shape "
                 f"that no check holds")
        by_shape[("bwd/" if part == "bwd" else "") + f"{dtype}/"
                 f"{names[0]}"] += n
        lines.append(f"{part} {dtype} ({names[0]}) B={b_}: {n}")
    print(f"[{label}] K5 launches by shape over the main-path segments "
          f"({segments}), as the wrapper counted them: " + "; ".join(lines),
          flush=True)
    return dict(by_shape)


class RouteLog:
    """Phase 20's reading of each MoE layer's routes from the layer's input,
    by forward hooks on the model's ``MoE`` modules (the package is not
    changed).  Per call that is not dropless (a forward or a prefill: the
    decode step is dropless, and captured), on the device: the layer, each
    token's top-k expert set and the set of those its capacity keeps
    (-1 for a dropped one), the gap between its k-th and (k+1)-th router
    probability, and the share of assignments dropped.  Use as a context
    manager; the hooks go on exit."""

    def __init__(self, model):
        self.model, self.calls, self.handles = model, [], []

    def __enter__(self):
        for n, blk in enumerate(self.model.layers):
            if blk.is_moe:
                self.handles.append(blk.moe.register_forward_hook(
                    lambda mod, args, kw, out, n=n: self._read(n, mod, args,
                                                               kw),
                    with_kwargs=True))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []

    def _read(self, n, mod, args, kw):
        import torch
        from repro_torch.models import moe
        if kw.get("dropless", False):
            return
        x, k = args[0], mod.cfg.top_k
        with torch.no_grad():
            probs = moe.route(mod.router, x.reshape(-1, x.shape[-1]), k)[0]
            top, ids = torch.topk(probs, k + 1, dim=-1)
            ids = ids[:, :k]
            order, _, _, keep, _ = moe.dispatch(
                ids, mod.cfg.num_experts, moe.slots(mod.cfg, probs.shape[0]))
            kept = torch.empty_like(keep)
            kept[order] = keep
            kept = torch.where(kept.reshape(ids.shape), ids, -1)
        self.calls.append({"layer": n, "ids": ids.sort(-1).values,
                           "kept": kept.sort(-1).values,
                           "gap": top[:, k - 1] - top[:, k],
                           "dropped": 1 - keep.float().mean()})

    def dropped(self) -> list:
        """Each call's share of capacity-dropped assignments."""
        return [c["dropped"].item() for c in self.calls]


def route_rule(a: "RouteLog", b: "RouteLog", limit: float, label: str):
    """Phase 20's route rule over two forwards of one sequence (their MoE
    calls in layer order).  A token's top-k set may differ between the
    runs where its router is near a tie, and downstream of that: a flip
    at position j of layer L moves the attention of every later position
    in the layers after L, and (capacity ranks tokens in order) may move
    the capacity drops of later tokens in layer L.  So a differing route
    with no differing route or kept set at an earlier layer and at or
    before its position -- a primary one -- must be a near tie (the gap
    under ``limit`` in one of the runs), else the phase fails; a kept set
    may differ only after a differing route.  Returns (mask of the
    positions before the first difference of any layer, where the logits
    are comparable; share of (layer, token) routes that differ; the
    largest primary gap)."""
    import torch
    if [c["layer"] for c in a.calls] != [c["layer"] for c in b.calls]:
        fail(f"{label}: the two runs made other MoE calls")
    upstream = torch.zeros_like(a.calls[0]["gap"], dtype=torch.bool)
    seen = torch.zeros_like(upstream)
    n_route = n_primary = n_kept = total = 0
    worst = 0.0
    for ca, cb in zip(a.calls, b.calls):
        r = (ca["ids"] != cb["ids"]).any(-1)
        kd = (ca["kept"] != cb["kept"]).any(-1) & ~r
        primary = r & ~upstream
        if primary.any():
            worst = max(worst, torch.minimum(ca["gap"], cb["gap"])[primary]
                        .max().item())
        earlier = (torch.cumsum(r.int(), 0) - r.int()) > 0
        if (kd & ~upstream & ~earlier).any():
            fail(f"{label}: a kept set differs with every route at and "
                 f"before it equal")
        d = r | kd
        upstream = upstream | (torch.cumsum(d.int(), 0) > 0)
        seen |= d
        n_route += int(r.sum())
        n_primary += int(primary.sum())
        n_kept += int(kd.sum())
        total += r.numel()
    prefix = torch.cumsum(seen.int(), 0) == 0
    share = n_route / total
    print(f"[moe] {label}: routes differ for {n_route} of {total} (layer, "
          f"token) pairs ({share:.4%}), {n_primary} of them primary, "
          f"largest primary gap {worst:.3e} (near-tie limit {limit:.0e}); "
          f"kept sets differ after them for {n_kept} more; the first "
          f"{int(prefix.sum())} of {prefix.numel()} positions differ in "
          f"no layer", flush=True)
    if worst >= limit:
        fail(f"{label}: a primary route differs where the router is not "
             f"near a tie (gap {worst:.3e}, limit {limit:.0e})")
    if not prefix.any():
        fail(f"{label}: the first position already differs: no logits to "
             f"compare")
    return prefix, share, worst


def top_kernels(name: str, n: int = 6) -> list:
    """The ``n`` kernels of the trace ``chiprun_out/traces/<name>.json``
    that took the most device time: (name, ms, count)."""
    from collections import defaultdict
    events = json.loads((ROOT / "chiprun_out" / "traces" /
                         f"{name}.json").read_text())
    events = events.get("traceEvents", events)
    ms, count = defaultdict(float), defaultdict(int)
    for e in events:
        if e.get("cat") == "kernel":
            ms[e["name"][:80]] += e["dur"] / 1e3
            count[e["name"][:80]] += 1
    top = sorted(ms, key=ms.get, reverse=True)[:n]
    return [(k, ms[k], count[k]) for k in top]


def drive_moe():
    """Phase 20: arctic-480b (128 experts, top-2, a dense residual, GQA 56
    over 8 heads at D 128) at full width, depth cut, random weights from a
    seeded generator: K5 at the longest prompt's shape (l) as phase 5
    holds its shapes; in f32 one layer's lm_forward against the torch tier
    under the route rule; in bf16 two layers serving a wave through the
    ServeEngine (decode captured once, a replay bit for bit an eager
    step), K5's launches by shape, the capacity drops, the first prompt's
    logits against the torch tier under the route rule, a profiled
    prefill and decode step.  Returns the measurements."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.models.transformer import (TransformerLM, lm_forward,
                                                lm_prefill)
    from repro_torch.serve.engine import Request

    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[moe] {free / 1e9:.1f} GB of {total / 1e9:.1f} GB free on the "
          f"card (need {MOE_MIN_FREE / 1e9:.0f})", flush=True)
    if free < MOE_MIN_FREE:
        fail(f"moe: {free / 1e9:.1f} GB free, the phase needs "
             f"{MOE_MIN_FREE / 1e9:.0f}")
    # -- K5 at (l): arctic's group of 7 at its longest prompt
    flash = check_flash(["l"], gqa=True)
    torch.cuda.empty_cache()
    base = get_config("arctic-480b")
    gen = torch.Generator(device="cuda")
    rng = np.random.default_rng(SEED)

    # -- f32: one layer, lm_forward with K5 against the torch tier
    cfg32 = dataclasses.replace(base, dtype="float32",
                                num_layers=MOE_F32_LAYERS)
    t0 = time.perf_counter()
    m32 = TransformerLM(cfg32, device="cuda", generator=gen.manual_seed(SEED))
    torch.cuda.synchronize()
    made32 = time.perf_counter() - t0
    toks = torch.as_tensor(rng.integers(0, base.vocab_size,
                                        (1, MOE_F32_TOKENS)), device="cuda")
    with torch.inference_mode():
        k5_zero()
        with RouteLog(m32) as ra:
            got = lm_forward(m32, toks)
        launches32 = k5.flash_attention.launches
        with RouteLog(m32) as rb:
            want = lm_forward(m32, toks, attn_impl="torch")
        torch_launches32 = k5.flash_attention.launches - launches32
    agree, share32, gap32 = route_rule(ra, rb, MOE_TIE_GAP["float32"],
                                       "f32 forward vs torch tier")
    v = base.vocab_size
    err, tol = max_err(got[0, agree, :v], want[0, agree, :v])
    print(f"[moe] f32 {cfg32.name}, {cfg32.num_layers} layer "
          f"({sum(p.numel() for p in m32.parameters())} parameters, made in "
          f"{made32:.1f} s), lm_forward over {MOE_F32_TOKENS} tokens: K5 "
          f"launches {launches32} (expected {cfg32.num_layers}), torch tier "
          f"{torch_launches32}; logits at the {int(agree.sum())} positions "
          f"before any route differs vs torch tier max_abs_err={err:.3e} tol={tol:.3e}; "
          f"capacity drops {ra.dropped()}", flush=True)
    if launches32 != cfg32.num_layers or torch_launches32:
        fail(f"moe f32: K5 launches {launches32}, torch tier "
             f"{torch_launches32}; expected {cfg32.num_layers}, 0")
    if not (bool(torch.isfinite(got).all().item()) and err <= tol):
        fail(f"moe f32: logits off the torch tier by {err:.3e} (tolerance "
             f"{tol:.3e})")
    f32 = {"layers": cfg32.num_layers, "tokens": MOE_F32_TOKENS,
           "launches": launches32, "max_abs_err": err, "tol": tol,
           "routes_differ_share": share32, "largest_differing_gap": gap32,
           "agreeing_positions": int(agree.sum()), "dropped": ra.dropped()}
    del m32, got, want, ra, rb, agree
    torch.cuda.empty_cache()

    # -- bf16: two layers serving a wave through the ServeEngine
    cfg = dataclasses.replace(base, num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda", generator=gen.manual_seed(SEED))
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    lengths = [int(n) for n in rng.integers(
        MOE_PROMPT_RANGE[0], MOE_PROMPT_RANGE[1] + 1, MOE_REQUESTS - 1)]
    lengths.append(MOE_PROMPT_RANGE[1])
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    print(f"[moe] bf16 {cfg.name}, {cfg.num_layers} layers, {n_params} "
          f"parameters ({n_params * 2 / 1e9:.1f} GB), made on the card in "
          f"{made:.1f} s; prompts {lengths}", flush=True)
    eng = timed_engine()(cfg, model, max_batch=MOE_MAX_BATCH,
                         cache_size=MOE_CACHE)
    with torch.inference_mode():      # warm-up, uncounted
        lm_prefill(model, torch.as_tensor(prompts[-1][None], device="cuda"),
                   MOE_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5_zero()
    with RouteLog(model) as wave_routes:
        t0 = time.perf_counter()
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=MOE_TOKENS))
        done = eng.run()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    by_shape = k5_by_shape()
    launches = k5.flash_attention.launches
    outputs = {r.rid: list(r.output) for r in done}
    n_tok = sum(len(o) for o in outputs.values())
    dropped = wave_routes.dropped()
    steps = sorted(eng.step_ms)
    replayed = sorted(eng.step_ms[2:])
    for rid, n in enumerate(lengths):
        print(f"[moe] prompt {n:5d} tokens: prefill "
              f"{eng.prefill_ms[rid]:.1f} ms, time to first token "
              f"{eng.ttft_ms[rid]:.1f} ms, capacity-dropped assignments "
              f"{dropped[2 * rid]:.4f} / {dropped[2 * rid + 1]:.4f} "
              f"(layers 0 / 1)", flush=True)
    l_key = ("bfloat16",) + FLASH_SHAPES["l"][:9]
    want_by = {("fwd", "bfloat16", 1, cfg.attention.num_heads,
                cfg.attention.num_kv_heads, n, n, cfg.attention.head_dim,
                True, 0, 0.0): cfg.num_layers * lengths.count(n)
               for n in set(lengths)}
    launches_l = by_shape.get(("fwd",) + l_key, 0)
    print(f"[moe] K5 launches {launches} (expected {cfg.num_layers} x "
          f"{len(prompts)} prefills), at shape (l) {launches_l} (expected "
          f"{cfg.num_layers}), in decode steps {eng.decode_launches}; "
          f"by shape as expected {dict(by_shape) == want_by}; "
          f"{len(steps)} decode steps, replayed median "
          f"{replayed[len(replayed) // 2]:.2f} ms (eager first "
          f"{eng.step_ms[0]:.2f} ms, capturing {eng.step_ms[1]:.2f} ms), "
          f"{eng.decode_captures} capture, {eng.decode_replays} replays; "
          f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s, "
          f"decoding {MOE_REQUESTS * 1e3 / replayed[len(replayed) // 2]:.1f}"
          f" tokens/s; peak memory {peak / 2**30:.2f} GiB", flush=True)
    if dict(by_shape) != want_by or eng.decode_launches or \
            launches_l != cfg.num_layers:
        fail(f"moe: K5 launches by shape {dict(by_shape)}, in decode "
             f"{eng.decode_launches}; expected {want_by} and none in decode")
    if eng.decode_captures != 1 or eng.decode_replays != len(steps) - 1:
        fail(f"moe: decode step captured {eng.decode_captures} times, "
             f"replayed {eng.decode_replays} in {len(steps)} steps")
    if sorted(outputs) != list(range(MOE_REQUESTS)) or any(
            len(o) != MOE_TOKENS or not all(0 <= t < cfg.vocab_size
                                            for t in o)
            for o in outputs.values()):
        fail(f"moe: outputs {outputs}")

    # a replay of the captured decode step against the eager step from the
    # same state, bit for bit
    replay_equal = decode_replay_equal(eng)
    print(f"[moe] a replay of the captured decode step bit for bit the eager"
          f" step from the same state (logits, caches): {replay_equal}",
          flush=True)
    if not replay_equal:
        fail("moe: the captured decode step's logits differ from the eager "
             "step's")

    # the first prompt's logits against the torch tier, under the route rule
    p0 = torch.as_tensor(prompts[0][None], device="cuda")
    with torch.inference_mode():
        with RouteLog(model) as ra:
            got = lm_forward(model, p0)
        with RouteLog(model) as rb:
            want = lm_forward(model, p0, attn_impl="torch")
    agree, share, gap = route_rule(ra, rb, MOE_TIE_GAP["bfloat16"],
                                   f"bf16 prompt of {lengths[0]} tokens vs "
                                   f"torch tier")
    tier = logits_close(got[0, agree], want[0, agree], cfg.vocab_size,
                        "moe bf16 first prompt vs torch tier")
    print(f"[moe] first prompt's logits at its {int(agree.sum())} positions "
          f"before any route differs vs torch tier max_abs_err={tier['max_abs_err']:.3e} "
          f"tol={tier['tol']:.3e} fro_rel_err={tier['fro_rel_err']:.3e} "
          f"(limit {LOGIT_FRO_LIMIT:.0e})", flush=True)
    del got, want, ra, rb

    # where a prefill's and a decode step's time goes
    with torch.inference_mode():
        prof_prefill = profiled("moe_prefill", 1, lambda: lm_prefill(
            model, torch.as_tensor(prompts[-1][None], device="cuda"),
            MOE_CACHE))
        prof_step = profiled("moe_decode_step", 1,
                             lambda: eng._graph[0].replay())
    prof_prefill.update(k5_shares("moe_prefill"),
                        top=top_kernels("moe_prefill"))
    prof_step.update(top=top_kernels("moe_decode_step"))
    for name, pr in ((f"prefill of {lengths[-1]} tokens", prof_prefill),
                     ("decode step (a replay)", prof_step)):
        if pr["idle_share"] is None:
            print(f"[moe] profiled {name}: the profiler saw no kernel; "
                  f"device shares not measured", flush=True)
            continue
        print(f"[moe] profiled {name}: wall {pr['wall_ms']:.2f} ms, device "
              f"busy {pr['device_busy_ms']:.2f} ms, idle share "
              f"{pr['idle_share']:.4f}, {pr['kernels']:.0f} kernels; most "
              f"time: " + "; ".join(f"{k} {ms:.3f} ms x{c}"
                                    for k, ms, c in pr["top"]), flush=True)
    rec = {"params": n_params, "prompts": lengths,
           "prefill_ms": eng.prefill_ms, "ttft_ms": eng.ttft_ms,
           "decode_step_ms": eng.step_ms,
           "replayed_step_median_ms": replayed[len(replayed) // 2],
           "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "peak_bytes": peak, "launches": launches,
           "launches_l": launches_l, "decode_captures": eng.decode_captures,
           "decode_replays": eng.decode_replays,
           "replay_equal_eager": replay_equal, "dropped": dropped,
           "vs_torch_tier": tier, "routes_differ_share": share,
           "largest_differing_gap": gap, "profile_prefill": prof_prefill,
           "profile_decode_step": prof_step, "f32": f32, "flash": flash}
    del eng, model, wave_routes
    torch.cuda.empty_cache()
    return rec


def ssm_prefill_flops(cfg, s: int) -> float:
    """FLOPs (2 per multiply-add) of one ``lm_prefill`` of ``s`` tokens
    through ``cfg``'s Mamba-2 stack as this run computes them: per layer
    the input projections and ``out_proj`` over the ``s`` tokens, and the
    chunked scan over the padded length (the block pads past one chunk) --
    the scores (Q^2 N a group), ``y_diag`` (Q^2 P a head), each chunk's
    state contribution and its ``y_off`` (Q N P a head each) --; then the
    last token's logits.  The elementwise work (conv, decay mask, norms,
    gate) is left out."""
    m = cfg.ssm
    d, d_in, h = cfg.d_model, m.d_inner(cfg.d_model), m.n_heads(cfg.d_model)
    cd = d_in + 2 * m.n_groups * m.d_state
    q = min(m.chunk_size, s)
    nc = -(-s // q)
    proj = 2 * s * d * (d_in + cd + h) + 2 * s * d_in * d
    scan = nc * (2 * q * q * m.d_state * m.n_groups
                 + 2 * q * q * m.head_dim * h
                 + 2 * 2 * q * m.d_state * m.head_dim * h)
    return cfg.num_layers * (proj + scan) + 2 * d * cfg.padded_vocab


def check_ssd() -> dict:
    """Phase 21, first part: ``ssd_chunked`` against the sequential oracle
    ``ssd_reference`` on the card at mamba2-2.7b's head shape (B 1, S
    SSM_CHECK_TOKENS, H 80, P 64, G 1, N 128, chunk 256; inputs drawn as
    the reference's own test draws them) in f32 at the reference's limits
    (SSD_RTOL, SSD_ATOL), y and the final state; the config's bf16
    compute_dtype against that f32 run in the bf16 band.  Times of the
    chunked scan in both dtypes and of the oracle."""
    import dataclasses

    import torch
    from repro_torch.config import get_config
    from repro_torch.models.mamba2 import ssd_chunked, ssd_reference

    m = get_config("mamba2-2.7b").ssm
    h, p = m.n_heads(2560), m.head_dim
    g, n, s = m.n_groups, m.d_state, SSM_CHECK_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    x, bm, cm = draw(1, s, h, p), draw(1, s, g, n, scale=0.3), \
        draw(1, s, g, n, scale=0.3)
    dt = torch.rand((1, s, h), generator=gen, device="cuda") * 0.5 + 0.01
    a = -(torch.rand(h, generator=gen, device="cuda") + 0.2)
    m32 = dataclasses.replace(m, compute_dtype="float32")
    xb, bb, cb = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    with torch.inference_mode():
        y, st = ssd_chunked(x, bm, cm, dt, a, m32)
        oy, ost = ssd_reference(x, bm, cm, dt, a)
        y16, st16 = ssd_chunked(xb, bb, cb, dt, a, m)
        ms32 = time_ms(lambda: ssd_chunked(x, bm, cm, dt, a, m32), 5)
        ms16 = time_ms(lambda: ssd_chunked(xb, bb, cb, dt, a, m), 5)
        ms_oracle = time_ms(lambda: ssd_reference(x, bm, cm, dt, a), 1)

    def excess(got, want, tol):
        """The largest |got - want| / (tol + tol |want|) (<= 1 passes)."""
        return ((got - want).abs() / (tol[1] + tol[0] * want.abs())
                ).max().item()
    rec = {"tokens": s, "heads": h, "head_dim": p, "d_state": n,
           "chunk": m.chunk_size,
           "f32_y_err": (y - oy).abs().max().item(),
           "f32_state_err": (st - ost).abs().max().item(),
           "f32_excess": max(excess(y, oy, (SSD_RTOL, SSD_ATOL)),
                             excess(st, ost, (SSD_RTOL, SSD_ATOL))),
           "bf16_y_err": (y16 - y).abs().max().item(),
           "bf16_state_err": (st16 - st).abs().max().item(),
           "bf16_excess": max(excess(y16, y, (BF16_BAND, BF16_BAND)),
                              excess(st16, st, (BF16_BAND, BF16_BAND))),
           "f32_ms": ms32, "bf16_ms": ms16, "oracle_ms": ms_oracle}
    print(f"[ssm] ssd_chunked vs ssd_reference at B 1, S {s}, H {h}, P {p}, "
          f"G {g}, N {n}, chunk {m.chunk_size}: f32 y max_abs_err="
          f"{rec['f32_y_err']:.3e}, state {rec['f32_state_err']:.3e}, "
          f"largest err / (atol + rtol |oracle|) {rec['f32_excess']:.3f} "
          f"(rtol {SSD_RTOL:.0e}, atol {SSD_ATOL:.0e}; passes <= 1); bf16 "
          f"compute_dtype vs that f32 run: y {rec['bf16_y_err']:.3e}, "
          f"state {rec['bf16_state_err']:.3e}, err / band "
          f"{rec['bf16_excess']:.3f} (band {BF16_BAND}); ms: f32 "
          f"{ms32:.3f}, bf16 {ms16:.3f}, the sequential oracle "
          f"{ms_oracle:.1f}", flush=True)
    finite = all(bool(torch.isfinite(t).all().item())
                 for t in (y, st, y16, st16))
    if not (finite and rec["f32_excess"] <= 1 and rec["bf16_excess"] <= 1):
        fail(f"ssm: ssd_chunked off the oracle ({rec})")
    return rec


def ssm_f64_grads(base) -> dict:
    """Phase 21's yardstick of a training step: mamba2-2.7b at full width,
    SSM_F64_LAYERS layers, in f32 with an f32 compute_dtype against the
    same weights in f64, step 0's batch (TokenPipeline seed 0, SSM_TRAIN_
    BATCH x SSM_TRAIN_SEQ): the loss and each gradient leaf within
    LM_TRAIN_GRAD_LIMIT of that leaf's largest magnitude."""
    import dataclasses

    import torch
    from repro_torch.config import ShapeSpec
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.transformer import TransformerLM, lm_loss

    cfg32 = dataclasses.replace(
        base, dtype="float32", num_layers=SSM_F64_LAYERS,
        ssm=dataclasses.replace(base.ssm, compute_dtype="float32"))
    cfg64 = dataclasses.replace(
        cfg32, dtype="float64",
        ssm=dataclasses.replace(base.ssm, compute_dtype="float64"))
    gen = torch.Generator(device="cuda")
    m32 = TransformerLM(cfg32, device="cuda", generator=gen.manual_seed(SEED))
    m64 = TransformerLM(cfg64, device="cuda", generator=gen.manual_seed(SEED))
    m64.load_state_dict(m32.state_dict())
    shape = ShapeSpec("ssm_train", SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, "train")
    bt = {k: torch.as_tensor(v, device="cuda") for k, v in
          TokenPipeline(cfg32, shape, seed=0).batch_at(0).items()}

    def grads(model):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in model.named_parameters()}
        loss, _ = lm_loss(model, bt["tokens"], bt["labels"], params=leaves)
        return loss.item(), dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    t0 = time.perf_counter()
    loss32, g32 = grads(m32)
    loss64, g64 = grads(m64)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    errs = {n: ((g32[n].double() - g64[n]).abs().max()
                / g64[n].abs().max().clamp_min(1e-300)).item() for n in g64}
    worst = max(errs, key=errs.get)
    loss_err = abs(loss32 - loss64)
    loss_tol = F32_BAND * SCALE * max(1.0, abs(loss64))
    print(f"[ssm-train] f64 yardstick: {cfg32.name} full width, "
          f"{cfg32.num_layers} layers, f32 (compute_dtype f32) vs the same "
          f"weights in f64 over step 0's {SSM_TRAIN_BATCH} x "
          f"{SSM_TRAIN_SEQ} tokens: loss {loss32:.6f} vs {loss64:.6f} "
          f"(|diff| {loss_err:.3e}, tol {loss_tol:.3e}); worst gradient "
          f"leaf {worst} {errs[worst]:.3e} of its largest magnitude (limit "
          f"{LM_TRAIN_GRAD_LIMIT:.0e}) over {len(errs)} leaves; "
          f"{secs:.1f} s", flush=True)
    if not (loss_err <= loss_tol and errs[worst] <= LM_TRAIN_GRAD_LIMIT):
        fail(f"ssm f64 yardstick: loss off by {loss_err:.3e} or leaf "
             f"{worst} by {errs[worst]:.3e}")
    del m32, m64, g32, g64
    torch.cuda.empty_cache()
    return {"layers": cfg32.num_layers, "loss_err": loss_err,
            "loss_tol": loss_tol, "worst_leaf": worst,
            "worst_leaf_err": errs[worst], "seconds": secs}


def ssm_decode_vs_prefill(cfg, model, prompts, outputs, last) -> dict:
    """Phase 21's hold of the decode branch.  ``outputs`` are the bf16
    wave's greedy tokens and ``last`` each request's last decode logits.
    An f32 copy of ``model`` (the same weights, an f32 compute_dtype)
    serves the same prompts through its own captured ServeEngine; each f32
    request's last decode logits must agree with a fresh f32 prefill of its
    prompt and the tokens it generated before the last within the f32
    band x SCALE (relative Frobenius): in f32 the prefill and decode
    branches compute the same function.  Each bf16 request's last decode
    logits are held against the f32 model's prefill of the same tokens,
    beside a fresh bf16 prefill's: at most SSM_DECODE_SLACK times as far
    off.  Their distance from each other is printed beside
    LOGIT_FRO_LIMIT.  Returns the numbers."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.transformer import TransformerLM, lm_prefill
    from repro_torch.serve.engine import Request

    v = cfg.vocab_size
    cfg32 = dataclasses.replace(cfg, dtype="float32", ssm=dataclasses.replace(
        cfg.ssm, compute_dtype="float32"))
    m32 = TransformerLM(cfg32, device="cuda")
    m32.load_state_dict(model.state_dict())
    eng32 = timed_engine()(cfg32, m32, max_batch=SSM_MAX_BATCH,
                           cache_size=SSM_CACHE)
    for rid, p in enumerate(prompts):
        eng32.submit(Request(rid=rid, prompt=p, max_tokens=SSM_TOKENS))
    out32 = {r.rid: list(r.output) for r in eng32.run()}

    def prefill(m, seq):
        with torch.inference_mode():
            return lm_prefill(m, torch.as_tensor(seq[None], device="cuda"),
                              SSM_CACHE)[0][0, -1, :v].float().cpu()
    f32_limit = F32_BAND * SCALE
    rec = {"f32_captures": eng32.decode_captures}
    for rid, p in enumerate(prompts):
        n = len(p)
        seq32 = np.concatenate([p, out32[rid][:-1]])
        got32 = torch.from_numpy(eng32.last_logits[rid][:v])
        f32_err = fro_rel(got32, prefill(m32, seq32))
        seq = np.concatenate([p, outputs[rid][:-1]])
        truth, pre16 = prefill(m32, seq), prefill(model, seq)
        dec16 = torch.from_numpy(last[rid][:v])
        dec_off, pre_off = fro_rel(dec16, truth), fro_rel(pre16, truth)
        between = fro_rel(dec16, pre16)
        rec[n] = {"f32_decode_vs_prefill": f32_err,
                  "bf16_decode_vs_f32": dec_off,
                  "bf16_prefill_vs_f32": pre_off,
                  "bf16_decode_vs_prefill": between,
                  "bf16_argmax_equal": int(dec16.argmax()) ==
                  int(pre16.argmax())}
        print(f"[ssm] prompt {n:5d}: f32 engine's last decode logits vs a "
              f"fresh f32 prefill of its {len(seq32)} tokens fro_rel_err="
              f"{f32_err:.3e} (limit {f32_limit:.0e}); bf16 last decode "
              f"logits vs the f32 prefill of the same {len(seq)} tokens "
              f"{dec_off:.3e}, a bf16 prefill's {pre_off:.3e} (limit "
              f"{SSM_DECODE_SLACK} x), bf16 decode vs bf16 prefill "
              f"{between:.3e} (phases 6 and 20 hold {LOGIT_FRO_LIMIT:.0e} "
              f"there; not held here, above), argmax equal "
              f"{rec[n]['bf16_argmax_equal']}", flush=True)
        if not (bool(torch.isfinite(dec16).all().item())
                and f32_err <= f32_limit
                and dec_off <= SSM_DECODE_SLACK * pre_off):
            fail(f"ssm: request {rid} ({n} tokens): the decode branch is "
                 f"off ({rec[n]})")
    if eng32.decode_captures != 1:
        fail(f"ssm: the f32 engine captured {eng32.decode_captures} times")
    del eng32, m32
    torch.cuda.empty_cache()
    return rec


def drive_ssm():
    """Phase 21: mamba2-2.7b (64 Mamba-2 blocks, attention- and FFN-free)
    at full width and depth, random weights from a seeded generator: the
    SSD against its oracle (``check_ssd``); a wave of SSM_PROMPTS through
    the ServeEngine (bf16, the decode step captured once over the SSM
    caches, a replay bit for bit the eager step, no kernel launch of any
    wrapper), each request's last decode logits against a fresh
    ``lm_prefill`` over its prompt and the tokens it generated; prefill,
    time to first token, decode step, tokens/s and peak memory beside
    their bounds; a profiled prefill and decode step.  Then training at
    full width, depth cut to SSM_TRAIN_LAYERS, through ``drive_lm_trainer``
    (no K5 launch), and the f64 yardstick of a step's gradients
    (``ssm_f64_grads``).  Returns the measurements."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train_lm
    from repro_torch.models.transformer import (TransformerLM, lm_loss,
                                                lm_prefill)
    from repro_torch.serve.engine import Request

    ssd = check_ssd()
    torch.cuda.empty_cache()
    cfg = get_config("mamba2-2.7b")
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    w_bytes = sum(p.numel() * p.element_size() for p in params)
    print(f"[ssm] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.ssm.n_heads(cfg.d_model)} heads x "
          f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk "
          f"{cfg.ssm.chunk_size}; parameters: analytic {cfg.param_count()}, "
          f"real {n_params} (padded vocabulary, norms, conv_b, dt_bias), "
          f"{w_bytes / 1e9:.3f} GB on the card; made in {made:.1f} s",
          flush=True)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SSM_PROMPTS]
    with torch.inference_mode():      # warm-up, uncounted
        lm_prefill(model, torch.as_tensor(prompts[-1][None], device="cuda"),
                   SSM_CACHE)
    eng = timed_engine()(cfg, model, max_batch=SSM_MAX_BATCH,
                         cache_size=SSM_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_tokens=SSM_TOKENS))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    outputs = {r.rid: list(r.output) for r in done}
    n_tok = sum(len(o) for o in outputs.values())
    steps = sorted(eng.step_ms)
    replayed = sorted(eng.step_ms[2:])
    step_med = replayed[len(replayed) // 2]
    # the bounds: a prefill's FLOPs at the tensor cores' bf16 rate beside
    # its weights' bytes; a decode step reads the weights once and reads
    # and writes every slot's f32 state and conv tail
    state_bytes = sum(t.numel() * t.element_size()
                      for c in eng._caches for t in c)
    step_bound = bound(w_bytes + 2 * state_bytes, 2 * n_params *
                       SSM_MAX_BATCH, BF16_FLOPS)
    prefill = {}
    for rid, n in enumerate(SSM_PROMPTS):
        pb = bound(w_bytes, ssm_prefill_flops(cfg, n), BF16_FLOPS)
        prefill[n] = {"ms": eng.prefill_ms[rid], "ttft_ms": eng.ttft_ms[rid],
                      "bound_ms": pb[0], "bound_by": pb[1]}
        print(f"[ssm] prompt {n:5d} tokens: prefill {eng.prefill_ms[rid]:.1f}"
              f" ms (bound {pb[0]:.3f} ms by {pb[1]}, "
              f"{ssm_prefill_flops(cfg, n):.3e} FLOP), time to first token "
              f"{eng.ttft_ms[rid]:.1f} ms", flush=True)
    print(f"[ssm] wave: {len(steps)} decode steps, replayed median "
          f"{step_med:.2f} ms (bound {step_bound[0]:.3f} ms by "
          f"{step_bound[1]}: {w_bytes / 1e9:.3f} GB of weights, "
          f"{2 * state_bytes / 1e9:.3f} GB of state and conv tails read and "
          f"written), eager first {eng.step_ms[0]:.2f} ms, capturing "
          f"{eng.step_ms[1]:.2f} ms; {eng.decode_captures} capture, "
          f"{eng.decode_replays} replays; {n_tok} tokens in {wall:.2f} s = "
          f"{n_tok / wall:.1f} tokens/s, decoding "
          f"{SSM_MAX_BATCH * 1e3 / step_med:.1f} tokens/s; kernel launches "
          f"{counts}; peak memory {peak / 2**30:.2f} GiB", flush=True)
    if any(counts.values()):
        fail(f"ssm: the attention-free stack launched kernels {counts}")
    if eng.decode_captures != 1 or eng.decode_replays != len(steps) - 1:
        fail(f"ssm: decode step captured {eng.decode_captures} times, "
             f"replayed {eng.decode_replays} in {len(steps)} steps")
    if sorted(outputs) != list(range(len(prompts))) or any(
            len(o) != SSM_TOKENS or not all(0 <= t < cfg.vocab_size
                                            for t in o)
            for o in outputs.values()):
        fail(f"ssm: outputs {outputs}")

    # a replay of the captured decode step against the eager step from the
    # same state, bit for bit: logits and every state and conv tail
    replay_equal = decode_replay_equal(eng)
    print(f"[ssm] a replay of the captured decode step bit for bit the eager"
          f" step from the same state (logits, states, conv tails): "
          f"{replay_equal}", flush=True)
    if not replay_equal:
        fail("ssm: the captured decode step differs from the eager step")

    # each request's last decode logits against a fresh prefill over its
    # prompt and the tokens it generated before the last: in f32 through
    # an f32 engine (the two branches must agree), in bf16 against that
    # f32 yardstick
    consistency = ssm_decode_vs_prefill(cfg, model, prompts, outputs,
                                        eng.last_logits)

    # where a prefill's and a decode step's time goes
    with torch.inference_mode():
        prof_prefill = profiled("ssm_prefill", 1, lambda: lm_prefill(
            model, torch.as_tensor(prompts[-1][None], device="cuda"),
            SSM_CACHE))
        prof_step = profiled("ssm_decode_step", 1,
                             lambda: eng._graph[0].replay())
    prof_prefill.update(top=top_kernels("ssm_prefill"))
    prof_step.update(top=top_kernels("ssm_decode_step"))
    for name, pr in ((f"prefill of {SSM_PROMPTS[-1]} tokens", prof_prefill),
                     ("decode step (a replay)", prof_step)):
        if pr["idle_share"] is None:
            print(f"[ssm] profiled {name}: the profiler saw no kernel; "
                  f"device shares not measured", flush=True)
            continue
        print(f"[ssm] profiled {name}: wall {pr['wall_ms']:.2f} ms, device "
              f"busy {pr['device_busy_ms']:.2f} ms, idle share "
              f"{pr['idle_share']:.4f}, {pr['kernels']:.0f} kernels; most "
              f"time: " + "; ".join(f"{k} {ms:.3f} ms x{c}"
                                    for k, ms, c in pr["top"]), flush=True)
    serve = {"params_analytic": cfg.param_count(), "params": n_params,
             "weight_bytes": w_bytes, "state_bytes": state_bytes,
             "prompts": list(SSM_PROMPTS), "prefill": prefill,
             "decode_step_ms": eng.step_ms, "replayed_step_median_ms":
             step_med, "decode_step_bound_ms": step_bound[0],
             "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
             "decode_tokens_per_s": SSM_MAX_BATCH * 1e3 / step_med,
             "peak_bytes": peak, "launches": counts,
             "decode_captures": eng.decode_captures,
             "decode_replays": eng.decode_replays,
             "replay_equal_eager": replay_equal,
             "decode_vs_prefill": consistency,
             "profile_prefill": prof_prefill, "profile_decode_step": prof_step}
    del eng, model, params
    torch.cuda.empty_cache()

    # -- training at full width, depth cut; then the f64 yardstick
    tcfg = train_lm.make_config("mamba2-2.7b", width="full",
                                layers=SSM_TRAIN_LAYERS)
    skel = TransformerLM(tcfg, device="meta")

    def loss_fn(params, bt, impl):
        return lm_loss(skel, bt["tokens"], bt["labels"], params=params,
                       attn_impl=impl)
    train = drive_lm_trainer(
        tcfg, "ssm_train", "ssm-train",
        f"{tcfg.name} f32 full width (compute_dtype "
        f"{tcfg.ssm.compute_dtype}), {tcfg.num_layers} layers, "
        f"{tcfg.param_count() / 1e9:.3f} B params, batch {SSM_TRAIN_BATCH} x "
        f"{SSM_TRAIN_SEQ}", loss_fn, (0, 0), SSM_TRAIN_STEPS,
        SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)
    del train["by_shape"]
    train["layers"] = tcfg.num_layers
    train["f64"] = ssm_f64_grads(cfg)
    return {"ssd": ssd, "serve": serve, "train": train}


def need_free(label: str, need: float) -> None:
    """Fails unless the card has ``need`` bytes free (after emptying the
    allocator's cache), as phase 20 checks before it builds."""
    import torch
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[vlm] {label}: {free / 1e9:.1f} GB of {total / 1e9:.1f} GB free "
          f"on the card (need {need / 1e9:.0f})", flush=True)
    if free < need:
        fail(f"vlm {label}: {free / 1e9:.1f} GB free, need "
             f"{need / 1e9:.0f}")


def decode_replay_equal(eng) -> bool:
    """A replay of ``eng``'s captured decode step against its eager step
    from the same state, bit for bit: the logits and every cache tensor
    (phases 20, 21 and 22 hold their engines so).  The state is restored
    after each."""
    import torch
    with torch.inference_mode():
        saved = ([tuple(t.clone() for t in c) for c in eng._caches],
                 eng._length.clone())

        def restore():
            for c, c0 in zip(eng._caches, saved[0]):
                for t, t0_ in zip(c, c0):
                    t.copy_(t0_)
            eng._length.copy_(saved[1])
        eng._graph[0].replay()
        replay_logits = eng._graph[1].clone()
        replay_caches = [tuple(t.clone() for t in c) for c in eng._caches]
        restore()
        eager_logits = eng._decode_body().clone()
        equal = torch.equal(replay_logits, eager_logits) and all(
            torch.equal(a, b) for c, c0 in zip(eng._caches, replay_caches)
            for a, b in zip(c, c0))
        restore()
        torch.cuda.synchronize()
    return equal


def fro_rel(a, b) -> float:
    """||a - b|| / ||b||, in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def vlm_serve(model, cfg, embeds, prompts, label: str):
    """One image+prompt wave of phase 22 through launch/steps.py: a
    make_prefill_step of ``embeds`` and ``prompts`` into VLM_CACHE rows
    (after an uncounted warm-up), then VLM_STEPS greedy make_decode_steps,
    each timed with CUDA events and its K5 launches read just after it.
    Returns (first logits, last logits (B, V), the fed tokens (B,
    VLM_STEPS), prefill ms, step ms, K5 launches by shape of the prefill,
    K5 launches of each step, peak bytes, the prefill's caches)."""
    import torch
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.launch import steps

    prefill = steps.make_prefill_step(cfg, VLM_CACHE)
    decode = steps.make_decode_step(cfg)
    batch = {"embeds": embeds, "tokens": prompts}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.inference_mode():
        prefill(model, batch)                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k5_zero()
        ev[0].record()
        lg, caches, length = prefill(model, batch)
        ev[1].record()
        torch.cuda.synchronize()
        by_shape = k5_by_shape()
        prefill_ms = ev[0].elapsed_time(ev[1])
        first = lg[:, -1]
        tok = first.argmax(-1)
        fed, step_ms, step_launches = [], [], []
        for _ in range(VLM_STEPS):
            fed.append(tok)
            k5_zero()
            ev[0].record()
            lg, caches, length = decode(model, {
                "token": tok[:, None], "caches": caches, "length": length})
            ev[1].record()
            torch.cuda.synchronize()
            step_launches.append(k5.flash_attention.launches)
            step_ms.append(ev[0].elapsed_time(ev[1]))
            tok = lg[:, -1].argmax(-1)
        peak = torch.cuda.max_memory_allocated()
    if int(length) != VLM_CACHE:
        fail(f"vlm {label}: the cache holds {int(length)} positions after "
             f"the wave, expected {VLM_CACHE}")
    return (first, lg[:, -1], torch.stack(fed, 1), prefill_ms, step_ms,
            by_shape, step_launches, peak, caches)


def serve_dense(name: str, layers: int, need: float) -> dict:
    """Phase 22's dense waves: ``name`` at full width with ``layers`` of
    its layers, bf16, seeded random weights, through the ServeEngine:
    DENSE_REQUESTS prompts (the last DENSE_PROMPT_RANGE's upper end), the
    decode step captured once and a replay bit for bit the eager step,
    K5's launches by shape (one a layer a prefill, none in decode), the
    first prompt's logits against the torch tier (``logits_close``),
    prefill and decode ms, peak memory.  Returns the measurements, with
    ``launches_2048`` the prefill launches at the longest prompt."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.models.transformer import (TransformerLM, lm_forward,
                                                lm_prefill)
    from repro_torch.serve.engine import Request

    need_free(name, need)
    base = get_config(name)
    cfg = dataclasses.replace(base, num_layers=layers)
    a = cfg.attention
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    lo, hi = DENSE_PROMPT_RANGE
    lengths = [int(n) for n in rng.integers(lo, hi, DENSE_REQUESTS - 1)]
    lengths.append(hi)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    print(f"[dense] {cfg.name} bf16, {layers} of {base.num_layers} layers, "
          f"d_model {cfg.d_model}, {a.num_heads} query heads over "
          f"{a.num_kv_heads} KV heads at D {a.head_dim}, {n_params} "
          f"parameters ({n_params * 2 / 1e9:.2f} GB), made on the card in "
          f"{made:.1f} s; prompts {lengths}", flush=True)
    eng = timed_engine()(cfg, model, max_batch=DENSE_REQUESTS,
                         cache_size=DENSE_CACHE)
    with torch.inference_mode():      # warm-up, uncounted
        lm_prefill(model, torch.as_tensor(prompts[-1][None], device="cuda"),
                   DENSE_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5_zero()
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_tokens=DENSE_TOKENS))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    by_shape = k5_by_shape()
    outputs = {r.rid: list(r.output) for r in done}
    n_tok = sum(len(o) for o in outputs.values())
    replayed = sorted(eng.step_ms[2:])
    step_med = replayed[len(replayed) // 2]
    key = ("fwd", "bfloat16", 1, a.num_heads, a.num_kv_heads)
    want_by = {key + (n, n, a.head_dim, True, 0, 0.0):
               layers * lengths.count(n) for n in set(lengths)}
    launches_2048 = by_shape.get(key + (hi, hi, a.head_dim, True, 0, 0.0), 0)
    for rid, n in enumerate(lengths):
        print(f"[dense] {cfg.name} prompt {n:5d} tokens: prefill "
              f"{eng.prefill_ms[rid]:.1f} ms, time to first token "
              f"{eng.ttft_ms[rid]:.1f} ms", flush=True)
    print(f"[dense] {cfg.name}: K5 launches {k5.flash_attention.launches} "
          f"(expected {layers} x {len(prompts)} prefills), at the "
          f"{hi}-token prompt {launches_2048} (expected {layers}), in "
          f"decode steps {eng.decode_launches}; by shape as expected "
          f"{dict(by_shape) == want_by}; {len(eng.step_ms)} decode steps, "
          f"replayed median {step_med:.2f} ms (eager first "
          f"{eng.step_ms[0]:.2f} ms, capturing {eng.step_ms[1]:.2f} ms), "
          f"{eng.decode_captures} capture, {eng.decode_replays} replays; "
          f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s, "
          f"decoding {DENSE_REQUESTS * 1e3 / step_med:.1f} tokens/s; peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    if dict(by_shape) != want_by or eng.decode_launches:
        fail(f"dense {cfg.name}: K5 launches by shape {dict(by_shape)}, in "
             f"decode {eng.decode_launches}; expected {want_by}, none")
    if eng.decode_captures != 1 or \
            eng.decode_replays != len(eng.step_ms) - 1:
        fail(f"dense {cfg.name}: decode step captured "
             f"{eng.decode_captures} times, replayed {eng.decode_replays} "
             f"in {len(eng.step_ms)} steps")
    if sorted(outputs) != list(range(DENSE_REQUESTS)) or any(
            len(o) != DENSE_TOKENS or not all(0 <= t < cfg.vocab_size
                                              for t in o)
            for o in outputs.values()):
        fail(f"dense {cfg.name}: outputs {outputs}")
    replay_equal = decode_replay_equal(eng)
    print(f"[dense] {cfg.name}: a replay of the captured decode step bit "
          f"for bit the eager step from the same state (logits, caches): "
          f"{replay_equal}", flush=True)
    if not replay_equal:
        fail(f"dense {cfg.name}: the captured decode step differs from the "
             f"eager step")
    p0 = torch.as_tensor(prompts[0][None], device="cuda")
    with torch.inference_mode():
        got = lm_forward(model, p0)
        want = lm_forward(model, p0, attn_impl="torch")
    tier = logits_close(got, want, cfg.vocab_size,
                        f"dense {cfg.name} first prompt vs torch tier")
    print(f"[dense] {cfg.name}: first prompt's ({lengths[0]} tokens) logits "
          f"vs torch tier max_abs_err={tier['max_abs_err']:.3e} "
          f"tol={tier['tol']:.3e} fro_rel_err={tier['fro_rel_err']:.3e} "
          f"(limit {LOGIT_FRO_LIMIT:.0e})", flush=True)
    rec = {"layers": layers, "params": n_params, "prompts": lengths,
           "prefill_ms": eng.prefill_ms, "ttft_ms": eng.ttft_ms,
           "decode_step_ms": eng.step_ms, "replayed_step_median_ms":
           step_med, "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "peak_bytes": peak,
           "launches": k5.flash_attention.launches,
           "launches_2048": launches_2048,
           "decode_captures": eng.decode_captures,
           "decode_replays": eng.decode_replays,
           "replay_equal_eager": replay_equal, "vs_torch_tier": tier}
    del eng, model, got, want
    torch.cuda.empty_cache()
    return rec


def drive_vlm():
    """Phase 22: K5 at (m)-(q) and its backward at (o); internvl2-1b at
    full width and depth serving image+prompt requests through
    launch/steps.py (bf16; an f32 copy of its weights the yardstick),
    then a text-only wave through launch/serve.py, then training in f32
    through ``drive_lm_trainer``; then gemma-7b and deepseek-67b waves
    through the ServeEngine (``serve_dense``).  Returns the measurements,
    with the main-path segments' K5 launches by shape name
    (``named_shapes``)."""
    import dataclasses
    from collections import Counter

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.configs.internvl2_1b import NUM_PATCH_TOKENS
    from repro_torch.kernels import flash_attention as k5
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import steps, train_lm
    from repro_torch.models import vlm
    from repro_torch.models.transformer import TransformerLM, lm_loss

    # -- K5 at the slice's shapes: forward (m)-(q), backward (o)
    flash = check_flash(list(VLM_FLASH), gqa=True)
    flash_bwd = check_flash_bwd(["o"])
    torch.cuda.empty_cache()

    # -- internvl2-1b image+prompt serving, bf16
    need_free("internvl2-1b", VLM_MIN_FREE)
    cfg = get_config("internvl2-1b")
    a, L, v = cfg.attention, cfg.num_layers, cfg.vocab_size
    gen = torch.Generator(device="cuda")
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda", generator=gen.manual_seed(SEED))
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    w_bytes = sum(p.numel() * p.element_size() for p in params)
    embeds = vlm.stub_patch_embeds(gen.manual_seed(SEED + 1), VLM_BATCH, cfg,
                                   device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, v, (VLM_BATCH, VLM_PROMPT)),
                              device="cuda")
    s_in = NUM_PATCH_TOKENS + VLM_PROMPT
    print(f"[vlm] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
          f"{a.num_heads} query heads over {a.num_kv_heads} KV heads at D "
          f"{a.head_dim}, vocabulary {v} ({cfg.padded_vocab} rows, tied); "
          f"parameters: analytic {cfg.param_count()}, real {n_params} "
          f"(padded vocabulary, norms), {w_bytes / 1e9:.3f} GB bf16, made "
          f"on the card in {made:.1f} s; {VLM_BATCH} requests of "
          f"{NUM_PATCH_TOKENS} patch embeddings + {VLM_PROMPT} prompt "
          f"tokens, cache {VLM_CACHE}", flush=True)
    (first, last16, fed, prefill_ms, step_ms, pre_by, step_launches, peak,
     caches) = vlm_serve(model, cfg, embeds, prompts, "bf16")
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c)
    del caches
    measured = Counter(pre_by)
    m_key = ("fwd", "bfloat16") + FLASH_SHAPES["m"][:9]
    want_pre = {m_key: L}
    # the bounds: the prefill's products (every layer's weights over B x S
    # tokens, attention's four D-wide products over its unmasked pairs, the
    # head's over the B last positions) at the tensor cores' bf16 rate
    # beside the weights read once and the caches written once; a decode
    # step reads the weights and the caches' rows in use
    table = cfg.padded_vocab * cfg.d_model
    body = n_params - table
    pairs = unmasked_pairs(s_in, s_in, True, 0, (s_in,) * VLM_BATCH)
    pre_ops = 2 * body * VLM_BATCH * s_in + 4 * a.head_dim * a.num_heads * \
        pairs * L + 2 * table * VLM_BATCH
    pre_bound = bound(w_bytes + cache_bytes, pre_ops, BF16_FLOPS)
    rows = s_in + VLM_STEPS / 2            # the mean cache rows in use
    kv_read = cache_bytes * rows / VLM_CACHE
    step_ops = 2 * n_params * VLM_BATCH + 4 * a.head_dim * a.num_heads * \
        rows * VLM_BATCH * L
    step_bound = bound(w_bytes + kv_read, step_ops, BF16_FLOPS)
    dec = sorted(step_ms)
    step_med = dec[len(dec) // 2]
    tps = VLM_BATCH * VLM_STEPS / (sum(step_ms) / 1e3)
    wave_tps = VLM_BATCH * (VLM_STEPS + 1) / ((prefill_ms + sum(step_ms))
                                              / 1e3)
    print(f"[vlm] serve bf16: prefill {prefill_ms:.2f} ms (CUDA events; "
          f"bound {pre_bound[0]:.3f} ms by {pre_bound[1]}: {pre_ops:.3e} "
          f"FLOP, {(w_bytes + cache_bytes) / 1e9:.3f} GB), {VLM_STEPS} "
          f"greedy decode steps median {step_med:.3f} ms, mean "
          f"{sum(step_ms) / VLM_STEPS:.3f} ms (bound {step_bound[0]:.4f} ms "
          f"by {step_bound[1]}: {(w_bytes + kv_read) / 1e9:.3f} GB); "
          f"{tps:.1f} tokens/s decoding (bound "
          f"{VLM_BATCH * 1e3 / step_bound[0]:.1f}), {wave_tps:.1f} tokens/s "
          f"with the prefill; peak memory {peak / 2**30:.2f} GiB; K5 "
          f"launches prefill {dict(pre_by)} (expected {want_pre}), decode "
          f"steps {sorted(set(step_launches))} (expected [0]: the decode "
          f"attention is the plain one)", flush=True)
    if dict(pre_by) != want_pre or set(step_launches) != {0}:
        fail(f"vlm: K5 launches prefill {dict(pre_by)}, decode steps "
             f"{step_launches}; expected {want_pre}, none")
    if not bool(((fed >= 0) & (fed < v)).all().item()):
        fail("vlm: greedy tokens outside the vocabulary")
    batch = {"embeds": embeds, "tokens": prompts}
    seq = torch.cat([prompts, fed], 1)     # the last decode step's input
    with torch.inference_mode():
        k5_zero()
        ref = steps.make_prefill_step(cfg, VLM_CACHE, attn_impl="torch")(
            model, batch)[0][:, -1]
        torch_launches = k5.flash_attention.launches
        tier = logits_close(first, ref, v, "vlm prefill vs torch tier")
        pre16 = vlm.vlm_forward(model, embeds, seq)[:, -1, :v].float()
        prof_prefill = profiled("vlm_prefill", 1, lambda: steps.
                                make_prefill_step(cfg, VLM_CACHE)(model,
                                                                  batch))
        prof_prefill.update(k5_shares("vlm_prefill"),
                            top=top_kernels("vlm_prefill"))
        _, c1, n1 = steps.make_prefill_step(cfg, VLM_CACHE)(model, batch)
        prof_step = profiled("vlm_decode_step", 1, lambda: steps.
                             make_decode_step(cfg)(model, {
                                 "token": fed[:, :1], "caches": c1,
                                 "length": n1}))
        prof_step.update(top=top_kernels("vlm_decode_step"))
        del c1, ref
    print(f"[vlm] prefill logits vs torch tier max_abs_err="
          f"{tier['max_abs_err']:.3e} tol={tier['tol']:.3e} fro_rel_err="
          f"{tier['fro_rel_err']:.3e} (limit {LOGIT_FRO_LIMIT:.0e}); torch "
          f"tier K5 launches {torch_launches}", flush=True)
    if torch_launches:
        fail(f"vlm: the torch tier launched K5 {torch_launches} times")
    for name, pr in (("prefill", prof_prefill), ("decode step", prof_step)):
        if pr["idle_share"] is None:
            print(f"[vlm] profiled {name}: the profiler saw no kernel; "
                  f"device shares not measured", flush=True)
            continue
        print(f"[vlm] profiled {name}: wall {pr['wall_ms']:.2f} ms, device "
              f"busy {pr['device_busy_ms']:.2f} ms, idle share "
              f"{pr['idle_share']:.4f}, {pr['kernels']:.0f} kernels"
              + (f", K5 {pr['k5_fwd_ms']:.3f} ms "
                 f"({pr['k5_fwd_ms'] / pr['device_busy_ms']:.2%} of busy)"
                 if "k5_fwd_ms" in pr else "")
              + "; most time: " + "; ".join(f"{k} {ms:.3f} ms x{c}"
                                            for k, ms, c in pr["top"]),
              flush=True)

    # -- the decode branch: an f32 copy of the weights serves the same
    # requests (its last decode logits against its own fresh vlm_forward),
    # and is the yardstick of the bf16 wave's
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = TransformerLM(cfg32, device="cuda", generator=gen.manual_seed(SEED))
    m32.load_state_dict(model.state_dict())
    (_, last32, fed32, _, _, pre_by32, _, _, c32) = vlm_serve(
        m32, cfg32, embeds, prompts, "f32")
    del c32
    measured += pre_by32
    with torch.inference_mode():
        fwd32 = vlm.vlm_forward(m32, embeds, torch.cat([prompts, fed32], 1)
                                )[:, -1, :v]
        truth = vlm.vlm_forward(m32, embeds, seq)[:, -1, :v]
    f32_limit = F32_BAND * SCALE
    consistency = []
    for r in range(VLM_BATCH):
        rec = {"f32_decode_vs_forward": fro_rel(last32[r, :v], fwd32[r]),
               "bf16_decode_vs_f32": fro_rel(last16[r, :v], truth[r]),
               "bf16_forward_vs_f32": fro_rel(pre16[r], truth[r]),
               "bf16_decode_vs_forward": fro_rel(last16[r, :v], pre16[r]),
               "bf16_argmax_equal": int(last16[r, :v].argmax()) ==
               int(pre16[r].argmax())}
        consistency.append(rec)
        print(f"[vlm] request {r}: f32 last decode logits vs a fresh f32 "
              f"vlm_forward over its {VLM_CACHE} positions fro_rel_err="
              f"{rec['f32_decode_vs_forward']:.3e} (limit {f32_limit:.0e});"
              f" bf16 last decode logits vs the f32 forward of the same "
              f"positions {rec['bf16_decode_vs_f32']:.3e}, a bf16 forward's "
              f"{rec['bf16_forward_vs_f32']:.3e} (limit {SSM_DECODE_SLACK} "
              f"x), bf16 decode vs bf16 forward "
              f"{rec['bf16_decode_vs_forward']:.3e} (not held; phases 6 "
              f"and 20 hold {LOGIT_FRO_LIMIT:.0e} on prefills), argmax "
              f"equal {rec['bf16_argmax_equal']}", flush=True)
        if not (bool(torch.isfinite(last16[r]).all().item())
                and rec["f32_decode_vs_forward"] <= f32_limit
                and rec["bf16_decode_vs_f32"] <=
                SSM_DECODE_SLACK * rec["bf16_forward_vs_f32"]):
            fail(f"vlm: request {r}: the decode branch is off ({rec})")
    serve = {"params": n_params, "weight_bytes": w_bytes,
             "cache_bytes": cache_bytes, "prefill_ms": prefill_ms,
             "prefill_bound_ms": pre_bound[0],
             "prefill_bound_by": pre_bound[1], "decode_step_ms": step_ms,
             "decode_step_median_ms": step_med,
             "decode_step_bound_ms": step_bound[0],
             "decode_step_bound_by": step_bound[1], "tokens_per_s": tps,
             "tokens_per_s_bound": VLM_BATCH * 1e3 / step_bound[0],
             "wave_tokens_per_s": wave_tps, "peak_bytes": peak,
             "prefill_launches": sum(pre_by.values()), "step_launches":
             step_launches, "vs_torch_tier": tier,
             "decode_consistency": consistency,
             "profile_prefill": prof_prefill,
             "profile_decode_step": prof_step}
    del model, m32, params, embeds, first, last16, last32, pre16, fwd32
    del truth
    torch.cuda.empty_cache()

    # -- a text-only wave through launch/serve.py (the reference's engine
    # takes no embeddings)
    k5_zero()
    serve_launch.main(["--arch", "internvl2-1b", "--requests", "8",
                       "--max-tokens", "16"])
    text_launches = k5.flash_attention.launches
    print(f"[vlm] text-only wave through launch/serve.py: K5 launches "
          f"{text_launches} (expected {L} x 8 prefills)", flush=True)
    if text_launches != 8 * L:
        fail(f"vlm text-only wave: K5 launched {text_launches} times, "
             f"expected {8 * L}")
    serve["text_wave_launches"] = text_launches
    torch.cuda.empty_cache()

    # -- training at full width and depth, f32, patches + tokens
    need_free("internvl2-1b training", VLM_TRAIN_MIN_FREE)
    tcfg = train_lm.make_config("internvl2-1b", width="full")
    skel = TransformerLM(tcfg, device="meta")

    def loss_fn(params, bt, impl):
        return lm_loss(skel, bt["tokens"], bt["labels"], bt["embeds"],
                       params=params, attn_impl=impl)
    train = drive_lm_trainer(
        tcfg, "vlm_train", "vlm-train",
        f"{tcfg.name} f32 full width and depth, {tcfg.num_layers} layers, "
        f"{tcfg.param_count() / 1e9:.3f} B params, batch {VLM_TRAIN_BATCH}"
        f" x ({NUM_PATCH_TOKENS} patches + "
        f"{VLM_TRAIN_SEQ - NUM_PATCH_TOKENS} tokens)", loss_fn,
        (tcfg.num_layers, 2 * tcfg.num_layers), VLM_TRAIN_STEPS,
        VLM_TRAIN_BATCH, VLM_TRAIN_SEQ)
    measured += train.pop("by_shape")

    # -- gemma-7b and deepseek-67b through the ServeEngine at full width
    dense = {}
    for name, (layers, need) in DENSE_WAVES.items():
        dense[name] = serve_dense(name, layers, need)
        shape = "p" if name == "gemma-7b" else "q"
        measured[("fwd", "bfloat16") + FLASH_SHAPES[shape][:9]] += \
            dense[name]["launches_2048"]
    by_shape = named_shapes(measured, "vlm", "bf16 and f32 image+prompt "
                            "prefills, Trainer steps, first bf16 training "
                            "step, the dense waves' 2048-token prefills")
    return {"flash": flash, "flash_bwd": flash_bwd, "serve": serve,
            "train": train, "dense": dense, "by_shape": by_shape}


#: phase 23: granite-3-8b at its published width through launch/train.py,
#: depth cut to LAUNCH_LAYERS of 40 (full depth with AdamW's f32 moments
#: does not fit one card's 80 GB), LAUNCH_BATCH x LAUNCH_SEQ tokens,
#: remat "selective", LAUNCH_STEPS steps, no checkpoints
LAUNCH_LAYERS = 8
LAUNCH_BATCH = 2
LAUNCH_SEQ = 4096
LAUNCH_STEPS = 3
#: phase 23: the dry run's per-device peak against the measured one
LAUNCH_PEAK_TOL = 0.25
#: phase 23 (a): host calls timed a dispatch route
LAUNCH_HOST_CALLS = 50
#: phase 23 (a): host calls timed a route of a forward and backward
LAUNCH_TRAIN_CALLS = 20


def dryrun_start() -> list:
    """Phase 23 (d)'s subprocesses (one default process group a process),
    started before phase 2's build, so that their traces on the host
    (fake tensors: no card work) share it with the build alone and with
    no measured phase: the production dry run of granite-3-8b x train_4k
    on the single-pod and on the multi-pod mesh, one process each, and
    ``profile_cell`` of its single-pod cell.  Returns (name, Popen, log
    path) triples for ``dryrun_finish``, which ``main`` calls right after
    the build."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    procs = []
    for name, mod, extra in (
            ("dryrun_single", "repro_torch.launch.dryrun",
             ["--mesh", "single"]),
            ("dryrun_multi", "repro_torch.launch.dryrun",
             ["--mesh", "multi"]),
            ("profile_cell", "repro_torch.launch.profile_cell",
             ["--mesh", "single", "--top", "12"])):
        log = out / f"launch_{name}.log"
        cmd = [sys.executable, "-m", mod, "--arch", "granite-3-8b",
               "--shape", "train_4k", *extra]
        procs.append((name, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=open(log, "w"),
            stderr=subprocess.STDOUT), log))
    atexit.register(dryrun_stop, procs)   # a failed phase leaves none
    return procs


def dryrun_stop(procs) -> None:
    """Kill ``dryrun_start``'s processes that still run."""
    for _, proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_finish(procs, timeout: float = 900) -> dict:
    """Phase 23 (d): wait for ``dryrun_start``'s processes; each must exit
    0.  Prints each mesh's per-device peak, FLOPs, collective bytes by
    kind, roofline and fits_80g from the dry run's records, and fails
    unless K5's op is among profile_cell's top FLOP entries."""
    out = {}
    for name, proc, log in procs:
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"launch {name}: no exit within {timeout:.0f} s")
        text = log.read_text()
        if rc != 0:
            print(text[-3000:], flush=True)
            fail(f"launch {name}: exit {rc} (log {log})")
        out[name] = text
    recs = {}
    for mesh in ("single", "multi"):
        path = ROOT / "experiments" / "dryrun_torch" / \
            f"granite-3-8b_train_4k_{mesh}.json"
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            fail(f"launch dryrun {mesh}: {rec.get('error')}")
        rl = rec["roofline"]
        print(f"[launch] dry run granite-3-8b x train_4k x {mesh} "
              f"({rec['chips']} ranks, cuda tier on fake CUDA tensors, "
              f"remat {rec['remat']}): peak/device "
              f"{rec['peak_bytes_per_device'] / 2**30:.2f} GiB, fits_80g "
              f"{rec['fits_80g']}; flops {rec['flops']:.4e} (products "
              f"{rec['dot_flops']:.4e}), bytes {rec['hbm_bytes']:.4e}; "
              f"collective bytes {json.dumps(rec['collective'])}; "
              f"roofline on H100: dominant {rl['dominant']}, compute "
              f"{rl['compute_s']:.4f} s, memory {rl['memory_s']:.4f} s, "
              f"collective {rl['collective_s']:.4f} s, fraction "
              f"{rl['roofline_fraction']:.4f} (a prediction from a trace, "
              f"not a measurement); traced in {rec['compile_s']} s",
              flush=True)
        recs[mesh] = rec
    top = out["profile_cell"].split("-- top FLOPs --")[-1]
    print("[launch] profile_cell granite-3-8b x train_4k x single, top "
          "FLOP entries:\n" + top.strip(), flush=True)
    if "repro_torch.flash_attention" not in top:
        fail("launch profile_cell: K5's op is not among the top FLOP "
             "entries")
    return {"records": recs, "profile_top_flops": top.strip()}


def host_us(fn, n: int) -> float:
    """Host microseconds a call of ``fn`` (launches only: the card syncs
    before and after, outside the clock)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def check_k5_op() -> list:
    """Phase 23 (a): K5 through its opaque ops against the direct
    launches (``_launch``, ``_launch_bwd``) at FLASH_SHAPES (a) and (o),
    f32 and bf16: out, lse, dq, dk and dv bit for bit; the op's host cost
    a forward call beside the direct launch's, and of a forward and
    backward under ``autograd.grad`` beside a plain ``autograd.Function``
    over the direct launches (the control: K5 before it was an op) and the
    direct launches alone."""
    import torch
    from repro_torch.kernels import flash_attention as k5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for name in ("a", "o"):
        b, hq, hkv, sq, sk, d, causal, window, cap, _ = FLASH_SHAPES[name]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (torch.randn(shp, generator=gen, device="cuda",
                                         dtype=dtype)
                             for shp in ((b, hq, sq, d), (b, hkv, sk, d),
                                         (b, hkv, sk, d), (b, hq, sq, d)))
            kw = dict(causal=causal, window=window, softcap=cap)
            args = (q, k, v, None, causal, window, cap, True)
            out, lse = torch.ops.repro_torch.flash_attention(*args)
            dout_, dlse = k5._launch(q, k, v, None, return_lse=True, **kw)
            grads = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, out, lse, dout, None, causal, window, cap)
            dgrads = k5._launch_bwd(q, k, v, out, lse, dout, None, **kw)
            same = torch.equal(out, dout_) and torch.equal(lse, dlse) and \
                all(torch.equal(a, c) for a, c in zip(grads, dgrads))
            op_us = host_us(lambda: torch.ops.repro_torch.flash_attention(
                *args), LAUNCH_HOST_CALLS)
            direct_us = host_us(lambda: k5._launch(
                q, k, v, None, return_lse=True, **kw), LAUNCH_HOST_CALLS)
            wrap_us = host_us(lambda: k5.flash_attention(
                q, k, v, return_lse=True, **kw), LAUNCH_HOST_CALLS)
            qg = q.detach().requires_grad_()

            class Direct(torch.autograd.Function):
                """The control: the direct launches under a plain
                autograd.Function, as K5 ran before it was an op."""

                @staticmethod
                def forward(ctx, q_):
                    o, lse_ = k5._launch(q_, k, v, None, return_lse=True,
                                         **kw)
                    ctx.save_for_backward(q_, o, lse_)
                    return o

                @staticmethod
                def backward(ctx, do):
                    q_, o, lse_ = ctx.saved_tensors
                    return k5._launch_bwd(q_, k, v, o, lse_, do.contiguous(),
                                          None, **kw)[0]

            def direct_train():
                o, lse_ = k5._launch(q, k, v, None, return_lse=True, **kw)
                k5._launch_bwd(q, k, v, o, lse_, dout, None, **kw)
            train_us = host_us(lambda: torch.autograd.grad(
                k5.flash_attention(qg, k, v, **kw), qg, dout),
                LAUNCH_TRAIN_CALLS)
            fn_train_us = host_us(lambda: torch.autograd.grad(
                Direct.apply(qg), qg, dout), LAUNCH_TRAIN_CALLS)
            direct_train_us = host_us(direct_train, LAUNCH_TRAIN_CALLS)
            dt = str(dtype).removeprefix("torch.")
            print(f"[launch] K5 op ({name}) {dt}: forward and backward bit "
                  f"for bit the direct launches {same}; host us a forward "
                  f"call: op {op_us:.1f}, flash_attention wrapper "
                  f"{wrap_us:.1f}, direct _launch {direct_us:.1f}; a "
                  f"forward and backward under autograd.grad: the wrapper "
                  f"{train_us:.1f}, an autograd.Function over the direct "
                  f"launches {fn_train_us:.1f}; the direct launches alone "
                  f"{direct_train_us:.1f}", flush=True)
            if not same:
                fail(f"launch: K5's op at ({name}) {dt} is not the direct "
                     f"launch bit for bit")
            rows.append({"shape": name, "dtype": dt, "bitwise": same,
                         "op_host_us": op_us, "wrapper_host_us": wrap_us,
                         "direct_host_us": direct_us,
                         "train_host_us": train_us,
                         "function_train_host_us": fn_train_us,
                         "direct_train_host_us": direct_train_us})
            del q, k, v, dout, out, lse, grads, dgrads, dout_, dlse, qg
    torch.cuda.empty_cache()
    return rows


def drive_launch() -> dict:
    """Phase 23: the LM launch layer on the card.  (a) ``check_k5_op``;
    (b) granite-3-8b at full width, LAUNCH_LAYERS of 40 layers, bf16,
    through ``launch/train.py::build_trainer`` on a (1, 1) mesh over a
    world-size-1 NCCL group: LAUNCH_STEPS steps of LAUNCH_BATCH x
    LAUNCH_SEQ tokens with remat "selective", K5's launches by shape (a
    step: a forward, its recompute and a backward pair a layer), step 0's
    loss and every gradient bit for bit the same step on plain tensors
    without a mesh and the mesh step with remat "none", step ms, idle
    share, peak memory; (c) ``launch/dryrun.py::run_cell`` of the same
    config, batch and remat on the same mesh over fake CUDA tensors: its
    state bytes exactly the real state's, its peak within LAUNCH_PEAK_TOL
    of steps 0-2's, the model-FLOPs utilisation of the measured step.
    (d) is ``dryrun_start`` and ``dryrun_finish``, around phase 2."""
    import statistics

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.config import ShapeSpec, get_config, override
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import sharding_rules
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.optimizer import tree_leaves

    t0 = time.perf_counter()
    k5_rows = check_k5_op()
    smi = nvidia_smi()

    store = ROOT / "build" / "launch" / "store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    cfg = override(get_config("granite-3-8b"), num_layers=LAUNCH_LAYERS)
    opt = dryrun.default_opt(cfg)
    shape = ShapeSpec("train_cli", LAUNCH_SEQ, LAUNCH_BATCH, "train")
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[launch] {free / 1e9:.1f} GB of {total / 1e9:.1f} GB free on "
          f"the card before the launcher", flush=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr, mesh, rules = build_trainer(
        cfg, steps=LAUNCH_STEPS, batch=LAUNCH_BATCH, seq=LAUNCH_SEQ,
        remat="selective", ckpt_dir=str(ROOT / "build" / "launch" / "ckpt"),
        device="cuda", checkpoint_every=0, log_every=1, opt=opt)
    k5_zero()
    with sharding_rules(mesh, rules):
        res = tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    by = k5_by_shape()
    key = ("bfloat16", LAUNCH_BATCH, 32, 8, LAUNCH_SEQ, LAUNCH_SEQ, 128,
           True, 0, 0.0)
    want = {("fwd",) + key: 2 * LAUNCH_LAYERS * LAUNCH_STEPS,
            ("bwd",) + key: 2 * LAUNCH_LAYERS * LAUNCH_STEPS}
    print(f"[launch] granite-3-8b {LAUNCH_LAYERS} of 40 layers (d_model "
          f"{cfg.d_model}, {cfg.attention.num_heads} heads over "
          f"{cfg.attention.num_kv_heads} KV heads at D "
          f"{cfg.attention.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, {cfg.param_count() / 1e9:.3f} B "
          f"parameters) on a {tuple(mesh.shape)} mesh over a world-size-1 "
          f"NCCL group: {LAUNCH_STEPS} steps of {LAUNCH_BATCH} x "
          f"{LAUNCH_SEQ} tokens, remat selective; K5 launches by shape "
          f"{dict(by)}", flush=True)
    if dict(by) != want:
        fail(f"launch: K5 launches {dict(by)}, expected {want} (a step: a "
             f"forward, its recompute and one backward pair a layer)")
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    step_ms = [h["dt"] * 1e3 for h in hist]
    state = res["state"]
    state_bytes = sum(t.to_local().numel() * t.element_size()
                      if isinstance(t, DTensor) else
                      t.numel() * t.element_size()
                      for t in tree_leaves(state))
    if not all(torch.isfinite(torch.tensor(losses))):
        fail(f"launch: losses {losses} not finite")
    # an extra step under the profiler: device busy and idle share
    batch3 = shard_batch(tr.pipeline.batch_at(LAUNCH_STEPS),
                         tr.batch_shardings)
    with sharding_rules(mesh, rules):
        win = profiled("launch_step", 1, lambda: tr.step_fn(state, batch3))
    del state, res, batch3
    torch.cuda.empty_cache()

    # step 0, bit for bit: the mesh step (selective and none) and the plain
    # step on the same weights and batch
    batch0 = tr.pipeline.batch_at(0)
    grads = {}
    with sharding_rules(mesh, rules):
        s0 = tr.make_state()
        placed = shard_batch(batch0, tr.batch_shardings)
        for remat in ("selective", "none"):
            g, m = make_loss_and_grads(cfg, remat)(s0.params, placed)
            grads[remat] = (m["loss"].full_tensor(),
                            {k: v.to_local() for k, v in g.items()})
            del g
        del s0, placed
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    plain = {k: p.detach() for k, p in init_lm(
        cfg, generator=gen, device="cuda").named_parameters()}
    gp, mp = make_loss_and_grads(cfg, "selective")(
        plain, {k: torch.as_tensor(v).cuda() for k, v in batch0.items()})
    grads["plain"] = (mp["loss"], gp)
    del plain
    ref_loss, ref = grads["plain"]
    bitwise = {}
    for name in ("selective", "none"):
        loss, g = grads[name]
        bitwise[name] = bool(torch.equal(loss, ref_loss)) and all(
            torch.equal(g[k], ref[k]) for k in ref)
    print(f"[launch] step 0: loss {float(ref_loss):.6f}; the (1, 1)-mesh "
          f"step (selective) bit for bit the plain step: "
          f"{bitwise['selective']}; the mesh step with remat none bit for "
          f"bit it too: {bitwise['none']} ({len(ref)} gradients each)",
          flush=True)
    if not all(bitwise.values()):
        diff = {n: [k for k in ref if not torch.equal(grads[n][1][k],
                                                      ref[k])][:5]
                for n in bitwise}
        fail(f"launch: step 0 is not bit for bit the plain step: {diff}")
    del grads, gp, ref
    torch.cuda.empty_cache()
    med = statistics.median(step_ms[1:])
    print(f"[launch] steps: loss {['%.6f' % x for x in losses]}, host ms a "
          f"step {['%.1f' % x for x in step_ms]} (median of steps 1-"
          f"{LAUNCH_STEPS - 1}: {med:.1f}); a profiled step: device busy "
          f"{win['device_busy_ms']:.1f} ms of {win['wall_ms']:.1f} ms, idle "
          f"share {win['idle_share']:.4f}; peak memory of steps 0-"
          f"{LAUNCH_STEPS - 1} {peak / 2**30:.2f} GiB; state "
          f"{state_bytes / 2**30:.3f} GiB on {smi.strip()}", flush=True)

    # (c) the dry run of the same step on the same mesh
    rec = dryrun.run_cell("granite-3-8b", "train_cli", "test", cfg=cfg,
                          shape=shape, remat="selective", mesh=mesh,
                          device="cuda", out_dir=None, verbose=False)
    if rec["status"] != "ok":
        print(rec.get("traceback", ""), flush=True)
        fail(f"launch: the dry run of the card's step failed: "
             f"{rec.get('error')}")
    pred = rec["peak_bytes_per_device"]
    mfu = rec["model_flops"] / (med / 1e3 * BF16_FLOPS)
    print(f"[launch] dry run of this step on the (1, 1) mesh (fake CUDA "
          f"tensors, traced in {rec['compile_s']} s): state bytes "
          f"{rec['state_bytes_per_device']} vs the real state's "
          f"{state_bytes}; peak {pred / 2**30:.2f} GiB vs measured "
          f"{peak / 2**30:.2f} GiB ({pred / peak - 1:+.1%}); flops "
          f"{rec['flops']:.4e}, model flops {rec['model_flops']:.4e}; "
          f"model-FLOPs utilisation of the measured step "
          f"model_flops / (ms x bf16 peak {BF16_FLOPS:.3g}) = {mfu:.4f}",
          flush=True)
    if rec["state_bytes_per_device"] != state_bytes:
        fail(f"launch: the dry run's state bytes "
             f"{rec['state_bytes_per_device']} != the real state's "
             f"{state_bytes}")
    if abs(pred / peak - 1) > LAUNCH_PEAK_TOL:
        fail(f"launch: the dry run's peak {pred} is off the measured "
             f"{peak} by more than {LAUNCH_PEAK_TOL:.0%}")
    dist.destroy_process_group()
    t_abc = time.perf_counter() - t0
    return {"k5_op": k5_rows, "launches": {"/".join(map(str, k)): n
                                           for k, n in by.items()},
            "losses": losses, "step_ms": step_ms, "median_step_ms": med,
            "window": win, "peak_bytes": peak, "state_bytes": state_bytes,
            "bitwise": bitwise, "dryrun_card": {
                k: rec[k] for k in ("flops", "dot_flops", "hbm_bytes",
                                    "peak_bytes_per_device",
                                    "state_bytes_per_device",
                                    "model_flops", "compile_s")},
            "mfu": mfu, "abc_s": t_abc, "nvidia_smi": smi}


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

    # -- 23 (d) starts here: the production dry run's traces (host only,
    # fake tensors) run beside the build, which no phase measures
    procs = dryrun_start()

    # -- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {len(_build.SOURCES)} kernel libraries ready; "
          f"{len(logs)} compiled now in {time.perf_counter() - t0:.1f} s "
          f"(the rest were built earlier from the same sources)", flush=True)
    t1 = time.perf_counter()
    dry = dryrun_finish(procs)
    dry["wait_s"] = time.perf_counter() - t1
    print(f"[launch] the dry runs ended {dry['wait_s']:.1f} s after the "
          f"build; {time.perf_counter() - t0:.1f} s with it", flush=True)
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
    for kern in K5_BWD_BF16_KERNELS:
        sass[kern] = check_sass("flash_attention", kern, "BF16")
    for kern in K5_BWD_F32_KERNELS:
        sass[kern] = check_sass("flash_attention", kern, "TF32")
    sass["fused_agg_combine_pairs"] = check_k2_pairs(sass["fused_agg_combine"])

    # -- 3. kernels against their plain versions
    t0 = time.perf_counter()
    g_red, x_red, y_red, spec_red = load_dataset("reddit", seed=SEED,
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
    records += check_kernels_bf16(g_red, spec_red)
    long_rows = check_k1_long_rows()
    clear_plan_cache()

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
    ref13 = logits[("gcn", False)]     # phase 13's yardstick
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
    compiled = drive_compiled(models, g_red, x_red, y_red, spec_red)
    print(f"[compiled] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 9. characterization: per-phase reports of the same forwards
    t0 = time.perf_counter()
    reports = characterize(models, g_red, x_red)
    print(f"[report] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 10. the planner's other decisions on the same models
    t0 = time.perf_counter()
    decisions, dlaunches = drive_decisions(models, g_red, x_red, forwards)
    print(f"[decisions] launches over the phase {dlaunches}; phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del models
    clear_plan_cache()          # drops the plans' layouts and CUDA graphs
    torch.cuda.empty_cache()

    # -- 11. minibatch GraphSAGE training on Reddit
    t0 = time.perf_counter()
    train = drive_train(g_red, x_red, y_red, spec_red)
    print(f"[train] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    clear_plan_cache()
    torch.cuda.empty_cache()

    # -- 12. GCN node-prediction serving on Reddit
    t0 = time.perf_counter()
    serve = drive_serve(g_red, x_red, spec_red)
    print(f"[serve] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    clear_plan_cache()
    torch.cuda.empty_cache()

    # -- 13. distributed inference on LocalMeshes of this card
    t0 = time.perf_counter()
    dist13 = drive_distributed(g_red, x_red, spec_red, ref13,
                               forwards["gcn_unfused"])
    print(f"[dist] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    del ref13
    clear_plan_cache()
    torch.cuda.empty_cache()

    # -- 14. distributed training on LocalMeshes of this card
    t0 = time.perf_counter()
    dist14 = drive_dist_train(g_red, x_red, y_red, spec_red)
    print(f"[dist-train] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 15. the same plans compiled: CUDA graphs of forwards and steps
    t0 = time.perf_counter()
    dist15 = drive_dist_compiled(g_red, x_red, y_red, spec_red)
    print(f"[dist-compiled] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 16. static checks of the plans above, from fake-tensor traces
    analysis = drive_analysis(g_red, x_red, spec_red)
    clear_plan_cache()
    torch.cuda.empty_cache()

    # -- 17. the paper's Table-4 launchers
    t0 = time.perf_counter()
    paper = drive_paper(g_red, x_red)
    print(f"[paper] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    del g_red, x_red, y_red
    clear_plan_cache()
    torch.cuda.empty_cache()

    # -- 5. K5 against its plain version (its shape (l) in phase 20, (m)-(q)
    # in phase 22)
    flash = check_flash([n for n in FLASH_SHAPES
                         if n != "l" and n not in VLM_FLASH])

    # -- 6. the LM serving path: gemma2-9b through the ServeEngine
    t0 = time.perf_counter()
    lm = drive_lm()
    print(f"[lm] phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 7. K5's f32 path from the LM entry point
    lm_f32 = drive_lm_f32()

    # -- 18. LM training: K5's backward kernels, then gemma2-9b steps
    t0 = time.perf_counter()
    flash_bwd = check_flash_bwd([n for n in FLASH_BWD_SHAPES
                                 if n not in VLM_FLASH])
    lm_train = drive_lm_train()
    print(f"[lm-train] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 19. the enc-dec path: seamless-m4t-medium serving and training
    t0 = time.perf_counter()
    encdec = drive_encdec()
    print(f"[encdec] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 20. MoE: arctic-480b at full width, K5 at its GQA-7 prefill
    t0 = time.perf_counter()
    moe = drive_moe()
    print(f"[moe] phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 21. the SSM path: mamba2-2.7b serving at full width and depth,
    # training at full width
    t0 = time.perf_counter()
    ssm = drive_ssm()
    print(f"[ssm] phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 22. the VLM frontend: internvl2-1b serving image+prompt requests
    # and training at full width and depth; gemma-7b and deepseek-67b waves
    t0 = time.perf_counter()
    vlm = drive_vlm()
    print(f"[vlm] phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 23. the LM launch layer: K5 as an opaque op, granite-3-8b through
    # launch/train.py on a (1, 1) mesh, the dry run against the card
    t0 = time.perf_counter()
    launch = drive_launch()
    launch["dryrun"] = dry
    print(f"[launch] phase took {time.perf_counter() - t0:.1f} s "
          f"((a)-(c) {launch['abc_s']:.1f} s)", flush=True)
    print(f"[main] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": kind, "nvidia_smi": smi, "launches": counts,
         "peak_bytes": peak, "records": records, "flash": flash, "lm": lm,
         "lm_f32": lm_f32, "flash_bwd": flash_bwd, "lm_train": lm_train,
         "encdec": encdec, "moe": moe, "ssm": ssm, "vlm": vlm,
         "launch": launch,
         "sass_tf32_hgmma": sass,
         "forwards_ms": forwards, "compiled": compiled, "reports": reports,
         "decisions": decisions, "decision_launches": dlaunches,
         "train": train, "serve": serve, "long_rows": long_rows,
         "distributed": dist13, "dist_train": dist14,
         "dist_compiled": dist15, "analysis": analysis, "paper": paper},
        indent=1))

    # one line per kernel: the first record of each at Reddit's main shape;
    # the f32 instances' launches are phase 4's, the bf16 ones phase 10's
    main_shape = {"seg_agg": (128, 128), "seg_agg_bf16": (128, 128),
                  "fused_agg_combine": (602, 128),
                  "fused_agg_combine_bf16": (602, 128)}
    k1_src = ("src/repro_torch/csrc/seg_agg.cu",
              "src/repro/kernels/seg_agg.py:74")
    k2_src = ("src/repro_torch/csrc/fused_agg_combine.cu",
              "src/repro/kernels/fused_agg_combine.py:73")
    source = {"seg_agg": k1_src, "seg_agg_bf16": k1_src,
              "fused_agg_combine": k2_src, "fused_agg_combine_bf16": k2_src}
    kernels = []
    for kname, (src, replaces) in source.items():
        rec = next(r for r in records if r["name"] == kname and
                   r["graph"] == "reddit" and r.get("pair", "bf16") == "bf16"
                   and (r["f_in"], r["f_out"]) == main_shape[kname])
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": counts[kname] if kname in counts
            else dlaunches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in records
                               if r["name"] == kname),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "frac_of_bound": rec["frac_of_bound"],
            "vs_library": rec["vs_library"]})
    # K1's backward at F=128: its launches are phase 11's 20-step none
    # run's on the host (the step's warm-up and its capture; each replay
    # runs the captured ones), its error the larger of the F=128 and F=41
    # checks
    rec = train["k1_bwd"][0]
    kernels.append({
        "name": "seg_agg_bwd", "route": "cuda", "source": k1_src[0],
        "replaces": k1_src[1], "launches": train["launches"]["seg_agg_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in train["k1_bwd"]),
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "frac_of_bound": rec["frac_of_bound"],
        "vs_library": rec["vs_library"]})
    # K1 over bf16 x with an f32 output at F = 128, summed over the 16 ring
    # sub-layouts (one layer's halo sums): its launches are phase 13's bf16
    # forward's
    rec = dist13["k1_bf16_f32"][0]
    kernels.append({
        "name": "seg_agg_bf16_f32", "route": "cuda", "source": k1_src[0],
        "replaces": k1_src[1], "launches": dist13["launches_bf16_f32"],
        "max_abs_err": max(r["max_abs_err"] for r in dist13["k1_bf16_f32"]),
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
        "frac_of_bound": rec["frac_of_bound"],
        "vs_library": rec["vs_library"]})
    # K1's backward over the 16 capped transposed ring sub-layouts at F =
    # 128, summed (one layer's backward sums, the pieces and the cut rows'
    # fold-backs): its launches are phase 14's ring/none run's backward
    # launches
    rec = dist14["k1_bwd_shards"][0]
    kernels.append({
        "name": "seg_agg_bwd_shards", "route": "cuda", "source": k1_src[0],
        "replaces": k1_src[1], "launches": dist14["bwd_launches"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in dist14["k1_bwd_shards"]),
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
    # K5's backward at shape (a): f32 launched by phase 18's Trainer steps,
    # bf16 by its bf16 step
    for dtype, launches in (("bfloat16", lm_train["bf16_launches"][1]),
                            ("float32", lm_train["launches"][1])):
        rec = next(r for r in flash_bwd if r["shape"] == "a" and
                   r["dtype"] == dtype)
        kernels.append({
            "name": "flash_attention_bwd_" + ("bf16" if dtype == "bfloat16"
                                              else "f32"),
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:111",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in flash_bwd
                               if r["dtype"] == dtype),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "frac_of_bound": rec["frac_of_bound"],
            "vs_library": rec["vs_library"]})
    # K5 at seamless-m4t-medium's shapes (g)-(k), forward and backward:
    # launches are phase 19's at that shape's function as the wrapper
    # counted them (``by_shape``; the training forward's encoder and
    # cross-attention run (g)'s function at batch 2); the backward at (h)
    # and (j), off the training path, is in chip_smoke.json only
    # and phase 22's at internvl2-1b's (m) and (o), gemma-7b's (p) and
    # deepseek-67b's (q)
    for recs, part, by in ((flash, "", encdec["by_shape"]),
                           (flash_bwd, "bwd", encdec["by_shape"]),
                           (vlm["flash"], "", vlm["by_shape"]),
                           (vlm["flash_bwd"], "bwd", vlm["by_shape"])):
        for rec in recs:
            key = "/".join(([part] if part else []) +
                           [rec["dtype"], rec["shape"]])
            if key not in by:
                continue
            kernels.append({
                "name": "flash_attention_" + (part + "_" if part else "")
                + ("bf16" if rec["dtype"] == "bfloat16" else "f32")
                + "_" + rec["shape"],
                "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:111",
                "shape": rec["shape"],
                "launches": by[key],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                "frac_of_bound": rec["frac_of_bound"],
                "vs_library": rec["vs_library"]})
    # K5 bf16 at arctic's shape (l): launched by phase 20's wave, at its
    # 4080-token prompt's two layers, as the wrapper counted them
    rec = next(r for r in moe["flash"] if r["dtype"] == "bfloat16")
    kernels.append({
        "name": "flash_attention_bf16_l", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:111", "shape": "l",
        "launches": moe["launches_l"], "max_abs_err": rec["max_abs_err"],
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
    if sys.argv[1:2] == ["--dist-nccl"]:
        import torch
        if not (torch.cuda.is_available()
                and (ROOT / "src" / "repro_torch").is_dir()):
            fail("--dist-nccl needs a card and a checkout")
        dist_nccl(sys.argv[2])
    elif sys.argv[1:2] == ["--serve-fresh"]:
        import torch
        if not (torch.cuda.is_available()
                and (ROOT / "src" / "repro_torch").is_dir()):
            fail("--serve-fresh needs a card and a checkout")
        serve_fresh(sys.argv[2])
    else:
        main()
