"""The pod dry run (``repro/launch/dryrun.py``): every (arch x input shape x
mesh) cell traced for one rank of a 256- or 512-rank mesh, in one process.

For each cell:
  * opens a ``"fake"`` process group of the mesh's world size
    (``launch/mesh.py::open_fake_group``; its collectives move nothing)
    and builds the production mesh over it;
  * under ``FakeTensorMode`` (nothing is allocated, no kernel launches)
    places the abstract state or parameters and the inputs as DTensors by
    ``launch/specs.py``'s placements, under the arch's sharding rules;
  * runs one step -- ``make_train_step`` (loss, backward, AdamW),
    ``make_prefill_step`` or ``make_decode_step``, the serving outputs
    placed as ``serve_out_pspecs`` says -- and counts it per device
    (``core/op_cost.py``): FLOPs, bytes, collective bytes by kind, the
    peak of live local bytes;
  * writes one JSON record per cell under ``experiments/dryrun_torch/``
    with the reference's keys (``fits_80g`` against the H100's HBM in
    place of ``fits_16g``; the roofline on ``profile/machine.py::H100``).

The reference compiles for 512 placeholder XLA devices on the CPU.  Here
``--device cpu`` traces the torch tier on fake CPU tensors (its blockwise
attention), ``--device cuda`` (the default, on a card) the cuda tier on
fake CUDA tensors, where K5 is one opaque op.  A cell whose arch needs a
region the port has not ported yet (context-parallel attention: heads
that do not divide the `model` axis; expert parallelism: MoE) records
``status: "error"`` with that ``NotImplementedError``, as the reference
records a failing cell.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch granite-3-8b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.config import OptimizerConfig, SHAPES_BY_NAME, get_config
from repro_torch.core import op_cost
from repro_torch.core.backend import resolve_device
from repro_torch.core.characterize import cost_from_compiled, roofline
from repro_torch.launch.mesh import (make_production_mesh, num_chips,
                                     open_fake_group)
from repro_torch.launch.sharding import rules_for, sharding_rules
from repro_torch.launch.specs import (abstract_model, abstract_params,
                                      abstract_state, arch_attn_tp,
                                      input_pspecs, input_specs,
                                      param_pspecs, serve_out_pspecs,
                                      state_pspecs)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.transformer import _Bound
from repro_torch.optim.optimizer import tree_leaves, tree_map
from repro_torch.profile.machine import H100

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

#: the ten archs the reference's dry run covers, in its order
#: (``repro/configs/__init__.py::ASSIGNED_ARCHS``)
ASSIGNED_ARCHS = ("kimi-k2-1t-a32b", "arctic-480b", "deepseek-67b",
                  "gemma2-9b", "gemma-7b", "granite-3-8b",
                  "jamba-1.5-large-398b", "internvl2-1b",
                  "seamless-m4t-medium", "mamba2-2.7b")

#: an H100's HBM (80 GB), against which ``fits_80g`` holds a cell's peak
HBM_BYTES = 80 * 2 ** 30


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); forward only (2 N
    D) for serving; a decode step is one token a row."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def default_opt(cfg) -> OptimizerConfig:
    """bf16 moments above ~100B parameters (the reference's choice: f32
    Adam state alone would not fit at kimi-k2 scale)."""
    big = cfg.param_count() > 100e9
    return OptimizerConfig(moment_dtype="bfloat16" if big else "float32")


def _placed(t: torch.Tensor, placements, mesh, device):
    """A fake tensor of ``t``'s shape and dtype on ``device`` as a DTensor
    of ``placements`` (call under ``FakeTensorMode``)."""
    from torch.distributed.tensor import distribute_tensor
    fake = torch.empty(t.shape, dtype=t.dtype, device=device)
    return distribute_tensor(fake, mesh, list(placements), src_data_rank=None)


def _place_batch(specs, pspecs, mesh, device):
    out = {}
    for k, v in specs.items():
        if k == "caches":
            out[k] = [tuple(_placed(t, pl, mesh, device)
                            for t, pl in zip(pair, pls))
                      for pair, pls in zip(v, pspecs[k])]
        else:
            out[k] = _placed(v, pspecs[k], mesh, device)
    return out


def _redistribute(out, placements):
    """A serving step's outputs placed as ``serve_out_pspecs`` says (the
    reference's ``out_shardings``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(out, DTensor):
        return out.redistribute(out.device_mesh, list(placements))
    if isinstance(out, (list, tuple)):
        return type(out)(_redistribute(o, p) for o, p in zip(out, placements))
    return out


def build_cell(arch: str, shape_name: str, mesh, *, remat: str = "auto",
               opt: OptimizerConfig | None = None, microbatch: int = 0,
               device="cuda", cfg=None, shape=None):
    """(step function, its DTensor arguments, cfg, shape) of one cell (the
    reference's ``build_cell``).  Call under ``FakeTensorMode`` and the
    cell's ``sharding_rules``.  ``cfg`` and ``shape`` override the arch's
    config and the named shape (a depth-cut config, a small batch)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES_BY_NAME[shape_name]
    if remat == "auto":  # production default: full remat for training
        remat = "full" if shape.kind == "train" else "none"
    if cfg.family == "audio":   # encdec_loss always remats every layer
        remat = "none"
    opt = opt or default_opt(cfg)
    batch = _place_batch(input_specs(cfg, shape),
                         input_pspecs(cfg, shape, mesh), mesh, device)
    attn_tp = arch_attn_tp(cfg, mesh)
    if shape.kind == "train":
        state = abstract_state(cfg, opt)
        state = tree_map(lambda t, pl: _placed(t, pl, mesh, device), state,
                         state_pspecs(state, mesh, attn_tp))
        fn = make_train_step(cfg, opt, remat=remat, microbatch=microbatch)
        return fn, (state, batch), cfg, shape
    params = abstract_params(cfg)
    pls = param_pspecs(params, mesh, attn_tp)
    params = {f"module.{k}": _placed(v, pls[k], mesh, device)
              for k, v in params.items()}
    skel = abstract_model(cfg)
    step = make_prefill_step(cfg) if shape.kind == "prefill" \
        else make_decode_step(cfg)
    out_pl = serve_out_pspecs(cfg, shape, mesh)
    bound = _Bound(skel, lambda b: step(skel, b))

    def serve_step(params, batch):
        with torch.no_grad():
            out = torch.func.functional_call(bound, params, (batch,))
        return _redistribute(out, out_pl)
    return serve_step, (params, batch), cfg, shape


def _local_bytes(tensors) -> int:
    return sum(t.to_local().numel() * t.element_size()
               if hasattr(t, "to_local") else t.numel() * t.element_size()
               for t in tensors)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             remat: str = "auto", tag: str = "baseline",
             rules_override=None, microbatch: int = 0,
             verbose: bool = True, device: str = "cuda", cfg=None,
             shape=None, mesh=None, out_dir: Path | None = OUT_DIR):
    """Trace one cell and write its record (``run_cell``).  ``mesh_kind``
    "single" / "multi" opens a fake group of 256 / 512 ranks and builds
    the production mesh; a caller may pass its own ``mesh`` instead (the
    card's (1, 1) mesh over its one-rank group), and ``cfg`` / ``shape``
    (``build_cell``).  ``out_dir=None`` writes nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "tag": tag, "remat": remat, "status": "ok", "device": device}
    try:
        resolve_device(device)     # raises for "cuda" without a card
        if mesh is None:
            multi = mesh_kind == "multi"
            open_fake_group(512 if multi else 256)
            mesh = make_production_mesh(multi_pod=multi,
                                        device_type=torch.device(
                                            device).type)
        cfg0 = cfg or get_config(arch)
        rules = rules_for(cfg0, mesh)
        if rules_override:
            rules.update(rules_override)
            rec["rules_override"] = {k: list(v) if v else None
                                     for k, v in rules_override.items()}
        with FakeTensorMode() as fm, sharding_rules(mesh, rules):
            fn, args, cfg, shape = build_cell(
                arch, shape_name, mesh, remat=remat, microbatch=microbatch,
                device=device, cfg=cfg, shape=shape)
            rec["microbatch"] = microbatch
            inputs = tree_leaves(args)
            t_build = time.time() - t0
            _, rec_cost = op_cost.count(fn, *args, fake_mode=fm,
                                        inputs=inputs)
            t_trace = time.time() - t0 - t_build
        cost = cost_from_compiled(rec_cost)
        chips = num_chips(mesh)
        mf = model_flops(cfg, shape)
        rl = roofline(cost, chips, model_flops=mf, machine=H100)
        args_bytes = _local_bytes(inputs)
        state_bytes = _local_bytes(tree_leaves(args[0]))
        peak = rec_cost.peak_bytes
        rec.update({
            "chips": chips,
            "flops": cost.flops, "dot_flops": rec_cost.dot_flops,
            "hbm_bytes": cost.hbm_bytes,
            "collective": dict(cost.collective),
            "raw_cost_analysis": {
                "flops": rec_cost.flops,
                "bytes_accessed": rec_cost.bytes_accessed,
                "transcendentals": rec_cost.transcendentals,
                "note": "counted per op over one traced step (a Python "
                        "loop over layers: no trip counts)"},
            "memory_per_device": {"argument_bytes": args_bytes,
                                  "state_bytes": state_bytes,
                                  "temp_bytes": peak - args_bytes,
                                  "output_bytes": None,
                                  "alias_bytes": None},
            "state_bytes_per_device": state_bytes,
            "peak_bytes_per_device": peak,
            "fits_80g": bool(peak and peak < HBM_BYTES),
            "model_flops": mf,
            "roofline": rl.row(),
            "lower_s": round(t_build, 1),
            "compile_s": round(t_trace, 1),
        })
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_kind}] "
                  f"peak/dev={peak / 2**30:.2f} GiB "
                  f"flops={cost.flops:.3e} "
                  f"coll={cost.collective['total']:.3e} "
                  f"dom={rl.dominant} frac={rl.roofline_fraction:.3f} "
                  f"(build {t_build:.0f}s trace {t_trace:.0f}s)")
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_kind}] FAILED: "
                  f"{rec['error'][:300]}")
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = "" if tag == "baseline" else f"_{tag}"
        path = out_dir / f"{arch}_{shape_name}_{mesh_kind}{suffix}.json"
        path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def all_cells():
    cells = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            cells.append((arch, shape.name))
        for skipped in cfg.shape_skips:
            cells.append((arch, skipped + ":SKIP"))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--remat", default="auto")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--rules-override", default=None,
                    help="comma list key=axes (axes '+'-joined, 'none' "
                         "clears), e.g. heads=none,seq=model")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.list:
        resolve_device(args.device)
    rules_override = None
    if args.rules_override:
        rules_override = {}
        for kv in args.rules_override.split(","):
            k, v = kv.split("=")
            rules_override[k] = None if v == "none" else tuple(v.split("+"))
    if args.list:
        for arch, shape in all_cells():
            print(arch, shape)
        return
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_fail = 0
    for arch, shape in all_cells():
        if args.arch and arch != args.arch:
            continue
        if shape.endswith(":SKIP"):
            if not args.arch or not args.shape:
                print(f"[{arch} x {shape[:-5]}] SKIP "
                      f"({get_config(arch).skip_reason})")
            continue
        if args.shape and shape != args.shape:
            continue
        for mk in meshes:
            suffix = "" if args.tag == "baseline" else f"_{args.tag}"
            path = OUT_DIR / f"{arch}_{shape}_{mk}{suffix}.json"
            if args.skip_existing and path.exists():
                if json.loads(path.read_text()).get("status") == "ok":
                    continue
            rec = run_cell(arch, shape, mk, remat=args.remat, tag=args.tag,
                           rules_override=rules_override,
                           microbatch=args.microbatch, device=args.device)
            n_ok += rec["status"] == "ok"
            n_fail += rec["status"] != "ok"
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
