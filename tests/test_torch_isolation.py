"""The port stands alone and never falls back.

* ``import repro_torch`` (every module of it) leaves ``jax`` out of
  ``sys.modules``, and no file of the port or ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro``.
* Entry points default to ``device="cuda"`` and raise without a card; the
  ``cuda`` tier raises for tensors on the CPU instead of running the plain
  versions.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import CORA, reduced_graph
from repro_torch.configs import granite_3_8b, mamba2_2_7b
from repro_torch.core import backend
from repro_torch.core.dataflow import block_graph
from repro_torch.core.gcn_layers import GCNConv
from repro_torch.core.phases import aggregate
from repro_torch.core.plan import build_plan
from repro_torch.graph import datasets
from repro_torch.graph.structure import graph_from_coo
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models.gcn import PAPER_MODELS, GCNModel, make_paper_model
from repro_torch.models.transformer import TransformerLM, init_caches

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
SPEC = reduced_graph(CORA, 64, 16)


def test_import_leaves_jax_out():
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro'))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_analysis_is_covered_and_defaults_to_cuda(monkeypatch):
    """``repro_torch.analysis`` is among the files held to the rules above,
    and its runner, an entry point of the port, raises without a card."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "analysis" in p.parts}
    assert {"analysis/__init__.py", "analysis/__main__.py",
            "analysis/report.py", "analysis/trace_lint.py",
            "analysis/ast_lint.py", "analysis/selftest.py"} <= names
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.analysis.__main__ import main
    with pytest.raises(RuntimeError, match="device='cuda'"):
        main([])


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        datasets.load_dataset("cora")
    with pytest.raises(RuntimeError):
        datasets.make_synthetic_graph(SPEC)
    with pytest.raises(RuntimeError):
        graph_from_coo([0, 1], [1, 0], 2)
    with pytest.raises(RuntimeError):
        GCNModel(PAPER_MODELS["gcn"], 16, 7)
    with pytest.raises(RuntimeError):
        GCNConv(16, 7)
    g = datasets.make_synthetic_graph(SPEC, device="cpu")
    with pytest.raises(RuntimeError):
        build_plan(g, PAPER_MODELS["gcn"], 16, 7)


def test_lm_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = granite_3_8b.reduced()
    with pytest.raises(RuntimeError, match="device='cuda'"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        launch_serve.main(["--arch", "granite-3-8b", "--reduced"])


def test_ssm_entry_points_default_to_cuda(monkeypatch):
    """The SSM stack has no CPU fallback either: mamba2-2.7b (published and
    reduced) and its caches raise without a card, and its module and
    configs are among the files held to the import rules above."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "src" in p.parts}
    assert {"models/mamba2.py", "configs/mamba2_2_7b.py",
            "configs/jamba_1_5_large.py"} <= names
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.config import get_config
    for cfg in (get_config("mamba2-2.7b"), mamba2_2_7b.reduced()):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            TransformerLM(cfg)
        with pytest.raises(RuntimeError, match="device='cuda'"):
            init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        launch_serve.main(["--arch", "mamba2-2.7b", "--reduced"])


def test_vlm_entry_points_default_to_cuda(monkeypatch):
    """The VLM path has no CPU fallback either: internvl2-1b's model, its
    stub patch embeddings and its launcher raise without a card, and its
    module and the three configs that came with it are among the files
    held to the import rules above."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "src" in p.parts}
    assert {"models/vlm.py", "configs/internvl2_1b.py", "configs/gemma_7b.py",
            "configs/deepseek_67b.py"} <= names
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import internvl2_1b
    from repro_torch.models import vlm
    cfg = internvl2_1b.reduced()
    with pytest.raises(RuntimeError, match="device='cuda'"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        vlm.stub_patch_embeds(torch.Generator(), 1, cfg)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        launch_serve.main(["--arch", "internvl2-1b", "--reduced"])


def test_launch_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The launch layer has no CPU fallback either: the training launcher,
    the dry run and its profiler default to ``device="cuda"`` and raise
    without a card (the dry run records the error in its cell), and their
    modules are among the files held to the import rules above."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "src" in p.parts}
    assert {"launch/mesh.py", "launch/sharding.py", "launch/specs.py",
            "launch/dryrun.py", "launch/profile_cell.py", "launch/train.py",
            "core/op_cost.py"} <= names
    import inspect

    from repro_torch.launch import dryrun, profile_cell
    from repro_torch.launch import train as launch_train
    for fn, arg in ((launch_train.build_trainer, "device"),
                    (dryrun.run_cell, "device"),
                    (dryrun.build_cell, "device"),
                    (profile_cell.profile, "device")):
        assert inspect.signature(fn).parameters[arg].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        launch_train.main(["--arch", "granite-3-8b", "--reduced",
                           "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cuda'"):
        dryrun.main(["--arch", "granite-3-8b", "--shape", "train_4k",
                     "--mesh", "single"])
    rec = dryrun.run_cell("granite-3-8b", "train_4k", "single",
                          out_dir=None, verbose=False)
    assert rec["status"] == "error" and "device='cuda'" in rec["error"]
    with pytest.raises(RuntimeError, match="device='cuda'"):
        profile_cell.main(["--arch", "granite-3-8b", "--shape",
                           "train_4k"])


def test_cuda_tier_on_cpu_tensors_raises():
    g = datasets.make_synthetic_graph(SPEC, device="cpu")
    x = datasets.make_features(SPEC, device="cpu")
    bg = block_graph(g, 32)
    w = torch.zeros((SPEC.feature_len, 4))
    with pytest.raises(ValueError, match="cuda"):
        build_plan(g, PAPER_MODELS["gcn"], SPEC.feature_len, 7,
                   backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        make_paper_model("gcn", SPEC, backend="cuda", device="cpu")(g, x)
    with pytest.raises(ValueError, match="cuda"):
        ops.seg_agg_planned(bg, x, backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.fused_agg_combine(bg.src, bg.dstl, bg.mask, x, w, tile_m=32,
                              backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        aggregate(g, x, op="sum", backend="cuda", layout=bg)


def test_tier_resolution():
    assert backend.resolve_backend("auto", "cpu") == "torch"
    assert backend.resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert backend.resolve_backend("cuda", "cpu") == "cuda"   # plans only
    with pytest.raises(ValueError):
        backend.resolve_backend("xla", "cpu")
    with pytest.raises(ValueError):
        backend.require_device("cuda", "cpu")
    backend.require_device("torch", "cpu")
    g = datasets.make_synthetic_graph(SPEC, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        build_plan(g, PAPER_MODELS["gcn"], 16, 7, device="meta")
    assert np.array_equal(g.src.numpy(), g.to("cpu").src.numpy())
