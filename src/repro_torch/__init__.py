"""PyTorch + CUDA port of the GCN characterization framework.

Mirrors the JAX package ``repro`` module by module (``repro_torch.core.plan``
is held against ``repro.core.plan``, and so on).  It runs the paper's
Table-1 models (GCN, GraphSAGE-mean, GIN-0) and the LM serving path
(``serve.engine.ServeEngine`` over ``models.transformer``) on an NVIDIA
H100 through three kernels written by hand in CUDA C++ (``csrc/``).
Imports ``torch`` and numpy only; nothing of JAX and nothing of ``repro``.

Entry points default to ``device="cuda"`` and raise when no card is
visible; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
