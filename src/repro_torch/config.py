"""GCN and LM model configs, the paper's Table-2 graph specs, the registry.

A copy of the parts of ``repro/config.py`` the port runs -- the GCN part
(``GCNModelConfig``, ``GraphSpec``, the Table-2 specs, ``reduced_graph``),
the LM part (``MoEConfig`` :60, ``SSMConfig`` :75, ``AttentionConfig``,
``LMConfig``, :96-195, with ``shapes``, ``param_count``,
``active_param_count`` and ``_count_params`` :185-238 for the dense, MoE,
SSM, hybrid and enc-dec stacks), the training part (``ShapeSpec`` and
the shape presets :27-51, ``OptimizerConfig`` :310, ``TrainConfig`` :330)
and the registry (``register``, ``get_config``, ``list_archs`` and
``override``, :349-387) -- kept here so the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One (seq_len, global_batch) workload cell (``ShapeSpec``, :27);
    ``kind`` is "train", "prefill" or "decode"."""

    name: str
    seq_len: int
    global_batch: int
    kind: str

    def __post_init__(self):
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown shape kind {self.kind!r}")


#: the assigned LM input shapes (``repro/config.py`` :45-51), shared by all
#: archs; each arch's ``shape_skips`` names the ones it does not run
TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                     LONG_500K)
SHAPES_BY_NAME: Dict[str, ShapeSpec] = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class GCNModelConfig:
    """Paper Table 1 layer configs (``repro.config.GCNModelConfig``)."""

    name: str
    conv: str  # "gcn" | "gin" | "sage"
    aggregator: str  # "mean" | "sum"
    hidden_dims: Tuple[int, ...]  # MLP dims after the input feature length
    # Paper's F2: which phase runs first. "combine" | "aggregate" | "auto".
    ordering: str = "auto"
    fused: bool = False  # use the fused aggregate->combine kernel (F5)
    num_layers: int = 2
    dropout: float = 0.0


@dataclass(frozen=True)
class GraphSpec:
    """Synthetic dataset spec matched to paper Table 2 statistics."""

    name: str
    num_vertices: int
    feature_len: int
    num_edges: int
    num_classes: int = 16
    seed: int = 0


# Paper Table 2. (LiveJournal feature_len=1 -- classic graph processing.)
CORA = GraphSpec("cora", 2708, 1433, 5429, num_classes=7)
CITESEER = GraphSpec("citeseer", 3327, 3703, 4732, num_classes=6)
PUBMED = GraphSpec("pubmed", 19717, 500, 44338, num_classes=3)
REDDIT = GraphSpec("reddit", 232965, 602, 11606919, num_classes=41)
LIVEJOURNAL = GraphSpec("livejournal", 4847571, 1, 68993773, num_classes=2)

GRAPHS: Dict[str, GraphSpec] = {
    g.name: g for g in (CORA, CITESEER, PUBMED, REDDIT, LIVEJOURNAL)
}


def reduced_graph(spec: GraphSpec, max_vertices: int = 512,
                  max_feature: int = 64) -> GraphSpec:
    """Scale a graph spec down for CPU tests, preserving density."""
    scale = min(1.0, max_vertices / spec.num_vertices)
    nv = max(8, int(spec.num_vertices * scale))
    ne = max(nv, int(spec.num_edges * scale))
    return dataclasses.replace(
        spec, name=spec.name + "_small", num_vertices=nv, num_edges=ne,
        feature_len=min(spec.feature_len, max_feature))


# ---------------------------------------------------------------------------
# LM architecture configs (``repro/config.py`` :60-195)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Token-choice top-k Mixture-of-Experts (``MoEConfig``, :60); its layer
    is ``models/moe.py``."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Arctic-style dense residual branch running in parallel with the experts.
    dense_residual: bool = False
    dense_residual_d_ff: int = 0
    # Which layers are MoE. "all" or "every_2" (Jamba: alternate dense/MoE).
    layer_pattern: str = "all"
    # Aux load-balancing loss weight.
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block hyper-parameters (``SSMConfig``, :75); its
    block is ``models/mamba2.py``."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    # dtype of the intra-chunk score/decay tensors (the (B,H,Q,Q) traffic);
    # inter-chunk state recurrence always runs in f32.
    compute_dtype: str = "float32"

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    # gemma2: alternate sliding-window ("local") and full ("global") layers.
    sliding_window: int = 0  # 0 = full attention everywhere
    local_global_alternate: bool = False
    logit_softcap: float = 0.0  # gemma2 uses 50.0
    attn_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    causal: bool = True

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class LMConfig:
    """A backbone: a decoder stack of attention and (``ssm``) Mamba-2
    layers, one attention layer in ``attn_every`` for a hybrid, their FFNs
    dense, MoE (``moe``) or absent (``d_ff`` 0); or with
    ``encoder_layers`` an enc-dec one (``models/encdec.py``)."""

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): one attention layer per `attn_every` layers, rest SSM.
    attn_every: int = 0
    # enc-dec (seamless): encoder layer count (decoder = num_layers).
    encoder_layers: int = 0
    # activation: "swiglu" (3-matrix) | "geglu" | "gelu" (2-matrix)
    mlp_activation: str = "swiglu"
    tie_embeddings: bool = False
    final_logit_softcap: float = 0.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    frontend_stub: bool = False
    shape_skips: Tuple[str, ...] = ()
    skip_reason: str = ""
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab padded to a multiple of 256.  Logits
        beyond ``vocab_size`` are masked to -1e30."""
        return -(-self.vocab_size // 256) * 256

    def layer_is_attention(self, i: int) -> bool:
        if self.ssm is None:
            return True
        if self.attention is None:
            return False
        if self.attn_every <= 0:
            return True
        return i % self.attn_every == self.attn_every // 2

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.layer_pattern == "all":
            return True
        if self.moe.layer_pattern == "every_2":
            return i % 2 == 1
        raise ValueError(self.moe.layer_pattern)

    def layer_is_local(self, i: int) -> bool:
        a = self.attention
        if a is None or not a.local_global_alternate:
            return False
        return i % 2 == 0  # even layers sliding-window (gemma2 convention)

    def shapes(self) -> List[ShapeSpec]:
        """``ALL_SHAPES`` but those named in ``shape_skips``."""
        return [s for s in ALL_SHAPES if s.name not in self.shape_skips]

    def param_count(self) -> int:
        """Analytic total parameter count (embedding + layers), as the
        reference counts it (``param_count``, :188): the unpadded vocab,
        no norm scales; an enc-dec stack counts its encoder and the
        decoder's cross-attention, an MoE layer every expert, its router
        and its dense residual, an SSM layer its projections, conv, A, D
        and norm but not ``conv_b`` and ``dt_bias``."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (``active_param_count``, :192): an MoE
        layer counts ``top_k`` of its experts."""
        return _count_params(self, active_only=True)


def _mlp_params(d_model: int, d_ff: int, activation: str) -> int:
    mats = 3 if activation in ("swiglu", "geglu") else 2
    return mats * d_model * d_ff


def _attn_params(d_model: int, a: AttentionConfig) -> int:
    return d_model * a.q_dim * 2 + d_model * a.kv_dim * 2


def _ssm_params(d_model: int, s: SSMConfig) -> int:
    """``_ssm_params`` (:206): the input projections, ``out_proj``, the
    conv weights, A and D, the gated norm's scale."""
    d_in = s.d_inner(d_model)
    nh = s.n_heads(d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    in_proj = d_model * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
    return in_proj + d_in * d_model + conv_dim * s.d_conv + 2 * nh + d_in


def _count_params(cfg: LMConfig, active_only: bool) -> int:
    """``_count_params`` (:214-238): the encoder's layers after the
    decoder's; a layer counts its attention where ``layer_is_attention``
    (each decoder layer of an enc-dec stack its cross-attention too), else
    its SSM block; an MoE layer (the encoder's index restarting at 0, as
    the reference's) counts ``num_experts`` (or with ``active_only``
    ``top_k``) experts, the router's ``d_model x num_experts`` and the
    dense residual, another layer its dense FFN where ``d_ff`` > 0."""
    total = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    for i in range(cfg.num_layers + cfg.encoder_layers):
        li = i if i < cfg.num_layers else i - cfg.num_layers
        if cfg.layer_is_attention(li) and cfg.attention is not None:
            total += _attn_params(cfg.d_model, cfg.attention)
            if i < cfg.num_layers and cfg.encoder_layers > 0:
                total += _attn_params(cfg.d_model, cfg.attention)
        elif cfg.ssm is not None:
            total += _ssm_params(cfg.d_model, cfg.ssm)
        if cfg.layer_is_moe(li):
            m = cfg.moe
            per_expert = _mlp_params(cfg.d_model, m.expert_d_ff,
                                     cfg.mlp_activation)
            n_active = m.top_k if active_only else m.num_experts
            total += n_active * per_expert + cfg.d_model * m.num_experts
            if m.dense_residual:
                total += _mlp_params(cfg.d_model,
                                     m.dense_residual_d_ff or cfg.d_ff,
                                     cfg.mlp_activation)
        elif cfg.d_ff > 0:
            total += _mlp_params(cfg.d_model, cfg.d_ff, cfg.mlp_activation)
    return total


# ---------------------------------------------------------------------------
# Training configs (``repro/config.py`` :310-343)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW with warmup + cosine decay and global-norm clipping
    (``OptimizerConfig``, :310).  ``moment_dtype`` "bfloat16" stores the
    moments in bf16; ``accum_dtype`` is the gradient-accumulation buffer's
    dtype of a microbatched step (``launch/steps.py``); ``grad_compression``
    "int8_ef" names the int8 error-feedback reduction, whose all-reduce is
    ``optim/compression.py::make_compressed_allreduce``."""

    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    accum_dtype: str = "float32"
    grad_compression: str = "none"


@dataclass(frozen=True)
class TrainConfig:
    """What ``train.trainer.Trainer`` and ``launch/train.py`` read
    (``TrainConfig``, :330): the step count, logging and checkpoint
    cadence, where checkpoints go and how many are kept, and the step's
    ``remat`` ("none", "full" or "selective") and ``microbatch`` (0: no
    gradient accumulation), which ``launch/train.py`` passes to
    ``launch/steps.py::make_train_step``.  The reference's ``mesh``
    field (a ``MeshConfig``) is left out: nothing there or here reads
    it.  The mesh is the open process group's (``launch/train.py``) or
    the dry run's ``--mesh``."""

    model: str
    shape: str = "train_4k"
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    remat: str = "none"  # "none" | "full" | "selective"
    microbatch: int = 0  # 0 = no gradient accumulation


# ---------------------------------------------------------------------------
# Registry (``repro/config.py`` :349-387)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], Any]] = {}


def register(name: str):
    def deco(fn: Callable[[], Any]):
        if name in _REGISTRY:
            raise ValueError(f"duplicate arch {name!r}")
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str):
    """Resolve ``--arch <name>`` to its published config."""
    from repro_torch import configs as _configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    """The registered arch names, sorted."""
    from repro_torch import configs as _configs  # noqa: F401
    return sorted(_REGISTRY)


def override(cfg, **kw):
    """``dataclasses.replace`` through nested dotted keys:
    ``override(cfg, **{"attention.num_heads": 8, "d_model": 512})``."""
    direct = {k: v for k, v in kw.items() if "." not in k}
    nested: Dict[str, Dict[str, Any]] = {}
    for k, v in kw.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
    for head, sub in nested.items():
        direct[head] = override(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **direct)
