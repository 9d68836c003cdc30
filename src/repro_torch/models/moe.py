"""Token-choice top-k Mixture-of-Experts layer (arctic-480b, kimi-k2).

Port of ``repro/models/moe.py``'s single-device path (``_moe_local``,
:77-158).  Routing builds an irregular token -> expert dispatch (sort the
assignments by expert, rank each inside its expert's segment: the
destination-sorted edge layout of the GCN's aggregation), and the experts
run as dense batched products over an ``(E, C, D)`` buffer, C slots an
expert (the combination).  Capacity-based and static in shape: assignments
past an expert's C slots are dropped.  No TPU kernel runs here: the
reference computes dispatch, the expert products and the combine in plain
XLA, and the port in plain PyTorch.

Two steps are written differently from the reference, with the same
values, so that the layer on a card is deterministic and takes no host
sync (the decode step is captured as one CUDA graph):

  * dispatch is a gather: slot ``(e, p)`` reads the token at rank ``p`` of
    expert ``e``'s segment, or is 0 when the segment is shorter -- what the
    reference's scatter-add writes (a dropped assignment adds 0 at slot 0);
  * the combine adds each token's ``top_k`` weighted slot outputs in a
    fixed order, the order of their sorted positions (the reference's
    scatter-add over them, ``out.at[tok].add``), without atomics.

On a mesh (an active ``launch/sharding.py::sharding_rules``) the layer is
the reference's expert-parallel ``_moe_sharded`` / ``_moe_local_with_a2a``
(a ``shard_map`` region with all-to-alls), which is not ported yet:
``moe_ffn`` raises ``NotImplementedError`` there, naming expert
parallelism, the next part of ROADMAP item 13.8.  Off a mesh nothing
changes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.config import MoEConfig
from repro_torch.launch.sharding import active_mesh
from repro_torch.nn.layers import MLP, gelu_tanh, init_normal, silu


def capacity(cfg: MoEConfig, num_tokens: int) -> int:
    """Slots an expert of ``num_tokens`` tokens (``capacity``, :27):
    ``capacity_factor t k / E``, at least 8, rounded up to 8."""
    c = int(cfg.capacity_factor * num_tokens * cfg.top_k / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def slots(cfg: MoEConfig, num_tokens: int, dropless: bool = False) -> int:
    """The C of ``moe_ffn``'s ``(E, C, D)`` buffer (:97-98): ``capacity``
    but at most ``t k``; ``dropless`` the worst case ``max(8, t k)``; a
    multiple of 8."""
    tk = num_tokens * cfg.top_k
    c = max(8, tk) if dropless else min(tk, capacity(cfg, num_tokens))
    return -(-c // 8) * 8


def init_experts(n: int, d_in: int, d_out: int, scale: float, *, dtype,
                 device, generator: Optional[torch.Generator]
                 ) -> nn.Parameter:
    """``(n, d_in, d_out)`` weights, each expert ``N(0, 1) * scale`` drawn
    in f32 on ``device`` and cast to ``dtype`` (``init_moe``, :32-50), one
    expert at a time: at arctic's width the whole stack in f32 would be an
    18 GB transient.  On the ``meta`` device (a structure only) nothing
    is drawn."""
    w = torch.empty((n, d_in, d_out), dtype=dtype, device=device)
    if w.is_meta:
        return nn.Parameter(w)
    for i in range(n):
        w[i].copy_(torch.randn((d_in, d_out), generator=generator,
                               device=device, dtype=torch.float32)
                   .mul_(scale))
    return nn.Parameter(w)


class MoE(nn.Module):
    """``init_moe``'s parameters: ``router`` f32 ``(d_model, E)``, ``wi``
    (and ``wg`` for the gated activations) ``(E, d_model, f)``, ``wo``
    ``(E, f, d_model)`` in the model's dtype, and ``dense``, an ``MLP``,
    with ``cfg.dense_residual``.  ``forward(x, dropless)`` is ``moe_ffn``."""

    def __init__(self, d_model: int, cfg: MoEConfig, activation: str, *,
                 dtype, device, generator: Optional[torch.Generator]):
        super().__init__()
        e, f = cfg.num_experts, cfg.expert_d_ff
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.cfg, self.activation = cfg, activation
        self.router = init_normal((d_model, e), d_model ** -0.5,
                                  dtype=torch.float32, device=device,
                                  generator=generator)
        self.wi = init_experts(e, d_model, f, d_model ** -0.5, **kw)
        self.wo = init_experts(e, f, d_model, f ** -0.5, **kw)
        self.wg: Optional[nn.Parameter] = None
        if activation in ("swiglu", "geglu"):
            self.wg = init_experts(e, d_model, f, d_model ** -0.5, **kw)
        self.dense: Optional[MLP] = None
        if cfg.dense_residual:
            self.dense = MLP(d_model, cfg.dense_residual_d_ff, activation,
                             **kw)

    def forward(self, x: torch.Tensor, dropless: bool = False):
        return moe_ffn(self, x, self.cfg, self.activation, dropless)


def route(router: torch.Tensor, xf: torch.Tensor, k: int):
    """(probs (T, E), gates (T, k), expert ids (T, k)) of tokens ``xf``
    (T, D): f32 router logits, softmax, ``topk`` (the largest first), the
    gates renormalized over the k with a ``1e-9`` floor (:101-106)."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, ids


def dispatch(ids: torch.Tensor, e: int, c: int):
    """The sorted-segment dispatch of expert ids (T, k) into ``c`` slots an
    expert (:115-124): ``order`` (the stable argsort of the flat ids),
    ``sorted_ids``, ``pos`` (each sorted assignment's rank inside its
    expert), ``keep = pos < c`` and ``tok`` (its source token)."""
    n = ids.numel()
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_ids = flat[order]
    seg_begin = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    pos = torch.arange(n, device=ids.device) - seg_begin
    return order, sorted_ids, pos, pos < c, order // ids.shape[1]


def _experts(moe: MoE, buf: torch.Tensor, activation: str) -> torch.Tensor:
    """The expert FFN over the dispatch buffer (E, C, D) in its dtype, each
    product accumulated in f32 and rounded once (:127-145)."""
    h = torch.bmm(buf, moe.wi.to(buf.dtype))
    if activation in ("swiglu", "geglu"):
        gate_h = torch.bmm(buf, moe.wg.to(buf.dtype))
        h = (silu(gate_h) if activation == "swiglu"
             else gelu_tanh(gate_h)) * h
    else:
        h = gelu_tanh(h)
    return torch.bmm(h, moe.wo.to(h.dtype))


def moe_ffn(moe: MoE, x: torch.Tensor, cfg: MoEConfig, activation: str,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux () f32): the
    reference's ``_moe_local``.  ``dropless`` sizes the buffer at the worst
    case (``slots``), as the decode path does."""
    if active_mesh() is not None:
        raise NotImplementedError(
            "moe_ffn on a mesh is the reference's expert-parallel region "
            "(models/moe.py:161 _moe_sharded, :210 _moe_local_with_a2a), "
            "not ported yet: expert parallelism, ROADMAP item 13.8")
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.num_experts
    n = t * k
    c = slots(cfg, t, dropless)
    xf = x.reshape(t, d)
    dev = x.device

    probs, gates, ids = route(moe.router, xf, k)
    # the Switch load-balance loss: mean router probability times the
    # share of assignments, per expert (the counts are exact in f32)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, ids.reshape(-1), torch.ones(n, dtype=torch.float32, device=dev))
    aux = cfg.aux_loss_weight * e * (probs.mean(0) * (ce / n)).sum()

    order, sorted_ids, pos, keep, tok = dispatch(ids, e, c)
    # slot (expert, p) holds the token at rank p of the expert's segment
    experts = torch.arange(e, device=dev)
    start = torch.searchsorted(sorted_ids, experts, side="left")
    count = torch.searchsorted(sorted_ids, experts, side="right") - start
    rank = torch.arange(c, device=dev)
    src = (start[:, None] + rank).clamp_max(n - 1)
    buf = torch.where((rank < count[:, None])[..., None], xf[tok[src]], 0)
    y = _experts(moe, buf, activation).reshape(e * c, d)

    # combine: each sorted assignment's slot output times its gate (cast to
    # the slot dtype first, 0 when dropped), added per token in sorted order
    row = sorted_ids * c + torch.where(keep, pos, 0)
    w = (gates.reshape(-1)[order] * keep).to(y.dtype)
    by_tok = torch.argsort(tok, stable=True).reshape(t, k)
    out = torch.zeros((t, d), dtype=y.dtype, device=dev)
    for j in range(k):
        i = by_tok[:, j]
        out = out + y[row[i]] * w[i, None]
    out = out.reshape(b, s, d)
    if moe.dense is not None:
        out = out + moe.dense(x)
    return out, aux


def moe_flops(cfg: MoEConfig, d_model: int, num_tokens: int,
              activation: str) -> float:
    """Analytic FLOPs of one MoE layer's expert products, forward
    (``moe_flops``, :285): every expert over its ``capacity`` slots."""
    mats = 3 if activation in ("swiglu", "geglu") else 2
    c = capacity(cfg, num_tokens)
    return 2.0 * cfg.num_experts * c * d_model * cfg.expert_d_ff * mats
