"""Decoder LM backbone: attention, SSM and hybrid stacks.

Port of ``repro/models/transformer.py``.  The reference stacks the layers'
parameters per position of a repeating PERIOD and runs them under one
``lax.scan``; here ``TransformerLM.layers`` is an ``nn.ModuleList`` in
layer order and a Python loop runs it.  ``LayerPos`` and the period still
say what each layer is (gemma2: even layers local, sliding-window), and
``params_from_reference`` maps the stacked pytree onto the list: layer
``rep * period + i`` is slice ``rep`` of ``pos{i}``.  A layer is an
attention layer or, where ``cfg.layer_is_attention`` says not, a Mamba-2
block (``models/mamba2.py``): all of mamba2's, seven of each eight of
jamba's.

Entry points (the reference's, with the module in place of ``params`` and
``cfg``):
  init_lm(cfg, generator=, device=)              -> TransformerLM
  lm_forward(model, tokens)                      -> logits (B, S, V)
  lm_loss(model, tokens, labels)                 -> (loss, {"ce", "aux"})
  lm_prefill(model, tokens, cache_size)          -> (logits, caches, length)
  lm_decode_step(model, token, caches, length)   -> (logits, caches, length)
  init_caches(cfg, batch, cache_size, device)    -> zeroed caches

``model(tokens, labels)`` is ``lm_loss``, so ``torch.func.functional_call``
runs the loss over a dict of parameters by name (``launch/steps.py``).

Caches are a list with one pair per layer: ``(k, v)`` in the model's
dtype for an attention layer, ``(state, conv)`` in f32 for an SSM layer.
A layer's FFN is an ``MLP``, an ``MoE`` (``models/moe.py``) where
``cfg.layer_is_moe``, or none where ``d_ff`` is 0 (mamba2); the stack sums
the MoE layers' load-balance losses into ``lm_loss``'s ``aux``.

``embeds`` (B, P, d_model), where given, are a frontend's embeddings (the
VLM's patch stub, ``models/vlm.py``): they take the first P positions,
before the tokens' embeddings, in ``lm_forward``, ``lm_loss`` (whose
labels cover the tokens only) and ``lm_prefill`` (whose caches and length
count them).  An enc-dec config raises (its model is
``models/encdec.py``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint as ckpt
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate,
                                      distribute_tensor)

from repro_torch.config import LMConfig
from repro_torch.core.backend import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch.sharding import constrain
from repro_torch.models.mamba2 import Mamba2, SSMCache, conv_dim
from repro_torch.models.moe import MoE
from repro_torch.nn.attention import Attention, KVCache, attention_block
from repro_torch.nn.layers import (DTYPES, MLP, Embedding, RMSNorm,
                                   acc_dtype, embed, shard_sums, softcap,
                                   unembed)

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# Layer-period machinery
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerPos:
    """Static description of one position inside the repeating period."""
    index: int
    kind: str        # "attn" | "ssm"
    moe: bool
    local: bool      # sliding-window attention (gemma2 even layers)


def layer_period(cfg: LMConfig) -> int:
    p = 1
    if cfg.attention is not None and cfg.attention.local_global_alternate:
        p = math.lcm(p, 2)
    if cfg.ssm is not None and cfg.attention is not None and cfg.attn_every:
        p = math.lcm(p, cfg.attn_every)
    if cfg.moe is not None and cfg.moe.layer_pattern == "every_2":
        p = math.lcm(p, 2)
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers is not a "
                         f"multiple of the period {p}")
    return p


def layer_positions(cfg: LMConfig) -> List[LayerPos]:
    return [LayerPos(i,
                     "attn" if cfg.layer_is_attention(i) else "ssm",
                     cfg.layer_is_moe(i),
                     cfg.layer_is_local(i))
            for i in range(layer_period(cfg))]


def _check_supported(cfg: LMConfig) -> None:
    if cfg.encoder_layers > 0:
        raise NotImplementedError(
            f"{cfg.name}: an enc-dec stack; its model is "
            f"models/encdec.py::EncDecLM")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def whole_seq(h: torch.Tensor) -> torch.Tensor:
    """A sub-block's input, whole along the sequence on a mesh (Megatron
    sequence parallelism gathers on entry; GSPMD inserts this itself, a
    DTensor program says it).  A no-op off a mesh."""
    return constrain(h, "batch", None, "embed")


def residual(out: torch.Tensor) -> torch.Tensor:
    """A sub-block's output laid out as the residual stream (``"batch",
    "seq", "embed"``) before it is added: where the reference leaves
    GSPMD to reshard the partial sums at the add, a DTensor op would
    reshard them outside autograd (the gradient would come back sharded
    over the sequence).  A no-op off a mesh."""
    return constrain(out, "batch", "seq", "embed")


class Block(nn.Module):
    """One block (``_apply_layer``): ``attn``, or at an SSM position
    (``kind`` "ssm") the Mamba-2 block ``ssm``; then ``mlp``, or at an MoE
    position ``moe``, or no FFN sub-block (and no ``ln2``) where ``d_ff``
    is 0; gemma2 adds the sandwich norms ``ln1_post``/``ln2_post``."""

    def __init__(self, cfg: LMConfig, pos: LayerPos, *, dtype, device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.kind = pos.kind
        self.window = cfg.attention.sliding_window if pos.local else 0
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        if pos.kind == "attn":
            self.attn = Attention(cfg.d_model, cfg.attention, **kw)
        else:
            self.ssm = Mamba2(cfg.d_model, cfg.ssm, **kw)
        self.is_moe = pos.moe
        self.has_ffn = pos.moe or cfg.d_ff > 0
        if self.has_ffn:
            self.ln2 = RMSNorm(cfg.d_model, device=device)
        if pos.moe:
            self.moe = MoE(cfg.d_model, cfg.moe, cfg.mlp_activation, **kw)
        elif self.has_ffn:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation, **kw)
        self.sandwich = cfg.name.startswith("gemma2")
        if self.sandwich:
            self.ln1_post = RMSNorm(cfg.d_model, device=device)
            self.ln2_post = RMSNorm(cfg.d_model, device=device)

    def forward(self, x: torch.Tensor, cfg: LMConfig, *,
                cache=None, make_cache: bool = False,
                cache_size: int = 0, attn_impl: str = "auto"):
        """Returns (x, new_cache, aux): ``aux`` is the MoE layer's f32
        load-balance loss, None for a dense FFN or none.  ``cache`` is a
        ``KVCache`` for an attention layer, an ``SSMCache`` for an SSM
        one.  The MoE layer is dropless in decode (``cache`` given), as
        the reference's.

        The residual stream keeps the reference's roundings.  Its compiled
        scan adds a residual in f32 and feeds that unrounded sum to the next
        RMSNorm, while the residual itself goes on rounded to the model's
        dtype (and the scan's carry is rounded once per period, in
        ``_run_stack``).  So ``x`` may come in as that f32 sum, and the
        block returns its own f32 sum; in an f32 model every cast here is a
        no-op.  A block without an FFN returns the sum after its first
        sub-block.  (An f64 model sums in f64.)"""
        eps, dt = cfg.norm_eps, DTYPES[cfg.dtype]
        acc = acc_dtype(dt)
        h = whole_seq(self.ln1(x, eps, dtype=dt))
        x = x.to(dt)
        if self.kind == "attn":
            out, new_cache = attention_block(
                self.attn, h, cfg.attention,
                layer_window=self.window, cache=cache, make_cache=make_cache,
                cache_size=cache_size, impl=attn_impl)
            out = constrain(out, "batch", "seq", "embed")
        else:
            out, new_cache = self.ssm(h, cache=cache, make_cache=make_cache)
            out = residual(out)
        if self.sandwich:
            out = self.ln1_post(out, eps)
        xs = x.to(acc) + out
        if not self.has_ffn:
            return constrain(xs, "batch", "seq", "embed"), new_cache, None
        h, aux = whole_seq(self.ln2(xs, eps, dtype=dt)), None
        if self.is_moe:
            out, aux = self.moe(h, dropless=cache is not None)
        else:
            out = self.mlp(h)
        out = residual(out)
        if self.sandwich:
            out = self.ln2_post(out, eps)
        return constrain(xs.to(dt).to(acc) + out, "batch", "seq", "embed"), \
            new_cache, aux


class TransformerLM(nn.Module):
    """``embed`` (and ``lm_head`` when untied), ``layers`` in layer order,
    ``final_ln``.  Weights are drawn from ``generator`` on ``device``
    (default: a generator seeded with 0 there)."""

    def __init__(self, cfg: LMConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(dtype=DTYPES[cfg.dtype], device=dev, generator=generator)
        self.cfg = cfg
        self.device = dev
        positions = layer_positions(cfg)
        period = len(positions)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.final_ln = RMSNorm(cfg.d_model, device=dev)
        self.layers = nn.ModuleList(
            Block(cfg, positions[n % period], **kw)
            for n in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(cfg.padded_vocab, cfg.d_model, **kw)

    def forward(self, tokens: torch.Tensor, labels: torch.Tensor,
                embeds=None, **kw):
        """``lm_loss(self, tokens, labels, embeds, **kw)``: the module's
        call is its loss, which ``torch.func.functional_call`` runs over
        parameters by name."""
        return lm_loss(self, tokens, labels, embeds, **kw)

    def params_from_reference(self, tree: Dict) -> "TransformerLM":
        """Load the reference's ``init_lm`` pytree (numpy leaves) in place
        (``flatten_reference`` names its leaves).  Raises on a missing or
        extra leaf or a shape mismatch."""
        return load_flat(self, flatten_reference(tree, self.cfg))

    def head_table(self) -> torch.Tensor:
        return (self.embed if self.cfg.tie_embeddings
                else self.lm_head).table


def load_flat(module: nn.Module, flat: Dict[str, np.ndarray]):
    """Copy ``{parameter name: numpy leaf}`` into ``module``'s parameters in
    place; returns the module.  Raises on a missing or extra name or a
    shape mismatch."""
    mine = dict(module.named_parameters())
    if set(flat) != set(mine):
        raise ValueError(f"parameter names differ: reference only "
                         f"{sorted(set(flat) - set(mine))}, model only "
                         f"{sorted(set(mine) - set(flat))}")
    with torch.no_grad():
        for name, value in flat.items():
            value = torch.from_numpy(np.array(value, np.float32))
            if tuple(value.shape) != tuple(mine[name].shape):
                raise ValueError(f"{name}: reference shape "
                                 f"{tuple(value.shape)} != "
                                 f"{tuple(mine[name].shape)}")
            mine[name].copy_(value)
    return module


def flatten_into(flat: Dict[str, np.ndarray], prefix: str, node: Dict,
                 index: Optional[int] = None) -> None:
    """Add the leaves of the reference's params subtree ``node`` to
    ``flat`` under the port's names (``prefix.key...``; slice ``index`` of
    each leaf when the subtree is stacked).  A ``{"w": ...}`` leaf maps
    onto the parameter named by its parent key."""
    for key, val in node.items():
        name = prefix if key == "w" else f"{prefix}.{key}"
        if isinstance(val, dict):
            flatten_into(flat, name, val, index)
        else:
            flat[name] = val if index is None else val[index]


def flatten_reference(tree: Dict, cfg: LMConfig) -> Dict[str, np.ndarray]:
    """The reference's ``init_lm`` pytree (or a gradient of it) as
    ``{parameter name: leaf}`` in the port's names.

    ``tree["blocks"]["pos{i}"]`` leaves are stacked ``(n_rep, ...)``; layer
    ``rep * period + i`` takes slice ``rep`` (``flatten_into``)."""
    period = len(layer_positions(cfg))
    flat: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key != "blocks":
            flatten_into(flat, key, sub)
    for pos_key, sub in tree["blocks"].items():
        i = int(pos_key[len("pos"):])
        for rep in range(cfg.num_layers // period):
            flatten_into(flat, f"layers.{rep * period + i}", sub, rep)
    return flat


def init_lm(cfg: LMConfig, *, generator: Optional[torch.Generator] = None,
            device="cuda") -> TransformerLM:
    """A model of ``cfg`` with weights drawn as the reference's ``init_lm``
    draws them, leaf by leaf: dense ``(d_in, d_out)`` weights
    ``N(0, 1) d_in^-0.5`` (the output projections ``wo`` over their own
    input width: ``q_dim^-0.5``, ``d_ff^-0.5``), embedding tables ``N(0, 1)
    d^-0.5``, norm scales 0; drawn in f32 and cast to ``cfg.dtype``.  The
    generator's stream is torch's, not ``jax.random``'s: the values differ
    from the reference's, their distributions do not."""
    return TransformerLM(cfg, device=device, generator=generator)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_inputs(model: TransformerLM, tokens: torch.Tensor,
                  embeds=None) -> torch.Tensor:
    """The tokens' embeddings (scaled by sqrt(d) for gemma names), with a
    frontend's ``embeds`` (B, P, d_model), cast to the table's dtype and
    moved to its device, before them (``_embed_inputs``, :226-232)."""
    table = model.embed.table
    x = embed(table, tokens.to(table.device),
              scale_by_sqrt_d=model.cfg.name.startswith("gemma"))
    if embeds is not None:
        x = torch.cat([embeds.to(device=table.device, dtype=x.dtype), x], 1)
    return constrain(x, "batch", "seq", "embed")


#: the ``remat`` modes of the training forward
REMAT = ("none", "full", "selective")

#: the products without batch dims, whose outputs ``remat="selective"``
#: keeps (a dense layer's ``x @ w`` runs as one of these on 2-D operands;
#: attention's batched products and K5's op run as ``bmm`` and
#: ``repro_torch::flash_attention`` and are recomputed)
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def selective_policy(ctx, func, *args, **kwargs):
    """``remat="selective"``'s policy (the reference's
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``): keep
    the outputs of ``SAVED_PRODUCTS``, recompute everything else."""
    if func in SAVED_PRODUCTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class _Bound(nn.Module):
    """``fn`` over ``module``, so that ``torch.func.functional_call`` can
    put tensors in place of ``module``'s parameters while ``fn`` runs."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.module, self.fn = module, fn

    def forward(self, *args):
        return self.fn(*args)


def checkpointed(module: nn.Module, fn, *args, policy=None):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)``, a
    function that reads ``module``'s parameters: only ``args`` are kept,
    and the backward runs ``fn`` again -- with the tensors the parameters
    hold now.  Under ``torch.func.functional_call`` (``launch/steps.py``)
    those are the caller's, which a plain checkpoint no longer sees when
    the backward recomputes (the call has returned and put the module's
    own back: on a ``meta`` skeleton, tensors without data).  Without a
    gradient there is nothing to keep: ``fn(*args)`` runs as it is.
    ``policy`` (``selective_policy``) keeps the outputs it names
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts``).
    The recompute runs under the call's sharding context
    (``launch/sharding.py``), which it carries along: the autograd engine
    runs a CUDA backward on a thread of its own."""
    if not torch.is_grad_enabled():
        return fn(*args)
    params = {f"module.{n}": p for n, p in module.named_parameters()}
    bound = _Bound(module, fn)
    kw = {} if policy is None else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, policy)}
    rules = sharding.current()   # the recompute may run on another thread

    def run(*a):
        with sharding.restored(rules):
            return torch.func.functional_call(bound, params, a)
    return ckpt.checkpoint(run, *args, use_reentrant=False, **kw)


def _run_stack(model: TransformerLM, x: torch.Tensor, *,
               caches: Optional[Caches] = None, cache_length=None,
               make_cache: bool = False, cache_size: int = 0,
               attn_impl: str = "auto", remat: str = "none"):
    """Run the layers in order.  Returns (x, new_caches or None, aux): the
    MoE layers' load-balance losses summed in f32 in layer order (0 for a
    dense stack).

    ``remat="full"`` runs each period of layers under
    ``torch.utils.checkpoint`` (``checkpointed``: the reference's
    ``jax.checkpoint`` of its scan body): only the period's input is
    kept, and the backward runs the period's forward again.
    ``remat="selective"`` keeps the outputs of the products without
    batch dims as well (``selective_policy``: the reference's
    ``dots_with_no_batch_dims_saveable``) and recomputes the rest, K5's
    op included; the gradients are ``"none"``'s bit for bit."""
    cfg = model.cfg
    dt, period = DTYPES[cfg.dtype], layer_period(cfg)
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: expected one of {REMAT}")
    if remat != "none" and (caches is not None or make_cache):
        raise ValueError("remat applies to the training forward only")
    new_caches: Caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_period(x, aux, n0):
        x = x.to(dt)      # the reference's scan carry, rounded
        for n in range(n0, n0 + period):
            inner, layer = None, model.layers[n]
            if caches is not None:
                kind = KVCache if layer.kind == "attn" else SSMCache
                inner = kind(caches[n][0], caches[n][1], cache_length)
            x, new_inner, layer_aux = layer(
                x, cfg, cache=inner, make_cache=make_cache,
                cache_size=cache_size, attn_impl=attn_impl)
            if new_inner is not None:
                new_caches.append((new_inner[0], new_inner[1]))
            if layer_aux is not None:
                aux = aux + layer_aux
        return x, aux

    for n0 in range(0, cfg.num_layers, period):
        if remat != "none":
            x, aux = checkpointed(model, run_period, x, aux, n0, policy=(
                selective_policy if remat == "selective" else None))
        else:
            x, aux = run_period(x, aux, n0)
    return x.to(dt), (new_caches or None), aux


def head_logits(model, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of the last layer's output ``x``: ``final_ln``, the
    product against ``model.head_table()``, the final softcap, the padded
    vocabulary's ids at -1e30 (a model with ``cfg``, ``final_ln`` and
    ``head_table``: ``TransformerLM`` or ``EncDecLM``)."""
    cfg = model.cfg
    x = model.final_ln(x, cfg.norm_eps)
    logits = softcap(unembed(model.head_table(), x), cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding ids
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= \
            cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return constrain(logits, "batch", "seq", "vocab")


def lm_forward(model: TransformerLM, tokens: torch.Tensor, embeds=None, *,
               attn_impl: str = "auto") -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) (after ``embeds`` (B, P, d),
    where given) -> f32 logits (B, P + S, V)."""
    x, _, _ = _run_stack(model, _embed_inputs(model, tokens, embeds),
                         attn_impl=attn_impl)
    return head_logits(model, x)


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            labels: torch.Tensor, embeds=None, *, attn_impl: str = "auto",
            ce_chunk: int = 2048, remat: str = "none", params=None):
    """Next-token cross-entropy, computed CHUNKED over tokens
    (``lm_loss``, :256).  Returns ``(loss, {"ce": loss, "aux": aux})``.

    The final norm's output goes to ``chunked_ce`` against the head
    table.  Tied embeddings take gradients from the lookup and the head.
    ``aux`` is the MoE layers' summed load-balance loss (0 for a dense
    stack), added to the loss.  With ``embeds`` the final norm's output at
    their P positions is dropped (``lm_loss``, :272-273): ``labels`` (B,
    S) cover the tokens only.

    ``params`` (a dict of tensors by parameter name) runs the loss through
    ``torch.func.functional_call`` with those tensors in place of the
    module's."""
    if params is not None:
        return torch.func.functional_call(
            model, params, (tokens, labels, embeds),
            dict(attn_impl=attn_impl, ce_chunk=ce_chunk, remat=remat))
    cfg = model.cfg
    x, _, aux = _run_stack(model, _embed_inputs(model, tokens, embeds),
                           attn_impl=attn_impl, remat=remat)
    x = model.final_ln(x, cfg.norm_eps)
    if embeds is not None:   # frontend positions carry no labels
        x = x[:, embeds.shape[1]:]
    loss = chunked_ce(cfg, model.head_table(), x, labels, ce_chunk)
    return loss + aux, {"ce": loss, "aux": aux}


def chunked_ce(cfg: LMConfig, table: torch.Tensor, x: torch.Tensor,
               labels: torch.Tensor, ce_chunk: int) -> torch.Tensor:
    """The mean next-token cross-entropy of the final norm's output ``x``
    (B, S, D) against ``labels`` (B, S), -100 masked, with logits ``x @
    table.T``, chunked as the reference's ``lm_loss`` and ``encdec_loss``
    chunk it: ``ce_chunk`` tokens at a time (all ``t`` of them when
    ``ce_chunk`` does not divide ``t``); each chunk's logits are the
    product in x's dtype accumulated in f32, the final softcap, the padded
    vocabulary's -1e30 added, ``log_softmax`` and the labels' negative
    log-likelihood, under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), so no (tokens, vocab) f32 logits are kept for the
    backward, which computes each chunk's again.

    A DTensor ``x`` (on a mesh) is taken shard by shard: each rank runs
    the chunks over its own tokens against the whole table (gathered; its
    gradient a partial sum), and the sums and counts are partial sums over
    the mesh, so the loss is the same mean."""
    if isinstance(x, DTensor):
        mesh, pl = x.device_mesh, list(x.placements)
        sums = shard_sums(pl)
        whole = table.redistribute(mesh, [Replicate()] * mesh.ndim) \
            .to_local(grad_placements=sums)
        lab = labels.redistribute(mesh, pl[:]) if isinstance(
            labels, DTensor) else distribute_tensor(labels, mesh, pl)
        tot, cnt = _ce_sums(cfg, whole, x.to_local(grad_placements=pl),
                            lab.to_local(), ce_chunk)
        tot = DTensor.from_local(tot, mesh, sums, run_check=False)
        cnt = DTensor.from_local(cnt, mesh, sums, run_check=False)
        return tot / torch.clamp(cnt, min=1)
    tot, cnt = _ce_sums(cfg, table, x, labels, ce_chunk)
    return tot / torch.clamp(cnt, min=1)


def _ce_sums(cfg: LMConfig, table: torch.Tensor, x: torch.Tensor,
             labels: torch.Tensor, ce_chunk: int):
    """``chunked_ce``'s summed NLL and count of valid labels."""
    b, s, d = x.shape
    t = b * s
    chunk = min(ce_chunk, t)
    if t % chunk:
        chunk = t   # the reference's fallback: unchunked for odd shapes
    xf = x.reshape(t, d)
    lf = labels.to(x.device).reshape(t)
    pad = None
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.where(torch.arange(cfg.padded_vocab, device=x.device) <
                          cfg.vocab_size, 0.0, -1e30)

    def chunk_ce(x_c, l_c):
        logits = softcap(unembed(table, x_c), cfg.final_logit_softcap)
        if pad is not None:
            logits = logits + pad
        valid = l_c >= 0
        safe = torch.where(valid, l_c, 0).long()
        ll = torch.log_softmax(logits, dim=-1)
        nll = -ll.gather(1, safe[:, None])[:, 0]
        return (nll * valid).sum(), valid.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, t, chunk):
        ls, n = ckpt.checkpoint(chunk_ce, xf[c0:c0 + chunk],
                                lf[c0:c0 + chunk], use_reentrant=False)
        tot, cnt = tot + ls, cnt + n
    return tot, cnt


def init_caches(cfg: LMConfig, batch: int, cache_size: int,
                device="cuda") -> Caches:
    """Zeroed caches, one pair per layer (``zeroed_caches``)."""
    _check_supported(cfg)
    return zeroed_caches(cfg, batch, cache_size, device)


def init_caches_abstract(cfg: LMConfig, batch: int,
                         cache_size: int) -> Caches:
    """``init_caches`` on the ``meta`` device: each layer's pair with its
    shapes and dtypes and no storage (``init_caches_abstract``, :318; the
    reference's stacked tree, per layer)."""
    _check_supported(cfg)
    return zeroed_caches(cfg, batch, cache_size, "meta")


def zeroed_caches(cfg: LMConfig, batch: int, cache_size: int,
                  device="cuda") -> Caches:
    """``cfg.num_layers`` pairs of zeroed tensors, each layer's of its kind
    (``init_caches_abstract``, :318-340): an attention layer's ``(k, v)``
    of (batch, Hkv, cache_size, head_dim) in the model's dtype, an SSM
    layer's ``(state, conv)`` of (batch, H, d_state, head_dim) and (batch,
    conv_dim, d_conv - 1) in f32 (f64 in an f64 model), whatever
    ``cache_size``."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    kinds = layer_positions(cfg)
    out: Caches = []
    for n in range(cfg.num_layers):
        if kinds[n % len(kinds)].kind == "attn":
            a = cfg.attention
            shapes = [(batch, a.num_kv_heads, cache_size, a.head_dim)] * 2
            dtype = dt
        else:
            s = cfg.ssm
            shapes = [(batch, s.n_heads(cfg.d_model), s.d_state, s.head_dim),
                      (batch, conv_dim(cfg.d_model, s), s.d_conv - 1)]
            dtype = acc_dtype(dt)
        out.append(tuple(torch.zeros(shape, dtype=dtype, device=dev)
                         for shape in shapes))
    return out


def lm_prefill(model: TransformerLM, tokens: torch.Tensor, cache_size: int,
               embeds=None, *, attn_impl: str = "auto"):
    """Forward + cache build.  Returns (last-token logits (B, 1, V),
    caches -- an attention layer's padded to ``cache_size``, an SSM
    layer's its final state and conv tail --, length () int32).  With
    ``embeds`` (B, P, d) the caches and the length count their P positions
    before the tokens'."""
    x, caches, _ = _run_stack(model, _embed_inputs(model, tokens, embeds),
                              make_cache=True, cache_size=cache_size,
                              attn_impl=attn_impl)
    length = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
    return head_logits(model, x[:, -1:]), caches, length


def lm_decode_step(model: TransformerLM, token: torch.Tensor, caches: Caches,
                   length: torch.Tensor, *, attn_impl: str = "auto"):
    """One-token decode.  token: (B, 1); ``length`` () or (B,) int32.
    Writes the new rows (an attention layer's) and the new state and conv
    tail (an SSM layer's) into ``caches`` in place and returns (logits
    (B, 1, V), caches, length + 1)."""
    x, new_caches, _ = _run_stack(model, _embed_inputs(model, token),
                                  caches=caches, cache_length=length,
                                  attn_impl=attn_impl)
    return head_logits(model, x), new_caches, length + 1
