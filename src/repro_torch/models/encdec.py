"""Encoder-decoder backbone (seamless-m4t-medium).

Port of ``repro/models/encdec.py``.  The audio frontend is a stub, as in
the reference: the encoder takes precomputed frame embeddings (B, S_enc,
D).  Encoder layers: non-causal self-attention and FFN.  Decoder layers:
causal self-attention, cross-attention over the encoder's memory, FFN.
The reference stacks each stack's layers and scans over them; here
``EncDecLM.enc`` and ``EncDecLM.dec`` are ``nn.ModuleList``s run by a
Python loop, and ``params_from_reference`` unstacks the reference's
pytree onto them.

Entry points (the reference's, with the module in place of ``params`` and
``cfg``):
  init_encdec(cfg, generator=, device=)                  -> EncDecLM
  encode(model, frames)                                  -> memory
  decode_stack(model, tokens, memory, ...)               -> (logits, caches)
  encdec_loss(model, frames, tokens, labels)             -> (loss, {"ce"})
  encdec_prefill(model, frames, tokens, cache_size)
      -> (last logits, caches, memory, length)
  encdec_decode_step(model, token, caches, memory, length)
      -> (logits, caches, length + 1)
  init_dec_caches(cfg, batch, cache_size, device)        -> zeroed caches

Each takes ``attn_impl`` (``"auto"``, ``"cuda"``, ``"torch"``,
``"direct"``; ``nn/attention.py``): on the ``cuda`` tier every encoder
layer launches K5 non-causally, every decoder layer K5 causally for its
self-attention in a prefill or a training forward and K5 non-causally
for its cross-attention (also at each decode step, Sq = 1); a decode
step's self-attention stays the plain ``decode_attention``.

Frames enter in the model's dtype: ``encode`` casts them once (the
reference's ``input_specs`` give them in ``cfg.dtype``; given f32 frames,
its bf16 model would run the encoder in f32).  Caches are a list with one
``(k, v)`` pair per decoder layer, as ``models/transformer.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.config import LMConfig
from repro_torch.core.backend import resolve_device
from repro_torch.launch.sharding import constrain
from repro_torch.models.transformer import (DTYPES, Caches, checkpointed,
                                            chunked_ce, flatten_into,
                                            head_logits, load_flat,
                                            residual, whole_seq,
                                            zeroed_caches)
from repro_torch.nn.attention import (Attention, KVCache, attention_block,
                                      cross_attention_block)
from repro_torch.nn.layers import MLP, Embedding, RMSNorm, embed


class EncoderLayer(nn.Module):
    """``ln1``, ``attn`` (non-causal self-attention), ``ln2``, ``mlp``."""

    def __init__(self, cfg: LMConfig, *, dtype, device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg.d_model, cfg.attention, **kw)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation, **kw)

    def forward(self, h: torch.Tensor, acfg, attn_impl: str = "auto"):
        a, _ = attention_block(self.attn, whole_seq(self.ln1(h)), acfg,
                               impl=attn_impl)
        h = h + residual(a)
        h = h + residual(self.mlp(whole_seq(self.ln2(h))))
        return constrain(h, "batch", "seq", "embed")


class DecoderLayer(nn.Module):
    """``ln1``, ``self_attn`` (causal), ``ln_x``, ``cross_attn`` (over the
    encoder's memory), ``ln2``, ``mlp`` (``_dec_layer``, :78)."""

    def __init__(self, cfg: LMConfig, *, dtype, device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.self_attn = Attention(cfg.d_model, cfg.attention, **kw)
        self.ln_x = RMSNorm(cfg.d_model, device=device)
        self.cross_attn = Attention(cfg.d_model, cfg.attention, **kw)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation, **kw)

    def forward(self, h: torch.Tensor, memory: torch.Tensor, cfg: LMConfig,
                cache: Optional[KVCache] = None, make_cache: bool = False,
                cache_size: int = 0, attn_impl: str = "auto"):
        """Returns (h, the self-attention's new cache or None)."""
        a, new_kv = attention_block(self.self_attn, whole_seq(self.ln1(h)),
                                    cfg.attention, cache=cache,
                                    make_cache=make_cache,
                                    cache_size=cache_size, impl=attn_impl)
        h = h + residual(a)
        h = h + residual(cross_attention_block(
            self.cross_attn, whole_seq(self.ln_x(h)), whole_seq(memory),
            cfg.attention, impl=attn_impl))
        h = h + residual(self.mlp(whole_seq(self.ln2(h))))
        return constrain(h, "batch", "seq", "embed"), new_kv


class EncDecLM(nn.Module):
    """The tied ``embed``, ``enc`` and ``dec`` layers in order, ``enc_ln``
    and ``final_ln`` (``init_encdec``, :24).  Weights are drawn from
    ``generator`` on ``device`` (default: a generator seeded with 0 there)
    as the reference draws them, leaf by leaf: dense ``(d_in, d_out)``
    weights ``N(0, 1) d_in^-0.5`` (the output projections over their own
    input width), the table ``N(0, 1) d^-0.5``, norm scales 0; in f32, cast
    to ``cfg.dtype``.  ``model(frames, tokens, labels)`` is
    ``encdec_loss``, so ``torch.func.functional_call`` runs the loss over a
    dict of parameters by name (``launch/steps.py``)."""

    def __init__(self, cfg: LMConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        missing = [what for what, off in (
            ("an encoder", cfg.encoder_layers <= 0),
            ("MoE", cfg.moe is not None), ("SSM", cfg.ssm is not None),
            ("attention-free stacks", cfg.attention is None),
            ("FFN-free blocks", cfg.d_ff <= 0)) if off]
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: the enc-dec model runs dense attention stacks "
                f"with an encoder; {', '.join(missing)}: not supported")
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(dtype=DTYPES[cfg.dtype], device=dev, generator=generator)
        self.cfg = cfg
        self.device = dev
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.enc = nn.ModuleList(EncoderLayer(cfg, **kw)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecoderLayer(cfg, **kw)
                                 for _ in range(cfg.num_layers))
        self.enc_ln = RMSNorm(cfg.d_model, device=dev)
        self.final_ln = RMSNorm(cfg.d_model, device=dev)

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor,
                labels: torch.Tensor, **kw):
        return encdec_loss(self, frames, tokens, labels, **kw)

    def head_table(self) -> torch.Tensor:
        """The tied table the logits are taken against."""
        return self.embed.table

    def params_from_reference(self, tree: Dict) -> "EncDecLM":
        """Load the reference's ``init_encdec`` pytree (numpy leaves) in
        place (``flatten_reference`` names its leaves).  Raises on a
        missing or extra leaf or a shape mismatch."""
        return load_flat(self, flatten_reference(tree, self.cfg))


def flatten_reference(tree: Dict, cfg: LMConfig) -> Dict[str, np.ndarray]:
    """The reference's ``init_encdec`` pytree (or a gradient of it) as
    ``{parameter name: leaf}`` in the port's names: ``tree["enc"]`` and
    ``tree["dec"]`` leaves are stacked ``(L, ...)`` (``jax.vmap`` over the
    layers), and layer ``l`` takes slice ``l`` (``flatten_into``)."""
    flat: Dict[str, np.ndarray] = {}
    counts = {"enc": cfg.encoder_layers, "dec": cfg.num_layers}
    for key, sub in tree.items():
        for layer in range(counts[key]) if key in counts else (None,):
            flatten_into(flat, key if layer is None else f"{key}.{layer}",
                         sub, layer)
    return flat


def init_encdec(cfg: LMConfig, *, generator: Optional[torch.Generator] = None,
                device="cuda") -> EncDecLM:
    """A model of ``cfg`` with its weights drawn as ``EncDecLM`` says.  The
    generator's stream is torch's, not ``jax.random``'s: the values differ
    from the reference's, their distributions do not."""
    return EncDecLM(cfg, device=device, generator=generator)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def encode(model: EncDecLM, frames: torch.Tensor, *,
           attn_impl: str = "auto") -> torch.Tensor:
    """frames (B, S_enc, D) -> memory (B, S_enc, D) in the model's dtype
    (``encode``, :59): the encoder layers with the attention config's
    ``causal=False``, then ``enc_ln``.  Each layer runs under
    ``checkpointed`` (the reference's ``jax.checkpoint`` body), which
    keeps nothing without a gradient."""
    cfg = model.cfg
    acfg = dataclasses.replace(cfg.attention, causal=False)
    h = frames.to(device=model.embed.table.device, dtype=DTYPES[cfg.dtype])
    h = constrain(h, "batch", "seq", "embed")
    for layer in model.enc:
        h = checkpointed(layer, layer, h, acfg, attn_impl)
    return model.enc_ln(h)


def _dec_layers(model: EncDecLM, tokens: torch.Tensor, memory: torch.Tensor,
                *, caches: Optional[Caches] = None, cache_length=None,
                make_cache: bool = False, cache_size: int = 0,
                attn_impl: str = "auto"):
    """The embedded tokens through the decoder layers: (x before
    ``final_ln``, new caches or None).  Each layer runs under
    ``checkpointed`` (the reference's ``jax.checkpoint`` body of
    ``encdec_loss``), which keeps nothing without a gradient."""
    cfg = model.cfg
    table = model.embed.table
    x = constrain(embed(table, tokens.to(table.device)), "batch", "seq",
                  "embed")
    memory = memory.to(device=table.device, dtype=table.dtype)
    new_caches: Caches = []
    for n, layer in enumerate(model.dec):
        inner = None
        if caches is not None:
            inner = KVCache(caches[n][0], caches[n][1], cache_length)

        def run(h, mem, layer=layer, inner=inner):
            return layer(h, mem, cfg, cache=inner, make_cache=make_cache,
                         cache_size=cache_size, attn_impl=attn_impl)
        x, new_kv = checkpointed(layer, run, x, memory)
        if new_kv is not None:
            new_caches.append((new_kv.k, new_kv.v))
    return x, (new_caches or None)


def decode_stack(model: EncDecLM, tokens: torch.Tensor, memory: torch.Tensor,
                 *, caches: Optional[Caches] = None, cache_length=None,
                 make_cache: bool = False, cache_size: int = 0,
                 attn_impl: str = "auto"):
    """tokens (B, S) over ``memory`` -> (f32 logits (B, S, V), new caches
    or None) (``decode_stack``, :97).  With ``caches`` (S = 1) the new rows
    are written into them in place (``attention_block``'s decode)."""
    x, new_caches = _dec_layers(model, tokens, memory, caches=caches,
                                cache_length=cache_length,
                                make_cache=make_cache, cache_size=cache_size,
                                attn_impl=attn_impl)
    return head_logits(model, x), new_caches


def encdec_loss(model: EncDecLM, frames: torch.Tensor, tokens: torch.Tensor,
                labels: torch.Tensor, *, attn_impl: str = "auto",
                ce_chunk: int = 2048, params=None):
    """Next-token cross-entropy over the decoder's tokens, chunked
    (``encdec_loss``, :117).  Returns ``(loss, {"ce": loss})``.

    The encoder and each decoder layer run under ``checkpointed`` (the
    reference's ``jax.checkpoint`` bodies: only each layer's input is
    kept, and the backward runs its forward again); the final norm's
    output goes to ``models/transformer.py::chunked_ce`` against the tied
    table (the reference's chunk rule and masks).

    ``params`` (a dict of tensors by parameter name) runs the loss through
    ``torch.func.functional_call`` with those tensors in place of the
    module's."""
    if params is not None:
        return torch.func.functional_call(
            model, params, (frames, tokens, labels),
            dict(attn_impl=attn_impl, ce_chunk=ce_chunk))
    memory = encode(model, frames, attn_impl=attn_impl)
    x, _ = _dec_layers(model, tokens, memory, attn_impl=attn_impl)
    loss = chunked_ce(model.cfg, model.embed.table, model.final_ln(x),
                      labels, ce_chunk)
    return loss, {"ce": loss}


def encdec_prefill(model: EncDecLM, frames: torch.Tensor,
                   tokens: torch.Tensor, cache_size: int, *,
                   attn_impl: str = "auto"):
    """Encode, then the decoder over the prompt with its self-attention
    caches built (``encdec_prefill``, :167).  Returns (last-token logits
    (B, 1, V), caches padded to ``cache_size``, memory, length () int32)."""
    memory = encode(model, frames, attn_impl=attn_impl)
    x, caches = _dec_layers(model, tokens, memory, make_cache=True,
                            cache_size=cache_size, attn_impl=attn_impl)
    length = torch.tensor(tokens.shape[1], dtype=torch.int32,
                          device=x.device)
    return head_logits(model, x[:, -1:]), caches, memory, length


def encdec_decode_step(model: EncDecLM, token: torch.Tensor, caches: Caches,
                       memory: torch.Tensor, length: torch.Tensor, *,
                       attn_impl: str = "auto"):
    """One decoder token over ``memory`` (``encdec_decode_step``, :175).
    token: (B, 1); writes the new rows into ``caches`` in place and returns
    (logits (B, 1, V), caches, length + 1)."""
    logits, new_caches = decode_stack(model, token, memory, caches=caches,
                                      cache_length=length,
                                      attn_impl=attn_impl)
    return logits, new_caches, length + 1


def init_dec_caches(cfg: LMConfig, batch: int, cache_size: int,
                    device="cuda") -> Caches:
    """Zeroed decoder caches, one ``(k, v)`` of (batch, Hkv, cache_size,
    head_dim) in the model's dtype per decoder layer (the reference's
    ``init_dec_caches_abstract``, :181, as real tensors)."""
    return zeroed_caches(cfg, batch, cache_size, device)


def init_dec_caches_abstract(cfg: LMConfig, batch: int,
                             cache_size: int) -> Caches:
    """``init_dec_caches`` on the ``meta`` device: the shapes and dtypes,
    no storage (``init_dec_caches_abstract``, :181)."""
    return zeroed_caches(cfg, batch, cache_size, "meta")
