"""GQA attention: projections, the prefill paths, the decode path.

Port of ``repro/nn/attention.py`` for the serving and training paths.
A prefill (or a training forward) runs one of three paths, chosen by
``attention_block(impl=)``:

  * ``cuda``   -- K5, the hand-written CUDA flash kernel
    (``kernels/flash_attention.py``), for every prefill on a card; under
    autograd its op's backward is K5's two backward kernels;
  * ``direct`` -- materialize the (Sq, Sk) scores; small sequences, tests;
  * the torch tier's long path -- ``flash_attention_xla`` (``flash_mha``
    of ``nn/flash_vjp.py``, blockwise online softmax with its own
    backward), as the reference's, with or without a gradient.

``cross_attention_block`` (the enc-dec decoder's attention over the
encoder's memory) takes the same tiers, non-causal; ``chunked_attention``
is the reference's blockwise plain version, which no path calls.

Decode (one new token against a padded KV cache whose ``length`` marks
validity) stays plain PyTorch, as the reference leaves it outside any
kernel.  GQA never materializes repeated K/V: the einsums run over a
(B, Hkv, G, ...) view.  Causal masking uses decode-style right alignment
(see kernels/flash_attention.py).  On a mesh (``launch/sharding.py``)
q, k and v are constrained as the reference's are (heads over `model`
where they divide it), and every prefill tier attends per shard
(``per_shard``); off a mesh the constraints are no-ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.config import AttentionConfig
from repro_torch.core.backend import CUDA, resolve_backend
from repro_torch.kernels import ops
from repro_torch.launch.sharding import (constrain, constrain_as,
                                        ctx_parallel_info)
from repro_torch.nn.flash_vjp import flash_mha
from repro_torch.nn.layers import apply_rope, init_normal, softcap

NEG_INF = -1e30
#: the torch tier attends directly up to this many tokens, then runs the
#: blockwise plain version (the reference's ``s <= 2048`` switch)
DIRECT_MAX_SEQ = 2048


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Hkv, Smax, D)
    v: torch.Tensor       # (B, Hkv, Smax, D)
    length: torch.Tensor  # () or (B,) int32 -- valid entries


class Attention(nn.Module):
    """``wq``/``wk``/``wv`` (d_model, heads * head_dim) and ``wo``."""

    def __init__(self, d_model: int, cfg: AttentionConfig, *, dtype, device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wq = init_normal((d_model, cfg.q_dim), d_model ** -0.5, **kw)
        self.wk = init_normal((d_model, cfg.kv_dim), d_model ** -0.5, **kw)
        self.wv = init_normal((d_model, cfg.kv_dim), d_model ** -0.5, **kw)
        self.wo = init_normal((cfg.q_dim, d_model), cfg.q_dim ** -0.5, **kw)


def _heads(t: torch.Tensor, n: int, hd: int, axis: str) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd); on a mesh the flat dim is first
    laid out as the ``n`` heads shard under ``axis`` (whole heads a rank,
    or gathered where n does not divide the axis)."""
    b, s, _ = t.shape
    return constrain_as(t, (b, s, n), "batch", None, axis).view(b, s, n, hd)


def _project(p, x: torch.Tensor, cfg: AttentionConfig, positions):
    """x: (B, S, D) -> q (B,Hq,S,hd), k/v (B,Hkv,S,hd), rope applied."""
    b, s, _ = x.shape
    q = _heads(x @ p.wq.to(x.dtype), cfg.num_heads, cfg.head_dim, "heads")
    k = _heads(x @ p.wk.to(x.dtype), cfg.num_kv_heads, cfg.head_dim,
               "kv_heads")
    v = _heads(x @ p.wv.to(x.dtype), cfg.num_kv_heads, cfg.head_dim,
               "kv_heads")
    q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta)
    # TP layout: heads over `model` where divisible (no-ops off a mesh)
    q = constrain(q, "batch", "heads", "seq_q", None)
    k = constrain(k, "batch", "kv_heads", None, None)
    v = constrain(v.transpose(1, 2), "batch", "kv_heads", None, None)
    return q, k, v


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    b, hq, s, d = q.shape
    return q.reshape(b, hkv, hq // hkv, s, d)


def direct_attention(q, k, v, *, causal: bool, window: int, cap: float,
                     kv_len=None) -> torch.Tensor:
    """Scores materialized; ``kv_len`` is a scalar (default Sk)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = _grouped(q, hkv).float() * d ** -0.5
    s = softcap(torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()), cap)
    kvl = sk if kv_len is None else int(kv_len)
    qpos = torch.arange(sq, device=q.device) + (kvl - sq)
    kpos = torch.arange(sk, device=q.device)
    m = (kpos[None, :] < kvl).expand(sq, sk)
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(m, s, NEG_INF)
    o = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      cap: float = 0.0, q_chunk: int = 2048,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Blockwise online-softmax attention (``chunked_attention``, :100):
    ``q_chunk`` queries against ``kv_chunk`` keys at a time, so at most
    (q_chunk, kv_chunk) scores a (batch, head) are live.  q is cast to f32
    and scaled by ``D^-0.5`` there; query row 0 sits at Sk - Sq.  The
    chunks (each cut to its sequence's length) must divide the sequences,
    as the reference asserts: no ragged last chunk."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    assert sq % q_chunk == 0 and sk % kv_chunk == 0, \
        (sq, q_chunk, sk, kv_chunk)
    nq, nk = sq // q_chunk, sk // kv_chunk
    q_off = sk - sq
    qs = q.float().reshape(b, hkv, g, nq, q_chunk, d) * d ** -0.5
    ks = k.float().reshape(b, hkv, nk, kv_chunk, d)
    vs = v.float().reshape(b, hkv, nk, kv_chunk, d)
    out = torch.empty((b, hkv, g, nq, q_chunk, d), dtype=torch.float32,
                      device=q.device)
    for qi in range(nq):
        qc = qs[:, :, :, qi]
        qpos = q_off + qi * q_chunk + torch.arange(q_chunk, device=q.device)
        shape = (b, hkv, g, q_chunk, 1)
        m_run = torch.full(shape, NEG_INF, device=q.device)
        l_run = torch.zeros(shape, device=q.device)
        acc = torch.zeros(shape[:-1] + (d,), device=q.device)
        for ki in range(nk):
            s = softcap(torch.einsum("bhgqd,bhkd->bhgqk", qc, ks[:, :, ki]),
                        cap)
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
            m = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                           device=q.device)
            if causal:
                m = m & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                m = m & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(m, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.where(m, torch.exp(s - m_safe), 0.0)
            alpha = torch.exp(torch.where(m_run <= NEG_INF / 2, NEG_INF,
                                          m_run - m_safe))
            l_run = l_run * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                             vs[:, :, ki])
            m_run = m_new
        out[:, :, :, qi] = acc / torch.where(l_run == 0.0, 1.0, l_run)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention_xla(q, k, v, *, causal: bool = True, window: int = 0,
                        cap: float = 0.0, q_chunk: int = 2048,
                        kv_chunk: int = 1024) -> torch.Tensor:
    """``flash_mha`` (``nn/flash_vjp.py``, hand-written backward) on the
    (B, Hq, S, D) layout (``flash_attention_xla``, :158): q is grouped and
    scaled by ``D^-0.5`` in its dtype, query row 0 sits at Sk - Sq.  The
    chunks are the reference's single-device choice, the live tile
    ``b * hq * qc * kc`` capped at 2^27 elements, but not halved until
    they divide the sequences: the port's ``flash_mha`` takes a ragged
    last chunk, where the reference's halving goes down to chunks of 1
    for an odd length (a prompt of 4097 tokens would loop over 4097^2
    tiles a layer).  On a mesh it runs per shard (``per_shard``).  Under
    a context-parallel profile (``ctx_parallel_info()`` not None) it
    raises ``NotImplementedError``: the reference's branch there (query
    slabs over `model` in a ``shard_map`` region, :169-196) is ROADMAP
    item 13.8's context-parallel part, not ported yet."""
    if ctx_parallel_info() is not None:
        raise NotImplementedError(
            "context-parallel flash attention (the reference's shard_map "
            "region over query slabs, nn/attention.py:169-196) is not "
            "ported yet: ROADMAP item 13.8, its context-parallel branch")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = _grouped(q, hkv) * (d ** -0.5)
    qc, kc = min(q_chunk, sq), min(kv_chunk, sk)
    while b * hq * qc * kc > (1 << 27) and (qc > 256 or kc > 256):
        if qc >= kc and qc > 256:
            qc //= 2
        elif kc > 256:
            kc //= 2
        else:
            break
    out = flash_mha(qg, k, v, sk - sq, causal, window, cap, qc, kc)
    return out.reshape(b, hq, sq, d)


def decode_attention(q: torch.Tensor, cache: KVCache, *, window: int = 0,
                     cap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, 1, D) against the padded cache; returns (B, Hq, 1, D).

    ``cache.length`` is () for a uniform batch or (B,) for per-slot lengths
    (the serving engine's continuous batching)."""
    b, hq, _, d = q.shape
    hkv, smax = cache.k.shape[1], cache.k.shape[2]
    qg = _grouped(q, hkv).float() * d ** -0.5
    s = softcap(torch.einsum("bhgqd,bhkd->bhgqk", qg, cache.k.float()), cap)
    kpos = torch.arange(smax, device=q.device)
    length = cache.length.to(q.device).expand(b)[:, None]
    m = kpos[None, :] < length                                # (B, Smax)
    if window > 0:
        m = m & (kpos[None, :] > length - 1 - window)
    s = torch.where(m[:, None, None, None, :], s, NEG_INF)
    o = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, dim=-1),
                     cache.v.float())
    return o.reshape(b, hq, 1, d).to(q.dtype)


def decode_on_mesh(q, cache: KVCache, *, window: int = 0,
                   cap: float = 0.0):
    """``decode_attention`` of a DTensor q over a cache whose sequence is
    split over mesh dims (``launch/specs.py``'s decode layout): each rank
    attends over its own keys for every head of its batch rows -- local
    max, sum and weighted values -- and the partial softmaxes are merged
    across the ranks that split the sequence (an all-reduce of the maxima,
    then of the rescaled sums and values), as GSPMD runs the reference's
    einsums over a sequence-sharded cache.  The output is placed by the
    batch.  ``cache.length`` is the new length (a plain tensor)."""
    mesh = cache.k.device_mesh
    kp = list(cache.k.placements)
    rows = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
            else Replicate() for pl in kp]
    split = [isinstance(pl, Shard) and pl.dim == 2 for pl in kp]
    ql = q.redistribute(mesh, rows).to_local()
    kl, vl = cache.k.to_local(), cache.v.to_local()
    b, hq, _, d = ql.shape
    hkv, n = kl.shape[1], kl.shape[2]
    idx = 0                     # this rank's slice of the sequence
    for i, sp in enumerate(split):
        if sp:
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    qg = _grouped(ql, hkv).float() * d ** -0.5
    sc = softcap(torch.einsum("bhgqd,bhkd->bhgqk", qg, kl.float()), cap)
    kpos = idx * n + torch.arange(n, device=ql.device)
    length = cache.length.to(ql.device).expand(b)[:, None]
    m = kpos[None, :] < length
    if window > 0:
        m = m & (kpos[None, :] > length - 1 - window)
    sc = torch.where(m[:, None, None, None, :], sc, NEG_INF)
    m_loc = sc.amax(-1, keepdim=True)

    def merged(t, op):
        pl = [Partial(op) if sp else r for sp, r in zip(split, rows)]
        return DTensor.from_local(t, mesh, pl, run_check=False) \
            .redistribute(mesh, rows).to_local()
    m_all = merged(m_loc, "max")
    p = torch.exp(sc - m_all)
    l_all = merged(p.sum(-1, keepdim=True), "sum")
    o = merged(torch.einsum("bhgqk,bhkd->bhgqd", p, vl.float()), "sum")
    o = (o / l_all).reshape(b, hq, 1, d).to(ql.dtype)
    return DTensor.from_local(o, mesh, rows, run_check=False)


def per_shard(attend, q, k, v):
    """``attend(q, k, v)`` (any prefill tier) on each rank's shard when q
    is a DTensor, else as it is.  Attention is independent per batch row
    and per head, so each rank attends over its batch rows and, where Hq
    divides the `model` axis, its query heads; K/V heads shard alike where
    Hkv divides it too, else each rank takes the KV heads its query heads
    read from K/V replicated over `model` (their gradient a partial sum
    over `model`), as GSPMD lays out the reference's grouped einsums.  The
    output keeps q's placements.  A context-parallel profile (q's
    sequence over `model`) is the reference's ``shard_map`` region, which
    is not ported yet and raises (ROADMAP item 13.8)."""
    if not isinstance(q, DTensor):
        return attend(q, k, v)
    if ctx_parallel_info() is not None:
        raise NotImplementedError(
            "context-parallel attention (the reference's shard_map region "
            "over query slabs, nn/attention.py:169-196) is not ported yet: "
            "ROADMAP item 13.8, its context-parallel branch")
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    hq, hkv = q.shape[1], k.shape[1]
    qp, kp, kgrad = [], [], []
    slice_kv = False
    for ax, pl in zip(names, q.placements):
        if ax == "model" and mesh.size(names.index(ax)) > 1:
            tp = mesh.size(names.index(ax))
            q_heads = hq % tp == 0 and (hkv % tp == 0 or tp % hkv == 0)
            kv_heads = q_heads and hkv % tp == 0
            slice_kv = q_heads and not kv_heads
            qp.append(Shard(1) if q_heads else Replicate())
            kp.append(Shard(1) if kv_heads else Replicate())
            kgrad.append(Partial() if slice_kv else kp[-1])
        else:
            b = Shard(0) if isinstance(pl, Shard) and pl.dim == 0 \
                else Replicate()
            qp.append(b)
            kp.append(b)
            kgrad.append(b)
    ql = q.redistribute(mesh, qp).to_local()
    kl = k.redistribute(mesh, kp).to_local(grad_placements=kgrad)
    vl = v.redistribute(mesh, kp).to_local(grad_placements=kgrad)
    if slice_kv:    # this rank's query heads read KV heads [lo, hi)
        n, g = ql.shape[1], hq // hkv
        r = mesh.get_local_rank("model")
        lo, hi = r * n // g, ((r + 1) * n - 1) // g + 1
        kl, vl = kl[:, lo:hi], vl[:, lo:hi]
    o = attend(ql, kl, vl)
    return DTensor.from_local(o, mesh, qp, run_check=False)


def attention_block(p, x: torch.Tensor, cfg: AttentionConfig, *,
                    layer_window: int = 0, cache: Optional[KVCache] = None,
                    make_cache: bool = False, cache_size: int = 0,
                    impl: str = "auto",
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (output (B,S,D), new/updated cache or None).

    ``p`` holds ``wq``/``wk``/``wv``/``wo`` (an ``Attention``).  Modes:
      * train/eval: cache=None, make_cache=False.
      * prefill:    cache=None, make_cache=True, cache_size=Smax.
      * decode:     cache=KVCache, S must be 1.  The new row is written
                    into the cache tensors IN PLACE at ``cache.length``
                    (the reference updates functionally; in place saves a
                    copy of the cache per token) and the returned cache
                    shares them, with ``length + 1``.

    ``impl`` picks the prefill path: ``"auto"`` resolves by device
    (``cuda`` on a card, ``torch`` on the CPU), ``"cuda"`` is K5,
    ``"torch"`` attends directly up to ``DIRECT_MAX_SEQ`` tokens and runs
    ``flash_attention_xla`` above (the reference's switch, :297-305),
    ``"direct"`` always attends directly.  When grad is enabled
    and q, k or v requires a gradient, the cuda tier runs K5's op under
    autograd (a forward that also stores the row logsumexp, and K5's
    backward kernels); without a gradient the launch is the serving
    path's, bit for bit.
    """
    b, s, _ = x.shape
    dev = x.device
    if cache is not None:
        if s != 1:
            raise ValueError(f"the decode path is single-token; got S={s}")
        length = cache.length.to(dev)
        if isinstance(length, DTensor):   # a mesh's replicated length
            length = length.full_tensor()
        if length.dim() == 0:
            positions = (length + torch.arange(s, device=dev))[None, :]
        else:  # per-slot lengths: (B,) -> (B, 1, 1), broadcast over heads
            positions = length[:, None, None]
    else:
        positions = torch.arange(s, device=dev)[None, :]
    q, k, v = _project(p, x, cfg, positions)

    new_cache = None
    cap = cfg.attn_logit_softcap
    if cache is not None:
        # A write past the end lands on the last row: only slots the engine
        # no longer serves run past it (JAX clamps or drops such writes).
        pos = length.clamp(max=cache.k.shape[2] - 1).long()
        if isinstance(cache.k, DTensor):
            # a mesh's cache (sequence over `model`) is updated as the
            # reference updates it, out of place, and keeps its layout
            def write(c, row):
                new = c.index_copy(2, pos.view(1), row.to(c.dtype))
                return new.redistribute(c.device_mesh, list(c.placements))
            cache = KVCache(write(cache.k, k), write(cache.v, v),
                            cache.length)
        elif pos.dim() == 0:
            cache.k.index_copy_(2, pos.view(1), k.to(cache.k.dtype))
            cache.v.index_copy_(2, pos.view(1), v.to(cache.v.dtype))
        else:  # scatter each slot's row at its own position
            bidx = torch.arange(b, device=dev)
            cache.k[bidx, :, pos] = k[:, :, 0].to(cache.k.dtype)
            cache.v[bidx, :, pos] = v[:, :, 0].to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, length + 1)
        if isinstance(q, DTensor):
            o = decode_on_mesh(q, new_cache, window=layer_window, cap=cap)
        else:
            o = decode_attention(q, new_cache, window=layer_window, cap=cap)
    else:
        tier = impl if impl == "direct" else resolve_backend(impl, dev)

        def attend(q, k, v):
            if tier == CUDA:
                return ops.flash_attention(
                    q.contiguous(), k.contiguous(), v.contiguous(),
                    causal=cfg.causal, window=layer_window, softcap=cap,
                    backend=CUDA)
            if tier == "direct" or s <= DIRECT_MAX_SEQ:
                return direct_attention(q, k, v, causal=cfg.causal,
                                        window=layer_window, cap=cap)
            return flash_attention_xla(q, k, v, causal=cfg.causal,
                                       window=layer_window, cap=cap)
        o = per_shard(attend, q, k, v)
        if make_cache:
            if cache_size < s:
                raise ValueError(f"cache_size={cache_size} < prompt {s}")
            pad = (0, 0, 0, cache_size - s)
            new_cache = KVCache(
                torch.nn.functional.pad(k, pad),
                torch.nn.functional.pad(v, pad),
                torch.tensor(s, dtype=torch.int32, device=dev))

    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return o @ p.wo.to(o.dtype), new_cache


def cross_attention_block(p, x: torch.Tensor, memory: torch.Tensor,
                          cfg: AttentionConfig, *,
                          impl: str = "auto") -> torch.Tensor:
    """Encoder-decoder cross-attention (``cross_attention_block``, :318):
    queries from ``x`` (B, S, D), keys and values from ``memory`` (B, Sm,
    D), projected as ``attention_block`` projects them; no rope, no mask.
    Returns (B, S, D).

    ``impl`` as ``attention_block``'s: the ``torch`` tier attends directly
    when ``S <= DIRECT_MAX_SEQ`` and ``Sm <= DIRECT_MAX_SEQ`` and runs
    ``flash_attention_xla(causal=False)`` otherwise (the reference's
    switch); ``"direct"`` always attends directly; the ``cuda`` tier
    launches K5 with ``causal=False`` at every call -- a prefill (S the
    prompt, Sm the frames), a decode step (S = 1) and, under autograd,
    its op's backward."""
    b, s, _ = x.shape
    sm = memory.shape[1]
    q = _heads(x @ p.wq.to(x.dtype), cfg.num_heads, cfg.head_dim, "heads")
    k = _heads(memory @ p.wk.to(x.dtype), cfg.num_kv_heads, cfg.head_dim,
               "kv_heads")
    v = _heads(memory @ p.wv.to(x.dtype), cfg.num_kv_heads, cfg.head_dim,
               "kv_heads")
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    tier = impl if impl == "direct" else resolve_backend(impl, x.device)

    def attend(q, k, v):
        if tier == CUDA:
            return ops.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=False,
                                       backend=CUDA)
        if tier == "direct" or (s <= DIRECT_MAX_SEQ and
                                sm <= DIRECT_MAX_SEQ):
            return direct_attention(q, k, v, causal=False, window=0,
                                    cap=0.0)
        return flash_attention_xla(q, k, v, causal=False)
    o = per_shard(attend, q, k, v)
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return o @ p.wo.to(o.dtype)
