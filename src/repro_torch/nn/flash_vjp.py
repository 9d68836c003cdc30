"""Flash attention with a hand-written backward: O(chunk^2) memory in the
forward AND the backward.

Port of ``repro/nn/flash_vjp.py``: the torch tier's long-sequence
attention under autograd, and the yardstick of K5's backward kernels.  It
saves only (q, k, v, out, row logsumexp) and rebuilds each (q_chunk x
kv_chunk) score tile in the backward, so autograd never holds the
probabilities of every chunk.

Math (per tile, with optional logit softcap c and masks M):
  Z = Q K^T (q pre-scaled) ; S = c tanh(Z/c) ; P = exp(S - L_row)
  dV += P^T dO
  dP  = dO V^T ;  D = rowsum(dO * O)
  dS  = P * (dP - D)
  dZ  = dS * (1 - (S/c)^2)            (tanh softcap Jacobian; dZ=dS if c=0)
  dQ += dZ K ; dK += dZ^T Q

GQA: q is grouped (B, Hkv, G, Sq, D) and K/V gradients sum over G.  The
recomputed dS and P tiles are rounded to q's dtype before their products,
which accumulate in f32 (the reference's ``tile_dtype``); with f32 inputs
every rounding is a no-op.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def _chunks(n: int, chunk: int):
    return [(i, min(n, i + chunk)) for i in range(0, n, chunk)]


def _fwd_scan(q, k, v, q_start: int, *, causal: bool, window: int,
              cap: float, q_chunk: int, kv_chunk: int):
    """Returns (out, lse) with out (B,Hkv,G,Sq,D) in q's dtype, lse
    (B,Hkv,G,Sq) f32 (``_fwd_scan``, :42)."""
    b, hkv, g, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((b, hkv, g, sq), dtype=torch.float32, device=dev)
    for q0, q1 in _chunks(sq, q_chunk):
        qc = q[:, :, :, q0:q1].float()
        qpos = q_start + torch.arange(q0, q1, device=dev)
        shape = (b, hkv, g, q1 - q0, 1)
        m_run = torch.full(shape, NEG_INF, device=dev)
        l_run = torch.zeros(shape, device=dev)
        acc = torch.zeros(shape[:-1] + (d,), device=dev)
        for k0, k1 in _chunks(sk, kv_chunk):
            kc, vc = k[:, :, k0:k1].float(), v[:, :, k0:k1].float()
            z = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc)
            if cap > 0:
                z = cap * torch.tanh(z / cap)
            msk = _mask(qpos, torch.arange(k0, k1, device=dev), causal,
                        window)
            z = torch.where(msk, z, NEG_INF)
            m_new = torch.maximum(m_run, z.amax(-1, keepdim=True))
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.where(msk, torch.exp(z - m_safe), 0.0)
            alpha = torch.exp(torch.where(m_run <= NEG_INF / 2, NEG_INF,
                                          m_run - m_safe))
            l_run = l_run * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
            m_run = m_new
        l_safe = torch.where(l_run == 0.0, 1.0, l_run)
        out[:, :, :, q0:q1] = (acc / l_safe).to(q.dtype)
        lse[:, :, :, q0:q1] = (m_run + torch.log(l_safe))[..., 0]
    return out, lse


def _tile_grads(qc, doc, lsec, dc, kc, vc, msk, cap: float, tile_dtype):
    """Recompute one (q_chunk x kv_chunk) tile; return (ds, p) rounded to
    ``tile_dtype`` and held in f32 for the f32-accumulated products
    (``_tile_grads``, :112)."""
    z = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc)
    s = cap * torch.tanh(z / cap) if cap > 0 else z
    p = torch.where(msk, torch.exp(torch.where(msk, s - lsec, 0.0)), 0.0)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vc)
    ds = p * (dp - dc)
    if cap > 0:
        ds = ds * (1.0 - torch.square(s / cap))
    return ds.to(tile_dtype).float(), p.to(tile_dtype).float()


def _flash_bwd(q, k, v, q_start: int, out, lse, dout, *, causal: bool,
               window: int, cap: float, q_chunk: int, kv_chunk: int):
    """Two-pass flash backward (``_flash_bwd``, :133).  Pass A emits dq a
    q chunk at a time, accumulated over the kv chunks; pass B emits dk and
    dv a kv chunk at a time, accumulated over the q chunks."""
    b, hkv, g, sq, d = q.shape
    sk = k.shape[2]
    dev, tdt = q.device, q.dtype
    delta = (dout.float() * out.float()).sum(-1)[..., None]
    lse = lse[..., None]
    qpos = q_start + torch.arange(sq, device=dev)
    kpos = torch.arange(sk, device=dev)
    qch, kch = _chunks(sq, q_chunk), _chunks(sk, kv_chunk)

    def tile(q0, q1, k0, k1):
        qc = q[:, :, :, q0:q1].float()
        doc = dout[:, :, :, q0:q1].float()
        kc, vc = k[:, :, k0:k1].float(), v[:, :, k0:k1].float()
        msk = _mask(qpos[q0:q1], kpos[k0:k1], causal, window)
        ds, p = _tile_grads(qc, doc, lse[:, :, :, q0:q1],
                            delta[:, :, :, q0:q1], kc, vc, msk, cap, tdt)
        return qc, doc, kc, ds, p

    dq = torch.empty((b, hkv, g, sq, d), dtype=tdt, device=dev)
    for q0, q1 in qch:                               # pass A: dq
        acc = torch.zeros((b, hkv, g, q1 - q0, d), device=dev)
        for k0, k1 in kch:
            _, _, kc, ds, _ = tile(q0, q1, k0, k1)
            acc += torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                kc.to(tdt).float())
        dq[:, :, :, q0:q1] = acc.to(tdt)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for k0, k1 in kch:                               # pass B: dk, dv
        dk_acc = torch.zeros((b, hkv, k1 - k0, d), device=dev)
        dv_acc = torch.zeros((b, hkv, k1 - k0, d), device=dev)
        for q0, q1 in qch:
            qc, doc, _, ds, p = tile(q0, q1, k0, k1)
            dk_acc += torch.einsum("bhgqk,bhgqd->bhkd", ds,
                                   qc.to(tdt).float())
            dv_acc += torch.einsum("bhgqk,bhgqd->bhkd", p,
                                   doc.to(tdt).float())
        dk[:, :, k0:k1] = dk_acc.to(k.dtype)
        dv[:, :, k0:k1] = dv_acc.to(v.dtype)
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """``flash_mha``'s custom VJP: the forward saves (q, k, v, out, lse)
    and the backward recomputes each tile."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, causal, window, cap, q_chunk,
                kv_chunk):
        opts = dict(causal=causal, window=window, cap=cap, q_chunk=q_chunk,
                    kv_chunk=kv_chunk)
        out, lse = _fwd_scan(q, k, v, q_start, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.q_start, ctx.opts = q_start, opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, ctx.q_start, out, lse, dout,
                                **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_start=0, causal: bool = True, window: int = 0,
              cap: float = 0.0, q_chunk: int = 2048,
              kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B,Hkv,G,Sq,D) pre-scaled; k/v: (B,Hkv,Sk,D).  Out like q.

    ``q_start``: the absolute position of q row 0 (an int or a 0-d
    tensor; the reference passes an f32 scalar and truncates it to int32):
    query i sits at ``q_start + i`` for the causal mask and the window.
    Chunks need not divide the sequences (the reference's caller picks
    dividing ones)."""
    return FlashMHA.apply(q, k, v, int(q_start), causal, window, cap,
                          q_chunk, kv_chunk)
