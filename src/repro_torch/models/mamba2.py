"""Mamba-2 block: SSD (state-space duality) with chunked execution.

Port of ``repro/models/mamba2.py``.  [arXiv:2405.21060]

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t B_t x_t ;  y_t = C_t h_t

Heads H = d_inner / head_dim; B and C are shared across the heads of each
of G groups.  Train and prefill run the chunked scan (``ssd_chunked``);
decode is the O(1)-state recurrence step.  The reference runs its SSD in
plain XLA, with no Pallas kernel, so this port is plain PyTorch: the torch
and cuda tiers run the same code.

``Mamba2`` holds the reference's ``init_mamba2`` leaves by name:
``z_proj``, ``xbc_proj``, ``dt_proj``, ``out_proj`` and ``conv_w`` in the
model's dtype; ``conv_b``, ``A_log``, ``D``, ``dt_bias`` and the gated
norm's ``norm.scale`` in f32 (f64 in an f64 yardstick model).

The dtypes of each branch are the reference's:

  * prefill and training: the conv in x's dtype; the SSD's scores, decay
    mask and ``dt * x`` in ``compute_dtype``, their products accumulated
    in f32; the state recurrence in f32;
  * decode: the conv in f32 on the f32 conv cache, the state in f32, the
    output f32 until it is cast to x's dtype.

Two departures, both where the reference is not what it means:

  * the conv tail a prefill stores is always ``(B, conv_dim, d_conv - 1)``,
    zero-padded on the left when the prompt is shorter than that (the
    zeros the causal conv saw); the reference keeps a narrower slice then,
    which its serving engine broadcasts across the slot's tail;
  * decode writes the new state and conv tail into the cache it was given
    (``copy_``), so a captured decode step replays over the same storage.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.config import SSMConfig
from repro_torch.launch.sharding import constrain
from repro_torch.nn.layers import (DTYPES, RMSNorm, acc_dtype, dense,
                                   gated_rmsnorm, init_normal, shard_sums,
                                   silu)


class SSMCache(NamedTuple):
    state: torch.Tensor    # (B, H, N, P) SSM state, f32
    conv: torch.Tensor     # (B, conv_dim, d_conv - 1) conv tail, f32
    length: torch.Tensor   # () or (B,) int32


def conv_dim(d_model: int, cfg: SSMConfig) -> int:
    """Channels of the conv: x, then B and C of every group."""
    return cfg.d_inner(d_model) + 2 * cfg.n_groups * cfg.d_state


class Mamba2(nn.Module):
    """The parameters of one Mamba-2 block (``init_mamba2``, :34-58): the
    split input projections (``z_proj`` (d, d_inner), ``xbc_proj`` (d,
    conv_dim), ``dt_proj`` (d, H)), ``out_proj`` (d_inner, d), the
    depthwise conv ``conv_w`` (conv_dim, d_conv) ~ N(0, 0.01) and
    ``conv_b`` = 0, ``A_log`` = log(linspace(1, 16, H)), ``D`` = 1,
    ``dt_bias`` = softplus^-1(0.01), the gated norm ``norm``."""

    def __init__(self, d_model: int, cfg: SSMConfig, *, dtype, device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        d_in, h = cfg.d_inner(d_model), cfg.n_heads(d_model)
        cd = conv_dim(d_model, cfg)
        acc = acc_dtype(dtype)
        self.cfg = cfg
        self.z_proj = init_normal((d_model, d_in), d_model ** -0.5, **kw)
        self.xbc_proj = init_normal((d_model, cd), d_model ** -0.5, **kw)
        self.dt_proj = init_normal((d_model, h), d_model ** -0.5, **kw)
        self.out_proj = init_normal((d_in, d_model), d_in ** -0.5, **kw)
        self.conv_w = init_normal((cd, cfg.d_conv), 0.1, **kw)
        f32 = dict(dtype=torch.float32, device=device)
        self.conv_b = nn.Parameter(torch.zeros(cd, dtype=acc, device=device))
        self.A_log = nn.Parameter(
            torch.log(torch.linspace(1.0, 16.0, h, **f32)).to(acc))
        self.D = nn.Parameter(torch.ones(h, dtype=acc, device=device))
        self.dt_bias = nn.Parameter(
            torch.log(torch.expm1(torch.full((h,), 1e-2, **f32))).to(acc))
        self.norm = RMSNorm(d_in, device=device)

    def forward(self, x: torch.Tensor, *, cache: Optional[SSMCache] = None,
                make_cache: bool = False):
        return mamba2_block(self, x, cache=cache, make_cache=make_cache)


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d, then SiLU (``_causal_conv``, :61-77).
    xbc: (B, S, C); w: (C, K); b: (C,); tail: (B, C, K - 1) or None (zeros).
    The conv is computed in f32 over x's dtype's values and rounded once to
    x's dtype; the bias is added, and the SiLU taken, in x's dtype."""
    c, k = w.shape
    xt = xbc.transpose(1, 2)                                  # (B, C, S)
    if tail is None:
        xt = F.pad(xt, (k - 1, 0))
    else:
        xt = torch.cat([tail.to(xt.dtype), xt], dim=2)
    acc = acc_dtype(xt.dtype)
    out = F.conv1d(xt.to(acc), w.to(xt.dtype).to(acc)[:, None, :],
                   groups=c).to(xt.dtype)
    out = out + b.to(out.dtype)[None, :, None]
    return silu(out).transpose(1, 2)                          # (B, S, C)


def conv_tail(xbc: torch.Tensor, d_conv: int) -> torch.Tensor:
    """The conv cache a prefill of ``xbc`` (B, S, C) leaves: its last
    ``d_conv - 1`` positions as (B, C, d_conv - 1) in f32, zero-padded on
    the left when S is shorter."""
    k1 = d_conv - 1
    xt = xbc.transpose(1, 2)[:, :, max(0, xbc.shape[1] - k1):]
    xt = F.pad(xt, (k1 - xt.shape[2], 0))
    return xt.to(acc_dtype(xbc.dtype))


def ssd_chunked(x: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, cfg: SSMConfig,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (``_ssd_chunked``, :80-145).

    x: (B, S, H, P); b_mat, c_mat: (B, S, G, N); dt: (B, S, H) f32; a: (H,)
    (< 0).  Returns (y (B, S, H, P) f32, final state (B, H, N, P) f32).
    Chunks of ``min(chunk_size, S)`` steps, which must divide S.

    The reference scans the chunks one by one.  Here every chunk's
    intra-chunk terms -- ``y_diag`` and the chunk's own state contribution
    ``s_c`` -- are computed for all chunks at once, the same operations on
    (B, nc, ...) tensors; only the f32 recurrence ``state = state *
    exp(cum_last) + s_c`` runs chunk by chunk, and the states entering each
    chunk then give every chunk's ``y_off`` at once.  The decay mask is
    ``exp`` of the masked segment sums (-inf above the diagonal), which is
    the reference's ``where(tri, exp(...), 0)`` without an overflowing
    ``exp`` in the masked half."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    hg = h // g
    q = min(cfg.chunk_size, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    nc = s // q
    cdt = DTYPES[cfg.compute_dtype]
    acc = dt.dtype

    xg = x.reshape(bsz, nc, q, g, hg, p)
    bg = b_mat.reshape(bsz, nc, q, g, n)
    cg = c_mat.reshape(bsz, nc, q, g, n)
    dtc = dt.reshape(bsz, nc, q, h)
    cum = torch.cumsum(dtc * a, dim=2)                        # (B,nc,Q,H)
    cum_g = cum.reshape(bsz, nc, q, g, hg)

    # intra-chunk: the (B, nc, G, Hg, Q, Q) tensors, in compute_dtype
    scores = torch.einsum("bcign,bcjgn->bcgij", cg.to(cdt), bg.to(cdt))
    diff = cum_g.permute(0, 1, 3, 4, 2)                       # (B,nc,G,Hg,Q)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    seg = (diff[..., :, None] - diff[..., None, :]).masked_fill(
        ~tri, float("-inf"))
    m = torch.exp(seg).to(cdt)
    dtx = (xg * dtc.reshape(bsz, nc, q, g, hg)[..., None]).to(cdt)
    t_mat = scores[:, :, :, None] * m                         # (B,nc,G,Hg,Q,Q)
    # preferred_element_type=f32: the operands upcast (a product of two
    # bf16 values is exact in f32), summed in f32
    y_diag = torch.einsum("bcghij,bcjghp->bcighp", t_mat.to(acc),
                          dtx.to(acc))

    # each chunk's state contribution, then the recurrence over chunks
    cum_last = cum[:, :, -1:, :]                              # (B,nc,1,H)
    wg = torch.exp(cum_last - cum).reshape(bsz, nc, q, g, hg)
    s_c = torch.einsum("bcjgn,bcjghp->bcghnp", bg.to(acc),
                       dtx.to(acc) * wg[..., None]).reshape(bsz, nc, h, n, p)
    decay = torch.exp(cum_last[:, :, 0])[..., None, None]     # (B,nc,H,1,1)
    state = init_state if init_state is not None else \
        torch.zeros((bsz, h, n, p), dtype=acc, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * decay[:, c] + s_c[:, c]
    prev = torch.stack(entering, 1).reshape(bsz, nc, g, hg, n, p)

    # off-diagonal: y_off[i] = exp(cum_i) * C_i . state entering the chunk
    y_off = torch.einsum("bcqgn,bcghnp->bcqghp", cg.to(acc), prev)
    y_off = y_off * torch.exp(cum_g)[..., None]
    return (y_off + y_diag).reshape(bsz, s, h, p), state


def ssd_reference(x: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                  dt: torch.Tensor, a: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential per-token oracle (``ssd_reference``, :148-162), in
    the inputs' dtype."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    hg = h // g
    state = torch.zeros((bsz, h, n, p), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a[None, :])                 # (B,H)
        bt = b_mat[:, t].repeat_interleave(hg, dim=1)         # (B,H,N)
        ct = c_mat[:, t].repeat_interleave(hg, dim=1)
        state = state * da[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bt, x[:, t] * dt[:, t][..., None])
        ys.append(torch.einsum("bhn,bhnp->bhp", ct, state))
    return torch.stack(ys, dim=1), state


def mamba2_block(p: Mamba2, x: torch.Tensor, *,
                 cache: Optional[SSMCache] = None, make_cache: bool = False
                 ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, cache or None)
    (``mamba2_block``, :165-245).  Decode when ``cache`` is given (S = 1):
    the new state and conv tail are written into ``cache.state`` and
    ``cache.conv`` in place, and the returned cache holds those tensors.
    Otherwise the chunked scan, padded to a multiple of the chunk (zero
    ``dt`` in the padded steps, so the final state is exact) when S is
    longer than a chunk; ``make_cache`` returns the final state and the
    full-width conv tail (``conv_tail``).  On a mesh (x a DTensor) train
    and prefill take the reference's layout (``_on_mesh``), a decode step
    runs per batch shard (``_per_batch_shard``)."""
    if isinstance(x, DTensor):
        if cache is None:
            return _on_mesh(p, x, make_cache)
        return _per_batch_shard(p, x, cache, make_cache)
    cfg = p.cfg
    bsz, s, d_model = x.shape
    d_in, h = cfg.d_inner(d_model), cfg.n_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    acc = acc_dtype(x.dtype)

    z = dense(p.z_proj, x)
    xbc = dense(p.xbc_proj, x)
    dt = F.softplus(dense(p.dt_proj, x).to(acc) + p.dt_bias)
    a = -torch.exp(p.A_log.to(acc))

    if cache is not None:  # ---------- decode: single token ----------
        if s != 1:
            raise ValueError(f"decode takes one token, got {s}")
        conv_in = torch.cat([cache.conv, xbc.transpose(1, 2).to(
            cache.conv.dtype)], dim=2)                        # (B, C, K)
        conv_out = (conv_in * p.conv_w[None].to(conv_in.dtype)).sum(-1) + \
            p.conv_b[None]
        xbc_act = silu(conv_out)                              # (B, conv_dim)
        xs = xbc_act[:, :d_in].reshape(bsz, h, -1).to(acc)    # (B, H, P)
        hg = h // cfg.n_groups
        bt = xbc_act[:, d_in:d_in + gn].reshape(bsz, cfg.n_groups, -1) \
            .repeat_interleave(hg, dim=1)                     # (B, H, N)
        ct = xbc_act[:, d_in + gn:].reshape(bsz, cfg.n_groups, -1) \
            .repeat_interleave(hg, dim=1)
        dt1 = dt[:, 0]                                        # (B, H)
        da = torch.exp(dt1 * a[None, :])
        state = cache.state * da[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bt, xs * dt1[..., None])
        y = torch.einsum("bhn,bhnp->bhp", ct, state)
        y = y + p.D[None, :, None] * xs
        y = y.reshape(bsz, 1, d_in).to(x.dtype)
        cache.state.copy_(state)
        cache.conv.copy_(conv_in[:, :, 1:])
        new_cache = SSMCache(cache.state, cache.conv, cache.length + 1)
    else:  # ---------- train / prefill: chunked scan ----------
        xbc_raw = xbc      # unpadded: the conv tail for the cache
        q = cfg.chunk_size
        s_pad = -(-s // q) * q if s > q else s
        if s_pad != s:
            xbc = F.pad(xbc, (0, 0, 0, s_pad - s))
            dt = F.pad(dt, (0, 0, 0, s_pad - s))
        xbc_act = causal_conv(xbc, p.conv_w, p.conv_b)
        xs = xbc_act[..., :d_in].reshape(bsz, s_pad, h, -1)
        b_mat = xbc_act[..., d_in:d_in + gn].reshape(bsz, s_pad,
                                                     cfg.n_groups, -1)
        c_mat = xbc_act[..., d_in + gn:].reshape(bsz, s_pad,
                                                 cfg.n_groups, -1)
        cdt = DTYPES[cfg.compute_dtype]
        y, state = ssd_chunked(xs.to(cdt), b_mat.to(cdt), c_mat.to(cdt),
                               dt, a, cfg)
        y = y + p.D[None, None, :, None] * xs.to(acc)
        y = y[:, :s].reshape(bsz, s, d_in).to(x.dtype)
        new_cache = None
        if make_cache:
            new_cache = SSMCache(
                state, conv_tail(xbc_raw, cfg.d_conv),
                torch.tensor(s, dtype=torch.int32, device=x.device))

    y = gated_rmsnorm(p.norm.scale, y, z)
    return dense(p.out_proj, y), new_cache


_PARAMS = ("z_proj", "xbc_proj", "dt_proj", "out_proj", "conv_w", "conv_b",
           "A_log", "D", "dt_bias")


def _per_batch_shard(p: Mamba2, x, cache, make_cache: bool):
    """A decode step on a mesh: each rank runs the block over its batch
    rows with the parameters gathered (their gradients partial sums over
    the mesh dims that split the batch), the output and caches placed by
    the batch; every rank computes every head of its rows (train and
    prefill split them, ``_on_mesh``)."""
    mesh = x.device_mesh
    rows = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
            else Replicate() for pl in x.placements]
    sums = shard_sums(rows)
    whole = [Replicate()] * mesh.ndim

    def local(t):
        return t.redistribute(mesh, whole).to_local(grad_placements=sums)
    lp = SimpleNamespace(cfg=p.cfg, norm=SimpleNamespace(
        scale=local(p.norm.scale)), **{k: local(getattr(p, k))
                                       for k in _PARAMS})
    inner = None
    if cache is not None:
        inner = SSMCache(*(t.redistribute(mesh, rows).to_local()
                           for t in (cache.state, cache.conv)),
                         cache.length.full_tensor()
                         if isinstance(cache.length, DTensor)
                         else cache.length)
    out, new = mamba2_block(lp, x.redistribute(mesh, rows).to_local(
        grad_placements=rows), cache=inner, make_cache=make_cache)
    place = lambda t: DTensor.from_local(t, mesh, rows,  # noqa: E731
                                         run_check=False)
    if new is not None:
        new = SSMCache(place(new.state), place(new.conv), new.length)
    return place(out), new


def _local(fn, ins, outs):
    """``fn`` over each rank's local shards: ``ins`` are (DTensor,
    placements, gradient placements), ``outs`` the placements of ``fn``'s
    outputs."""
    mesh = ins[0][0].device_mesh
    res = fn(*(t.redistribute(mesh, pl).to_local(grad_placements=gpl)
               for t, pl, gpl in ins))
    return tuple(DTensor.from_local(r, mesh, pl, run_check=False)
                 for r, pl in zip(res, outs))


def _follow(placements, src: int, dst: int) -> list:
    """Placements of a tensor whose dim ``dst`` is split where a tensor
    placed as ``placements`` splits its dim ``src``, and is whole
    elsewhere (a per-channel or per-head parameter beside activations)."""
    return [Shard(dst) if isinstance(pl, Shard) and pl.dim == src
            else Replicate() for pl in placements]


def _grads(placements, src: int, dst: int) -> list:
    """The gradient placements of a ``_follow(placements, src, dst)``
    parameter: split where it is, partial sums over the batch's mesh dims
    (each rank sees its rows), whole elsewhere."""
    return [Shard(dst) if isinstance(pl, Shard) and pl.dim == src
            else Partial() if isinstance(pl, Shard) and pl.dim == 0
            else Replicate() for pl in placements]


def _on_mesh(p: Mamba2, x, make_cache: bool):
    """Train and prefill on a mesh, laid out as the reference constrains
    them (:180-234): the projections' outputs over `model` by channel
    (``"mlp"``) and ``dt`` by head; the causal conv per channel shard;
    x, B and C gathered over the channels, then x split by head and B, C
    whole (each group's B and C serve all its heads); the SSD per head
    shard and batch shard; the gated norm and ``out_proj`` as DTensor ops
    (the norm's mean over the split d_inner a reduction)."""
    cfg = p.cfg
    bsz, s, d_model = x.shape
    d_in, h = cfg.d_inner(d_model), cfg.n_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    acc = acc_dtype(x.dtype)
    q = cfg.chunk_size
    s_pad = -(-s // q) * q if s > q else s

    z = constrain(dense(p.z_proj, x), "batch", None, "mlp")
    xbc = constrain(dense(p.xbc_proj, x), "batch", None, "mlp")
    dt = F.softplus(dense(p.dt_proj, x).to(acc) + p.dt_bias)
    dt = constrain(dt, "batch", None, "heads")
    xp = list(xbc.placements)
    (xbc_act,) = _local(
        lambda xl, w, b: (causal_conv(F.pad(xl, (0, 0, 0, s_pad - s)), w,
                                      b),),
        [(xbc, xp, xp), (p.conv_w, _follow(xp, 2, 0), _grads(xp, 2, 0)),
         (p.conv_b, _follow(xp, 2, 0), _grads(xp, 2, 0))], [xp])
    xbc_act = constrain(xbc_act, "batch", None, "mlp")
    whole = constrain(xbc_act, "batch", None, None)
    xs = constrain(whole[..., :d_in].reshape(bsz, s_pad, h, -1), "batch",
                   None, "heads", None)
    b_mat = constrain(whole[..., d_in:d_in + gn].reshape(
        bsz, s_pad, cfg.n_groups, -1), "batch", None, None, None)
    c_mat = constrain(whole[..., d_in + gn:].reshape(
        bsz, s_pad, cfg.n_groups, -1), "batch", None, None, None)
    cdt = DTYPES[cfg.compute_dtype]
    hp, bp = list(xs.placements), list(b_mat.placements)
    state_pl = _follow(hp, 2, 1)
    for i, pl in enumerate(hp):
        if isinstance(pl, Shard) and pl.dim == 0:
            state_pl[i] = Shard(0)

    def ssd(xl, bl, cl, dtl, a_log):
        dtl = F.pad(dtl, (0, 0, 0, s_pad - s))
        return ssd_chunked(xl.to(cdt), bl.to(cdt), cl.to(cdt), dtl,
                           -torch.exp(a_log.to(acc)), cfg)
    # B and C's gradients: split by batch as they are, partial sums over
    # the head shards that read them
    bc_grads = [Partial() if isinstance(h_, Shard) and h_.dim == 2 else b_
                for h_, b_ in zip(hp, bp)]
    y, state = _local(ssd, [
        (xs, hp, hp), (b_mat, bp, bc_grads), (c_mat, bp, bc_grads),
        (dt, list(dt.placements), list(dt.placements)),
        (p.A_log, _follow(hp, 2, 0), _grads(hp, 2, 0))], [hp, state_pl])
    y = constrain(y, "batch", None, "heads", None)
    y = y + p.D[None, None, :, None] * xs.to(acc)
    y = y[:, :s].reshape(bsz, s, d_in).to(x.dtype)
    new_cache = None
    if make_cache:
        (tail,) = _local(lambda xl: (conv_tail(xl, cfg.d_conv),),
                         [(xbc, xp, xp)], [_follow(xp, 2, 1)])
        new_cache = SSMCache(state, tail, torch.tensor(
            s, dtype=torch.int32, device=x.device))
    y = gated_rmsnorm(p.norm.scale, y, z)
    return dense(p.out_proj, y), new_cache
