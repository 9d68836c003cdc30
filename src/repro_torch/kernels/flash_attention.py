"""K5 ``flash_attention``: blockwise online-softmax attention.

Port of the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(:111, body ``_flash_kernel`` :40) to the hand-written CUDA kernels of
``csrc/flash_attention.cu``, both products on the tensor cores: bf16
inputs run ``wgmma_kernel`` (P rounded to bf16 for the second product),
f32 inputs ``tf32x3_kernel`` (3xTF32 products, each operand split into TF32
hi and lo parts, fresh accumulators per 64 columns of D and per KV tile).  q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D),
kv_len: (B,) int32; GQA reads KV head ``h // (Hq // Hkv)``; q is scaled by
``D^-0.5`` in q's dtype; query i sits at position ``kv_len[b] - Sq + i``
(right alignment) for the causal mask and the sliding window
``kpos > qpos - window``; an optional tanh softcap; running max, sum and
accumulator in f32; an all-masked row gives 0; one rounding to q's dtype.

``flash_attention`` is the wrapper over the opaque op
``repro_torch::flash_attention`` (``flash_attention_op``, defined with
``torch.library.Library`` and a kernel per dispatch key): tensors on the
CPU take ``flash_attention_plain``, CUDA tensors launch the kernel or
raise, fake tensors (a ``FakeTensorMode`` trace, the dry run) get the
shapes and the checks that need no data and launch nothing.
``flash_attention.launches`` counts the launches, and
``flash_attention.by_shape`` the same launches by ``launch_key``.  With
``return_lse=True`` the kernel also stores each row's logsumexp ``m +
log(l)`` (f32, (B, Hq, Sq)), which the backward needs; ``out`` is the same
bit for bit.

The backward (no TPU kernel: the reference differentiates its XLA flash
path, ``repro/nn/flash_vjp.py::_flash_bwd``, whose two passes this
follows) is ``flash_attention_bwd``: on CUDA tensors two kernels of
``csrc/flash_attention.cu`` -- a dq pass (dq, and the row sums
``rowsum(dO * O)`` the second pass reads; in bf16 also q scaled and
rounded as the forward stages it) and a dk/dv pass (dk and dv, summed over
each GQA group).  bf16 inputs run ``wgmma_bwd_dq_kernel`` and
``wgmma_bwd_dkdv_kernel``, every product a bf16 ``wgmma`` with f32
accumulation (P and dS rounded to bf16 before the products that take
them); f32 inputs ``tf32x3_bwd_dq_kernel`` and ``tf32x3_bwd_dkdv_kernel``,
every product a 3xTF32 ``wgmma`` (dQ, dK and dV formed transposed, fresh
accumulators per KV or q tile added in f32).  On the CPU
``flash_attention_bwd_plain``.
``flash_attention_bwd.launches`` counts both kernels' launches, and
``flash_attention_bwd.by_shape`` the same by ``launch_key``.
The backward is the op ``repro_torch::flash_attention_bwd``
(``flash_attention_bwd_op``), which the forward op's Autograd kernel
(``_FlashAttention``) calls: K5 under autograd is the forward op, with
the lse, and these two kernels.  Both ops carry a FLOP formula
(``flops_fwd``, ``flops_bwd``) for ``FlopCounterMode``.  On a mesh the op
sees each rank's local tensors: ``nn/attention.py::per_shard`` places
attention's inputs for every tier.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: per-block shared memory limit (opt-in) of the H100
_H100_SMEM_OPTIN = 232448


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: Optional[torch.Tensor] = None, *,
                          causal: bool = True, window: int = 0,
                          softcap: float = 0.0, q_chunk: int = 512,
                          kv_chunk: int = 1024, return_lse: bool = False):
    """The plain PyTorch version: the same online softmax over KV blocks
    of ``kv_chunk`` keys, one chunk of ``q_chunk`` queries at a time, so
    that gemma2's S = 6144 at D = 256 never holds an (S, S) score matrix.
    GQA goes through a (B, Hkv, G, ...) view; nothing is repeated.  Without
    ``kv_len`` every batch has Sk valid keys, and KV blocks that are
    entirely masked for a query chunk are skipped.  ``return_lse=True``
    returns ``(out, lse)`` with lse (B, Hq, Sq) f32 = ``m + log(l_safe)``
    as ``repro/nn/flash_vjp.py::_fwd_scan`` forms it (about -1e30 for an
    all-masked row)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    bounded = kv_len is None
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=dev)
    kvl = kv_len.to(dev).long().view(b, 1, 1, 1, 1)
    qs = (q * d ** -0.5).reshape(b, hkv, g, sq, d)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, q_chunk):
        q1 = min(sq, q0 + q_chunk)
        qc = qs[:, :, :, q0:q1].float()
        qpos = kvl - sq + torch.arange(q0, q1, device=dev).view(
            1, 1, 1, -1, 1)
        shape = (b, hkv, g, q1 - q0, 1)
        m_run = torch.full(shape, NEG_INF, device=dev)
        l_run = torch.zeros(shape, device=dev)
        acc = torch.zeros(shape[:-1] + (d,), device=dev)
        for k0 in range(0, sk, kv_chunk):
            k1 = min(sk, k0 + kv_chunk)
            if bounded and ((causal and k0 > sk - sq + q1 - 1) or (
                    window > 0 and k1 - 1 <= sk - sq + q0 - window)):
                continue
            kpos = torch.arange(k0, k1, device=dev).view(1, 1, 1, 1, -1)
            mask = kpos < kvl
            if causal:
                mask = mask & (kpos <= qpos)
            if window > 0:
                mask = mask & (kpos > qpos - window)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, k[:, :, k0:k1].float())
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.exp(torch.where(mask, s - m_safe, NEG_INF))
            alpha = torch.exp(torch.where(m_run <= NEG_INF / 2, NEG_INF,
                                          m_run - m_safe))
            l_run = l_run * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                             v[:, :, k0:k1].float())
            m_run = m_new
        l_safe = torch.where(l_run == 0.0, 1.0, l_run)
        o = acc / l_safe
        out[:, :, q0:q1] = o.reshape(b, hq, q1 - q0, d).to(q.dtype)
        lse[:, :, q0:q1] = (m_run + torch.log(l_safe)).reshape(b, hq, q1 - q0)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              kv_len: Optional[torch.Tensor] = None, *,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0, q_chunk: int = 512,
                              kv_chunk: int = 1024):
    """The backward's plain version: (dq, dk, dv) of K5's function for the
    output gradient ``dout``, given the forward's ``out`` and ``lse``.

    Per (query chunk, KV chunk) tile, in f32 (``repro/nn/flash_vjp.py``'s
    math; q scaled by ``D^-0.5`` in q's dtype as the forward forms it):
    ``Z = qs K^T``, ``S = cap tanh(Z / cap)``, ``P = exp(S - lse)`` where
    unmasked, ``dP = dO V^T``, ``dS = P (dP - D)`` with ``D = rowsum(dO
    O)``, ``dZ = dS (1 - (S / cap)^2)``; ``dq = scale dZ K``, ``dk = dZ^T
    qs``, ``dv = P^T dO``, the latter two summed over each GQA group.
    Masks, right alignment and the skipped tiles are the forward's.  An
    all-masked row (lse about -1e30) gets zero gradients.  Returns the
    three in the inputs' dtypes.  f64 inputs are computed in f64 (the
    card's checks of the f32 kernels hold them against this f64
    evaluation: the f32 one is itself up to ~1e-4 a row off it at
    chip_smoke.py's shapes)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    wide = torch.promote_types(q.dtype, torch.float32)
    scale = d ** -0.5
    bounded = kv_len is None
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=dev)
    kvl = kv_len.to(dev).long().view(b, 1, 1, 1, 1)
    qs = (q * scale).reshape(b, hkv, g, sq, d)
    dog = dout.reshape(b, hkv, g, sq, d)
    lseg = lse.to(wide).reshape(b, hkv, g, sq, 1)
    delta = (dout.to(wide) * out.to(wide)).sum(-1).reshape(b, hkv, g, sq, 1)
    dq = torch.empty((b, hkv, g, sq, d), dtype=wide, device=dev)
    dk = torch.zeros((b, hkv, sk, d), dtype=wide, device=dev)
    dv = torch.zeros((b, hkv, sk, d), dtype=wide, device=dev)
    for q0 in range(0, sq, q_chunk):
        q1 = min(sq, q0 + q_chunk)
        qc = qs[:, :, :, q0:q1].to(wide)
        doc = dog[:, :, :, q0:q1].to(wide)
        lc, dc = lseg[:, :, :, q0:q1], delta[:, :, :, q0:q1]
        qpos = kvl - sq + torch.arange(q0, q1, device=dev).view(
            1, 1, 1, -1, 1)
        dqc = torch.zeros((b, hkv, g, q1 - q0, d), dtype=wide, device=dev)
        for k0 in range(0, sk, kv_chunk):
            k1 = min(sk, k0 + kv_chunk)
            if bounded and ((causal and k0 > sk - sq + q1 - 1) or (
                    window > 0 and k1 - 1 <= sk - sq + q0 - window)):
                continue
            kpos = torch.arange(k0, k1, device=dev).view(1, 1, 1, 1, -1)
            mask = kpos < kvl
            if causal:
                mask = mask & (kpos <= qpos)
            if window > 0:
                mask = mask & (kpos > qpos - window)
            kc, vc = k[:, :, k0:k1].to(wide), v[:, :, k0:k1].to(wide)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc)
            if softcap > 0:
                th = torch.tanh(s / softcap)
                s = softcap * th
            p = torch.where(mask, torch.exp(torch.where(mask, s - lc, 0.0)),
                            0.0)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vc)
            ds = p * (dp - dc)
            if softcap > 0:
                ds = ds * (1.0 - th * th)
            dqc += torch.einsum("bhgqk,bhkd->bhgqd", ds, kc)
            dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc)
            dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
        dq[:, :, :, q0:q1] = dqc * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def tiles(d: int, dtype: torch.dtype, group: int = 1) -> tuple[int, int, int]:
    """(query rows, keys, heads) of one CTA's tiles at head dim ``d`` and
    GQA group ``group`` = Hq / Hkv (mirrors ``csrc/flash_attention.cu``:
    tf::kRows/kTileK for f32, one head a CTA; wg::Cfg for bf16, which puts
    the two heads of a pair in one CTA at d = 256 when the group is even and
    otherwise halves the KV tile for one head at d = 256, so that two such
    CTAs share an SM)."""
    if dtype == torch.bfloat16:
        heads = 2 if d == 256 and group % 2 == 0 else 1
        return 64, 32 if d == 256 and heads == 1 else 64, heads
    return 64, 32, 1


def smem_bytes(d: int, dtype: torch.dtype, group: int = 1) -> int:
    """Dynamic shared memory one launch takes at head dim ``d`` (mirrors
    ``tf::Cfg::kSmem`` and ``wg::Cfg::kSmem`` in the kernel source), with
    1 KB to align the base to the 1024-byte swizzle atom.  f32: TF32 hi and
    lo images of the q tile (rows of d rounded up to 32 columns), one
    buffer of hi and lo images that holds the K tile, then the transposed V
    tile, and the raw f32 tile that cp.async brings in meanwhile.  bf16: a
    q tile per head and two stages of K and V tiles."""
    tq, tk, heads = tiles(d, dtype, group)
    if dtype == torch.bfloat16:
        return (heads * tq * d + 4 * tk * d) * 2 + 1024
    dp = -(-d // 32) * 32
    return 1024 + (2 * tq * dp + 2 * max(tk * dp, d * tk) + tk * d) * 4


def bwd_tiles(d: int, dtype: torch.dtype, group: int = 1) -> dict:
    """The backward kernels' tiles at head dim ``d`` and GQA group ``group``
    (mirrors ``csrc/flash_attention.cu``): ``dq`` is (query rows, keys of a
    KV tile, query heads a CTA), ``dkdv`` (keys a CTA, query rows of a q
    tile, warpgroups a CTA).  bf16 (``wgb::DqCfg``, ``wgb::KvCfg``): 64
    query rows a warpgroup; 32-key tiles at d = 256, where two heads of an
    even group share a CTA, else 64; 64 keys a CTA and 64-row q tiles, D
    split between two warpgroups at d = 256.  f32 (``tfb::DqCfg``,
    ``tfb::KvCfg``): one head a CTA of two warpgroups, one product each;
    64 query rows with KV tiles of 16 keys at d = 256, else 32; 64 keys
    with q tiles of 16 rows at d = 256, 32 at d = 128, else 64."""
    if dtype == torch.bfloat16:
        heads = 2 if d == 256 and group % 2 == 0 else 1
        return {"dq": (64, 32 if d == 256 else 64, heads),
                "dkdv": (64, 64, 2 if d == 256 else 1)}
    return {"dq": (64, 16 if d == 256 else 32, 1),
            "dkdv": (64, {256: 16, 128: 32}.get(d, 64), 2)}


def bwd_smem_bytes(d: int, dtype: torch.dtype, group: int = 1) -> dict:
    """Dynamic shared memory of the backward kernels at head dim ``d``
    (mirrors ``wgb::DqCfg::kSmem``, ``wgb::KvCfg::kSmem``,
    ``tfb::DqCfg::kSmem`` and ``tfb::KvCfg::kSmem``), with 1 KB to align
    the base to the 1024-byte swizzle atom.  bf16: ``dq`` holds each head's
    qs and dO tiles (64 x d), two stages of K and V tiles and each row's
    delta; ``dkdv`` the CTA's K and V tiles, two stages of qs and dO tiles
    and of their rows' lse and delta.  f32: ``dq`` holds qs and dO raw (64
    x d each, the A operands of S and dP, split in registers), the KV
    tile's K and V as TF32 hi and lo images (keys x d, rows of d rounded up
    to 32 columns, the 128-byte swizzle row), the dS tile's hi and lo
    images (64 x keys, at least 32 columns) and each row's lse and delta;
    ``dkdv`` K and V raw (64 x d each), the q tile's qs and dO hi and lo
    images (q rows x d), P^T's and dS^T's hi and lo images (64 x q rows, at
    least 32 columns) and the tile rows' lse and delta."""
    t = bwd_tiles(d, dtype, group)
    if dtype == torch.bfloat16:
        rows, keys, heads = t["dq"]
        kv, tq, _ = t["dkdv"]
        return {"dq": 1024 + (2 * heads * rows * d + 4 * keys * d) * 2
                + heads * rows * 4,
                "dkdv": 1024 + (2 * kv * d + 4 * tq * d) * 2 + 4 * tq * 4}

    def padded(n):
        return -(-n // 32) * 32
    rows, keys, _ = t["dq"]
    kv, tq, _ = t["dkdv"]
    return {"dq": 1024 + 4 * (2 * rows * d + 4 * keys * padded(d)
                              + 2 * rows * padded(keys) + 2 * rows),
            "dkdv": 1024 + 4 * (2 * kv * d + 4 * tq * padded(d)
                                + 4 * kv * padded(tq) + 2 * tq)}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, return_lse: bool = False):
    """Flash attention through K5's opaque op ``repro_torch::flash_attention``
    (``flash_attention_op``): a CUDA kernel for CUDA tensors, the plain
    version for tensors on the CPU.  By dtype: bf16 launches
    ``wgmma_kernel``, f32 ``tf32x3_kernel``; both count in
    ``flash_attention.launches`` and ``flash_attention.by_shape``.

    q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D), all f32 or all bf16,
    contiguous and 16-byte aligned, Hq a multiple of Hkv, D in
    ``HEAD_DIMS``; kv_len: optional
    (B,) int32 valid keys per batch, in [0, Sk] (default Sk).  Returns
    (B, Hq, Sq, D) in q's dtype, and with ``return_lse=True`` also each
    row's logsumexp, (B, Hq, Sq) f32.  Launches on the current stream and
    does not synchronize.  Differentiable: the op's backward is
    ``flash_attention_bwd_op`` (K5's two backward kernels on a card); a
    call that needs a gradient stores the lse for it.
    """
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    out, lse = flash_attention_op(q, k, v, kv_len, bool(causal), int(window),
                                  float(softcap), bool(return_lse or grad))
    return (out, lse) if return_lse else out


def launch_key(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
               softcap: float) -> tuple:
    """A launch's key in the ``by_shape`` counters: (dtype name, B, Hq,
    Hkv, Sq, Sk, D, causal, window, softcap)."""
    b, hq, sq, d = q.shape
    return (str(q.dtype).removeprefix("torch."), b, hq, k.shape[1], sq,
            k.shape[2], d, bool(causal), int(window), float(softcap))


def _check(q, k, v, kv_len, name: str):
    """The checks both directions share; returns kv_len (default Sk)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k must be 4-D (B, H, S, D); got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q is {q.dtype}, expected torch.float32 "
                        f"or torch.bfloat16")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS or hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: head dim {d} must be one of {HEAD_DIMS} "
                         f"and Hq={hq} a multiple of Hkv={hkv}")
    if not (b > 0 and hq > 0 and sq > 0 and sk > 0):
        raise ValueError(f"{name}: empty launch (q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)})")
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    return kv_len


def _smem_limit(device) -> int:
    return getattr(torch.cuda.get_device_properties(device),
                   "shared_memory_per_block_optin", _H100_SMEM_OPTIN)


def _launch(q, k, v, kv_len=None, *, causal: bool = True, window: int = 0,
            softcap: float = 0.0, terms: int = 3, return_lse: bool = False):
    """Check the arguments and launch the kernel; not counted in
    ``flash_attention.launches``.  ``flash_attention`` passes ``terms=3``;
    ``terms=1`` (f32 only: one TF32 product instead of three, a control
    that must fail the f32 checks) is for ``chip_smoke.py`` and the card
    tests and is never called on a path."""
    if terms != 3 and (terms != 1 or q.dtype != torch.float32):
        raise ValueError(f"flash_attention: terms must be 3, or 1 for f32; "
                         f"got {terms} for {q.dtype}")
    kv_len = _check(q, k, v, kv_len, "flash_attention")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _build.check_args("flash_attention", q.device, {
        "q": (q, q.dtype, (b, hq, sq, d)),
        "k": (k, q.dtype, (b, hkv, sk, d)),
        "v": (v, q.dtype, (b, hkv, sk, d)),
        "kv_len": (kv_len, torch.int32, (b,))})
    limit = _smem_limit(q.device)
    need = smem_bytes(d, q.dtype, hq // hkv)
    if need > limit:
        raise ValueError(f"flash_attention: head dim {d} needs {need} bytes "
                         f"of shared memory per block; this card allows "
                         f"{limit}")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned (the kernels load 16 bytes at a time)")
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
        [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), None if lse is None else lse.data_ptr(), b,
                 hq, hkv, sq, sk, d, int(causal), int(window), float(softcap),
                 d ** -0.5, int(q.dtype == torch.bfloat16), terms,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA"
                           f" error {err}")
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.by_shape = Counter()

_NO_LSE = (0,)

#: K5's two opaque ops on a fragment of the ``repro_torch`` namespace (K1's
#: and K2's ``custom_op``s share it), each kernel registered by dispatch
#: key: ``torch.library.custom_op``'s Python wrappers (its argument and
#: aliasing checks, its autograd adapter) cost a K5 call more host time
#: than the kernel's own launch.  ``flash_attention`` returns ``(out,
#: lse)``; without ``return_lse`` the kernel stores no lse and the second
#: output is empty.  ``flash_attention_bwd`` returns ``(dq, dk, dv)``.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, Tensor? kv_len, "
            "bool causal, int window, float softcap, bool return_lse) -> "
            "(Tensor, Tensor)")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
            "Tensor lse, Tensor dout, Tensor? kv_len, bool causal, "
            "int window, float softcap) -> (Tensor, Tensor, Tensor)")
flash_attention_op = torch.ops.repro_torch.flash_attention.default
flash_attention_bwd_op = torch.ops.repro_torch.flash_attention_bwd.default


def _fwd_cuda(q, k, v, kv_len, causal, window, softcap, return_lse):
    """The forward op's CUDA kernel: one ``_launch`` (which makes the
    data-dependent checks: alignment, the card's shared memory), counted
    in ``flash_attention.launches`` and ``flash_attention.by_shape``."""
    out = _launch(q, k, v, kv_len, causal=causal, window=window,
                  softcap=softcap, return_lse=return_lse)
    flash_attention.launches += 1
    flash_attention.by_shape[launch_key(q, k, causal, window, softcap)] += 1
    if return_lse:
        return out
    return out, q.new_empty(_NO_LSE, dtype=torch.float32)


def _fwd_cpu(q, k, v, kv_len, causal, window, softcap, return_lse):
    """The forward op's CPU kernel: ``flash_attention_plain``."""
    out, lse = flash_attention_plain(q, k, v, kv_len, causal=causal,
                                     window=window, softcap=softcap,
                                     return_lse=True)
    if not return_lse:
        lse = q.new_empty(_NO_LSE, dtype=torch.float32)
    return out, lse


def _check_static(q, k, v, kv_len, name: str) -> None:
    """What ``_check`` and ``_build.check_args`` check that needs no data
    (ranks, dtypes, the group, the head dim, shapes)."""
    _check(q, k, v, kv_len, name)
    b, _, _, d = q.shape
    kv_shape = (b, k.shape[1], k.shape[2], d)
    for arg, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or tuple(t.shape) != kv_shape:
            raise ValueError(f"{name}: {arg} is {t.dtype} {tuple(t.shape)}; "
                             f"expected {q.dtype} {kv_shape}")
    if kv_len is not None and (kv_len.dtype != torch.int32
                               or tuple(kv_len.shape) != (b,)):
        raise ValueError(f"{name}: kv_len is {kv_len.dtype} "
                         f"{tuple(kv_len.shape)}; expected torch.int32 "
                         f"({b},)")


def _check_smem(name: str, need: int, d: int) -> None:
    if need > _H100_SMEM_OPTIN:
        raise ValueError(f"{name}: head dim {d} needs {need} bytes of shared "
                         f"memory per block; the H100 allows "
                         f"{_H100_SMEM_OPTIN}")


def _fwd_fake(q, k, v, kv_len, causal, window, softcap, return_lse):
    """The forward op's fake (and meta) kernel: the checks that need no
    data and the outputs' shapes; it launches nothing."""
    _check_static(q, k, v, kv_len, "flash_attention")
    b, hq, sq, d = q.shape
    _check_smem("flash_attention", smem_bytes(d, q.dtype, hq // k.shape[1]),
                d)
    lse = q.new_empty((b, hq, sq) if return_lse else _NO_LSE,
                      dtype=torch.float32)
    return torch.empty_like(q), lse


class _FlashAttention(torch.autograd.Function):
    """The forward op's autograd: the op below autograd with the lse
    (one K5 launch on a card), saving q, k, v, out and lse; the backward
    is ``flash_attention_bwd_op``.  The lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, window, softcap):
        with torch._C._AutoDispatchBelowAutograd():
            out, lse = flash_attention_op(q, k, v, kv_len, causal, window,
                                          softcap, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kv_len = kv_len
        ctx.opts = (causal, window, softcap)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_op(q, k, v, out, lse,
                                            dout.contiguous(), ctx.kv_len,
                                            *ctx.opts)
        return dq, dk, dv, None, None, None, None


def _fwd_autograd(q, k, v, kv_len, causal, window, softcap, return_lse):
    """The forward op's Autograd kernel: ``_FlashAttention`` when a
    gradient is wanted, else the op below autograd."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if not return_lse:
            raise RuntimeError("flash_attention: a gradient needs the "
                               "forward's lse (return_lse=True)")
        return _FlashAttention.apply(q, k, v, kv_len, causal, window,
                                     softcap)
    with torch._C._AutoDispatchBelowAutograd():
        return flash_attention_op(q, k, v, kv_len, causal, window, softcap,
                                  return_lse)


_LIB.impl("flash_attention", _fwd_cuda, "CUDA")
_LIB.impl("flash_attention", _fwd_cpu, "CPU")
_LIB.impl("flash_attention", _fwd_autograd, "Autograd")
torch.library.register_fake("repro_torch::flash_attention", _fwd_fake,
                            lib=_LIB)


def flops_fwd(q_shape, k_shape) -> int:
    """K5's forward FLOPs: two products of (Sq, Sk) by D a (batch, head),
    ``4 B Hq Sq Sk D``, every masked tile counted (the reference's
    ``flash_vjp`` scans mask and do not skip)."""
    b, hq, sq, d = q_shape
    return 4 * b * hq * sq * k_shape[2] * d


def flops_bwd(q_shape, k_shape) -> int:
    """K5's backward FLOPs as its two kernels run them: the dq pass forms
    S = qs K^T and dP = dO V^T, then dQ = dS K (three products); the dk/dv
    pass forms S and dP again, then dV = P^T dO and dK = dS^T qs (four).
    Seven products of (Sq, Sk) by D a (batch, head): ``14 B Hq Sq Sk D``
    (a single pass would do five, ``10 B Hq Sq Sk D``), masked tiles
    counted."""
    b, hq, sq, d = q_shape
    return 14 * b * hq * sq * k_shape[2] * d


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, terms: int = 3):
    """K5's backward: (dq, dk, dv) for the output gradient ``dout``, given
    the forward's ``out`` and ``lse`` (``flash_attention(...,
    return_lse=True)``).  The plain version for tensors on the CPU; on
    CUDA tensors the dq pass then the dk/dv pass, both on the tensor cores
    -- bf16 ``wgmma_bwd_dq_kernel`` and ``wgmma_bwd_dkdv_kernel``, f32
    ``tf32x3_bwd_dq_kernel`` and ``tf32x3_bwd_dkdv_kernel`` -- each
    counted in ``flash_attention_bwd.launches`` (two a call) and in
    ``flash_attention_bwd.by_shape``.  q, k, v,
    out and dout share one dtype (f32 or bf16) and K5's shapes, contiguous
    and 16-byte aligned; lse is (B, Hq, Sq) f32.  Returns the gradients in
    that dtype.  ``terms=3`` (3xTF32) is the f32 kernels' arithmetic;
    ``terms=1`` (CUDA f32 only: one TF32 product instead of three, a
    control that must fail the f32 checks) is for ``chip_smoke.py`` and
    the card tests and is never called on a path.  ``terms=3`` goes
    through the opaque op ``repro_torch::flash_attention_bwd``
    (``flash_attention_bwd_op``), ``terms=1`` launches directly."""
    if terms != 3 and (terms != 1 or q.dtype != torch.float32
                       or q.device.type == "cpu"):
        raise ValueError(f"flash_attention_bwd: terms must be 3, or 1 for "
                         f"f32 CUDA tensors; got {terms} for {q.dtype} on "
                         f"{q.device}")
    if terms == 3:
        return flash_attention_bwd_op(q, k, v, out, lse, dout, kv_len,
                                      bool(causal), int(window),
                                      float(softcap))
    return _launch_bwd(q, k, v, out, lse, dout, kv_len, causal=causal,
                       window=window, softcap=softcap, terms=terms)


def _launch_bwd(q, k, v, out, lse, dout, kv_len=None, *, causal: bool,
                window: int, softcap: float, terms: int = 3):
    """Check the arguments and launch the dq pass then the dk/dv pass,
    each counted in ``flash_attention_bwd.launches`` and ``.by_shape``."""
    kv_len = _check(q, k, v, kv_len, "flash_attention_bwd")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _build.check_args("flash_attention_bwd", q.device, {
        "q": (q, q.dtype, (b, hq, sq, d)),
        "k": (k, q.dtype, (b, hkv, sk, d)),
        "v": (v, q.dtype, (b, hkv, sk, d)),
        "out": (out, q.dtype, (b, hq, sq, d)),
        "lse": (lse, torch.float32, (b, hq, sq)),
        "dout": (dout, q.dtype, (b, hq, sq, d)),
        "kv_len": (kv_len, torch.int32, (b,))})
    limit = _smem_limit(q.device)
    need = max(bwd_smem_bytes(d, q.dtype, hq // hkv).values())
    if need > limit:
        raise ValueError(f"flash_attention_bwd: head dim {d} needs {need} "
                         f"bytes of shared memory per block; this card "
                         f"allows {limit}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout, dq, dk, dv)):
        raise ValueError("flash_attention_bwd: q, k, v, out and dout must be "
                         "16-byte aligned (the kernels load 16 bytes at a "
                         "time)")
    # bf16: the dq pass also stores q * D^-0.5 rounded to bf16 for the dk/dv
    # pass, which reads it instead of scaling q again
    bf16 = q.dtype == torch.bfloat16
    qs = torch.empty_like(q) if bf16 else None
    dq_fn = _build.load("flash_attention").flash_attention_bwd_dq
    dkdv_fn = _build.load("flash_attention").flash_attention_bwd_dkdv
    ptrs = [t.data_ptr() if t is not None else None
            for t in (q, k, v, out, lse, dout, kv_len, delta, qs, dq, dk, dv)]
    key = launch_key(q, k, causal, window, softcap)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for fn in (dq_fn, dkdv_fn):   # dkdv reads what the dq pass wrote
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + \
                [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(*ptrs, b, hq, hkv, sq, sk, d, int(causal), int(window),
                     float(softcap), d ** -0.5, int(bf16), terms, stream)
            if err:
                raise RuntimeError(f"flash_attention_bwd: kernel launch "
                                   f"failed with CUDA error {err}")
            flash_attention_bwd.launches += 1
            flash_attention_bwd.by_shape[key] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.by_shape = Counter()


def _bwd_cuda(q, k, v, out, lse, dout, kv_len, causal, window, softcap):
    """The backward op's CUDA kernel: the two backward kernels
    (``_launch_bwd``; 3xTF32 in f32)."""
    return _launch_bwd(q, k, v, out, lse, dout, kv_len, causal=causal,
                       window=window, softcap=softcap)


def _bwd_cpu(q, k, v, out, lse, dout, kv_len, causal, window, softcap):
    """The backward op's CPU kernel: ``flash_attention_bwd_plain``."""
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, kv_len,
                                     causal=causal, window=window,
                                     softcap=softcap)


def _bwd_fake(q, k, v, out, lse, dout, kv_len, causal, window, softcap):
    """The backward op's fake (and meta) kernel: the shapes alone."""
    _check_static(q, k, v, kv_len, "flash_attention_bwd")
    d = q.shape[-1]
    _check_smem("flash_attention_bwd", max(bwd_smem_bytes(
        d, q.dtype, q.shape[1] // k.shape[1]).values()), d)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_LIB.impl("flash_attention_bwd", _bwd_cuda, "CUDA")
_LIB.impl("flash_attention_bwd", _bwd_cpu, "CPU")
torch.library.register_fake("repro_torch::flash_attention_bwd", _bwd_fake,
                            lib=_LIB)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _fwd(q_shape, k_shape, *args, **kwargs) -> int:
        return flops_fwd(q_shape, k_shape)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
    def _bwd(q_shape, k_shape, *args, **kwargs) -> int:
        return flops_bwd(q_shape, k_shape)


_register_flop_formulas()
