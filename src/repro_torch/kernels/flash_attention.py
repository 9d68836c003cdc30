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

``flash_attention`` is the wrapper: tensors on the CPU take
``flash_attention_plain``, CUDA tensors launch the kernel or raise.
``flash_attention.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
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
                          kv_chunk: int = 1024) -> torch.Tensor:
    """The plain PyTorch version: the same online softmax over KV blocks
    of ``kv_chunk`` keys, one chunk of ``q_chunk`` queries at a time, so
    that gemma2's S = 6144 at D = 256 never holds an (S, S) score matrix.
    GQA goes through a (B, Hkv, G, ...) view; nothing is repeated.  Without
    ``kv_len`` every batch has Sk valid keys, and KV blocks that are
    entirely masked for a query chunk are skipped."""
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
        o = acc / torch.where(l_run == 0.0, 1.0, l_run)
        out[:, :, q0:q1] = o.reshape(b, hq, q1 - q0, d).to(q.dtype)
    return out


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Flash attention: a CUDA kernel for CUDA tensors, the plain version
    for tensors on the CPU.  By dtype: bf16 launches ``wgmma_kernel``, f32
    ``tf32x3_kernel``; both count in ``flash_attention.launches``.

    q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D), all f32 or all bf16,
    contiguous and 16-byte aligned, Hq a multiple of Hkv, D in
    ``HEAD_DIMS``; kv_len: optional
    (B,) int32 valid keys per batch, in [0, Sk] (default Sk).  Returns
    (B, Hq, Sq, D) in q's dtype.  Launches on the current stream and does
    not synchronize.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, causal=causal,
                                     window=window, softcap=softcap)
    out = _launch(q, k, v, kv_len, causal=causal, window=window,
                  softcap=softcap)
    flash_attention.launches += 1
    return out


def _launch(q, k, v, kv_len=None, *, causal: bool = True, window: int = 0,
            softcap: float = 0.0, terms: int = 3) -> torch.Tensor:
    """Check the arguments and launch the kernel; not counted in
    ``flash_attention.launches``.  ``flash_attention`` passes ``terms=3``;
    ``terms=1`` (f32 only: one TF32 product instead of three, a control
    that must fail the f32 checks) is for ``chip_smoke.py`` and the card
    tests and is never called on a path."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-D (B, H, S, "
                         f"D); got {tuple(q.shape)} and {tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q is {q.dtype}, expected "
                        f"torch.float32 or torch.bfloat16")
    if terms != 3 and (terms != 1 or q.dtype != torch.float32):
        raise ValueError(f"flash_attention: terms must be 3, or 1 for f32; "
                         f"got {terms} for {q.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    _build.check_args("flash_attention", q.device, {
        "q": (q, q.dtype, (b, hq, sq, d)),
        "k": (k, q.dtype, (b, hkv, sk, d)),
        "v": (v, q.dtype, (b, hkv, sk, d)),
        "kv_len": (kv_len, torch.int32, (b,))})
    if d not in HEAD_DIMS or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: head dim {d} must be one of "
                         f"{HEAD_DIMS} and Hq={hq} a multiple of Hkv={hkv}")
    if not (b > 0 and hq > 0 and sq > 0 and sk > 0):
        raise ValueError(f"flash_attention: empty launch (q {tuple(q.shape)},"
                         f" k {tuple(k.shape)})")
    limit = getattr(torch.cuda.get_device_properties(q.device),
                    "shared_memory_per_block_optin", _H100_SMEM_OPTIN)
    need = smem_bytes(d, q.dtype, hq // hkv)
    if need > limit:
        raise ValueError(f"flash_attention: head dim {d} needs {need} bytes "
                         f"of shared memory per block; this card allows "
                         f"{limit}")
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned (the kernels load 16 bytes at a time)")
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
        [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), b, hq, hkv, sq, sk, d, int(causal),
                 int(window), float(softcap), d ** -0.5,
                 int(q.dtype == torch.bfloat16), terms,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA"
                           f" error {err}")
    return out


flash_attention.launches = 0
