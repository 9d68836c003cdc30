#!/usr/bin/env python3
"""Time K5's backward passes against design variants on one card.

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it is ("kept") and
variants derived from it by textual patches, one nvcc process each, into
``build/variants/``; loads each library with ctypes; runs both backward
passes (``flash_attention_bwd_dq``, then ``flash_attention_bwd_dkdv``) on
the same inputs; holds each variant's gradients against
``flash_attention_bwd_plain`` (in f64 for f32 inputs) within chip_smoke.py's
limits for the dtype;
and times each pass with CUDA events at chip_smoke.py's FLASH_BWD_SHAPES
(a), (b) and (d).  bf16 variants (the default):

  exchange -- at D = 256 the dk/dv pass's two warpgroups form one product
              each over all of D (warpgroup 0 S^T, warpgroup 1 dP^T) and
              exchange them through 32 KB of shared memory, in place of
              each forming both.
  roles    -- at D = 256 the dk/dv pass's warpgroups take one accumulator
              each over all of D: warpgroup 0 forms S^T, P and dV,
              warpgroup 1 S^T, dP^T, dS and dK (five products' worth
              against six, unevenly split).

f32 variants (``--f32``), of the 3xTF32 kernels (tfb::):

  sk1      -- S and dP take a fresh accumulator per k8 step of D instead
              of per four (per two in the dk/dv pass at D = 256): more
              commit groups and f64 adds.
  f64sum   -- S's and dP's partials added in f64 instead of f32 and
              rounded once (a conversion and a double add a partial).
  parent   -- with ``--parent FILE``: another revision's flash_attention.cu
              (e.g. the FMA kernels that the 3xTF32 ones replaced), built
              and called through the C interface without ``terms``.

Run from the repository root on a machine with a card and nvcc:

    python3 scripts/flash_bwd_variants.py [--f32 [--parent FILE]] [shape,...]

Prints the card's name and power limit, then one line per shape.  Exits
non-zero if a variant fails to build or to meet the limits.
"""

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as k5  # noqa: E402

SRC = (_build.CSRC / "flash_attention.cu").read_text()


def _rep(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise SystemExit(f"patch does not apply: {old[:60]!r}")
    return s.replace(old, new)


def exchange(s: str) -> str:
    """The dk/dv pass at D = 256 with S^T and dP^T exchanged."""
    s = _rep(s, """  static constexpr int kSmem = 1024 + 2 * kKvBytes + 4 * kQBytes +
                               4 * kTileQ * 4;""", """  static constexpr int kSmem = 1024 + 2 * kKvBytes + 4 * kQBytes +
                               4 * kTileQ * 4 +
                               (kWgs == 2 ? 2 * kRows * kTileQ * 4 : 0);""")
    return _rep(s, """    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<TQ>(s, desc_k<D>(s_k, kRows, ks), desc_k<D>(s_q(st), TQ, ks),
                   ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<TQ>(dp, desc_k<D>(s_v, kRows, ks), desc_k<D>(s_do(st), TQ, ks),
                   ks > 0);
    wgmma_commit();
    tf::wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < TQ / 2; ++i) fence_reg(s[i]);
""", """    if constexpr (C::kWgs == 2) {
      wgmma_fence();
      if (wgi == 0) {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<TQ>(s, desc_k<D>(s_k, kRows, ks),
                       desc_k<D>(s_q(st), TQ, ks), ks > 0);
      } else {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<TQ>(dp, desc_k<D>(s_v, kRows, ks),
                       desc_k<D>(s_do(st), TQ, ks), ks > 0);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < TQ / 2; ++i) fence_reg(s[i]), fence_reg(dp[i]);
      float4* xch = reinterpret_cast<float4*>(
          base + 2 * C::kKvBytes + 4 * C::kQBytes + 4 * TQ * 4);
      const int t = tid % 128;
      float4* mine = xch + wgi * (TQ / 8) * 128;
      const float4* other = xch + (1 - wgi) * (TQ / 8) * 128;
      if (wgi == 0) {
#pragma unroll
        for (int j = 0; j < TQ / 8; ++j)
          mine[j * 128 + t] =
              make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < TQ / 8; ++j)
          mine[j * 128 + t] = make_float4(dp[4 * j], dp[4 * j + 1],
                                          dp[4 * j + 2], dp[4 * j + 3]);
      }
      __syncthreads();
      if (wgi == 0) {
#pragma unroll
        for (int j = 0; j < TQ / 8; ++j) {
          const float4 f = other[j * 128 + t];
          dp[4 * j] = f.x, dp[4 * j + 1] = f.y, dp[4 * j + 2] = f.z,
                  dp[4 * j + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TQ / 8; ++j) {
          const float4 f = other[j * 128 + t];
          s[4 * j] = f.x, s[4 * j + 1] = f.y, s[4 * j + 2] = f.z,
                 s[4 * j + 3] = f.w;
        }
      }
    } else {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<TQ>(s, desc_k<D>(s_k, kRows, ks), desc_k<D>(s_q(st), TQ, ks),
                     ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<TQ>(dp, desc_k<D>(s_v, kRows, ks),
                     desc_k<D>(s_do(st), TQ, ks), ks > 0);
      wgmma_commit();
      tf::wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < TQ / 2; ++i) fence_reg(s[i]);
    }
""")


def roles(s: str) -> str:
    """The dk/dv pass at D = 256 with one role a warpgroup over all of D:
    warpgroup 0 forms S^T, P and dV; warpgroup 1 S^T, dP^T, dS and dK."""
    i = s.index("  float acc_k[C::kDw / 2], acc_v[C::kDw / 2];")
    j = s.index("template <int D, int WGS>\nint launch_dq(")
    body = s[i:j]
    k = body.rindex("}\n")
    return s[:i] + ROLES + "  } else {\n" + body[:k] + "  }\n}\n\n" + s[j:]


ROLES = """  if constexpr (C::kWgs == 2) {
  // two warpgroups, one role each over all of D: warpgroup 0 forms S^T,
  // P and dV; warpgroup 1 forms S^T, dP^T, dS and dK
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  if (nitems > 0) load_q(0, 0);
  for (int it = 0; it < nitems; ++it) {
    const int st = it & 1;
    const int qq0 = (t_lo + it % ntq) * TQ;
    const int q_lo = len - sq + qq0;
    if (it + 1 < nitems) {
      load_q(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    float s[TQ / 2], dp[TQ / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<TQ>(s, desc_k<D>(s_k, kRows, ks), desc_k<D>(s_q(st), TQ, ks),
                   ks > 0);
    wgmma_commit();
    if (wgi == 1) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<TQ>(dp, desc_k<D>(s_v, kRows, ks),
                     desc_k<D>(s_do(st), TQ, ks), ks > 0);
      wgmma_commit();
      tf::wgmma_wait<1>();
    } else {
      wgmma_wait0();
    }
#pragma unroll
    for (int i = 0; i < TQ / 2; ++i) fence_reg(s[i]);
    const bool whole = k0 + kRows <= k_valid && qq0 + TQ <= sq &&
                       (!causal || k0 + kRows - 1 <= q_lo) &&
                       (window <= 0 || k0 > q_lo + TQ - 1 - window);
    const float* ls = ls_rows + st * TQ;
    const float* dl = dl_rows + st * TQ;
    uint32_t pf[TQ / 4];
#pragma unroll
    for (int x = 0; x < TQ / 4; ++x) {
      const int half = x & 1;
      const int kpos = k0 + row0 + 8 * half;
      const int i0 = 8 * (x / 2) + cb;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + i0);
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * x + c;
        float z = s[e], jac = 1.f;
        if (cap > 0.f) {
          const float th = tanh_ex2(z * inv_cap);
          z = cap * th;
          jac = fmaf(-th, th, 1.f);
        }
        p[c] = ex2(fmaf(z, kLog2e, -(c ? l2.y : l2.x) * kLog2e));
        if (!whole) {
          const int i = i0 + c, qpos = q_lo + i;
          const bool ok = kpos < k_valid && qq0 + i < sq &&
                          (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          p[c] = ok ? p[c] : 0.f;
        }
        s[e] = p[c] * jac;
      }
      pf[x] = pack2(p[0], p[1]);
    }
    if (wgi == 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
        wgmma_rs<D>(acc, pf + 4 * kk, desc_mn<D>(s_do(st), TQ, kk));
      wgmma_commit();
      wgmma_wait0();
    } else {
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < TQ / 2; ++i) fence_reg(dp[i]);
#pragma unroll
      for (int x = 0; x < TQ / 4; ++x) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dl + 8 * (x / 2) + cb);
        pf[x] = pack2(s[2 * x] * (dp[2 * x] - d2.x),
                      s[2 * x + 1] * (dp[2 * x + 1] - d2.y));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
        wgmma_rs<D>(acc, pf + 4 * kk, desc_mn<D>(s_q(st), TQ, kk));
      wgmma_commit();
      wgmma_wait0();
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int i = 0; i < TQ / 4; ++i) fence_reg(pf[i]);
    __syncthreads();
  }
  if (nitems == 0) cp_async_wait<0>();
  __nv_bfloat16* dst = wgi == 0 ? dv : dk;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + row0 + 8 * half;
    if (key >= sk) continue;
    const int64_t g = kv_off + static_cast<int64_t>(key) * D + cb;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + g + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                acc[4 * j + 2 * half + 1]);
  }
"""


def sk1(s: str) -> str:
    """S and dP: a fresh accumulator per k8 step of D."""
    s = _rep(s, "static constexpr int kSliceKs = 4;  // k8 steps of one S or "
             "dP accumulator", "static constexpr int kSliceKs = 1;")
    return _rep(s, "static constexpr int kSliceKs = D == 256 ? 2 : 4;",
                "static constexpr int kSliceKs = 1;")


def f64sum(s: str) -> str:
    """S's and dP's partials added in f64 and rounded once."""
    s = _rep(s, "template <int D, int N, int SK>\n__device__ "
             "__forceinline__ void product_s(float* x,", "template <int D, "
             "int N, int SK>\n__device__ __forceinline__ void "
             "product_s_f64(double* x,")
    s = _rep(s, "x[i] = sl == 0 ? part[slot][i] : __fadd_rn(x[i], "
             "part[slot][i]);", "x[i] = sl == 0 ? part[slot][i] : x[i] + "
             "part[slot][i];")
    return _rep(s, "// P = exp(S' - lse) and dS", F64SUM + "// P = exp(S' - lse) and dS")


F64SUM = """template <int D, int N, int SK>
__device__ __forceinline__ void product_s(float* x, const uint8_t* a,
                                          uint32_t sb_hi, uint32_t sb_lo,
                                          int terms) {
  double y[N / 2];
  product_s_f64<D, N, SK>(y, a, sb_hi, sb_lo, terms);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = static_cast<float>(y[i]);
}

"""


def variants(f32: bool, parent) -> dict:
    if not f32:
        return {"kept": SRC, "exchange": exchange(SRC), "roles": roles(SRC)}
    out = {"kept": SRC, "sk1": sk1(SRC), "f64sum": f64sum(SRC)}
    if parent:
        out["parent"] = Path(parent).read_text()
    return out


def build(sources: dict) -> dict:
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log)
            raise SystemExit(f"{name}: nvcc failed")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def run_pass(lib, which: int, ptrs, dims) -> None:
    """One pass; dims ends with (bf16, terms), or (bf16,) for a revision
    whose C interface has no ``terms``."""
    fn = lib.flash_attention_bwd_dkdv if which else lib.flash_attention_bwd_dq
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + \
        [ctypes.c_float] * 2 + [ctypes.c_int] * (len(dims) - 10) + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*ptrs, *dims, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed with CUDA error {err}")


def main() -> None:
    args = sys.argv[1:]
    f32 = "--f32" in args
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    rest = [a for i, a in enumerate(args) if not a.startswith("--")
            and (i == 0 or args[i - 1] != "--parent")]
    names = rest[0].split(",") if rest else ["a", "b", "d"]
    dtype = torch.float32 if f32 else torch.bfloat16
    dname = "float32" if f32 else "bfloat16"
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    libs = build(variants(f32, parent))
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    bad = False
    for name in names:
        b, hq, hkv, sq, sk, d, causal, window, cap, kv_len = \
            cs.FLASH_BWD_SHAPES[name]
        q, k = ((torch.randn(s, generator=gen, device="cuda")
                 * cs.BWD_INPUT_SCALE).to(dtype)
                for s in ((b, hq, sq, d), (b, hkv, sk, d)))
        v = torch.randn((b, hkv, sk, d), generator=gen,
                        device="cuda").to(dtype)
        dout = torch.randn((b, hq, sq, d), generator=gen,
                           device="cuda").to(dtype)
        kvl = torch.tensor(kv_len or (sk,) * b, dtype=torch.int32,
                           device="cuda")
        kw = dict(causal=causal, window=window, softcap=cap)
        out, lse = k5.flash_attention(q, k, v, kvl, return_lse=True, **kw)
        # f32: the plain version evaluated in f64, as chip_smoke.py holds it
        want = k5.flash_attention_bwd_plain(
            *(t.to(torch.float64 if f32 else dtype) for t in (q, k, v, out)),
            lse, dout.to(torch.float64 if f32 else dtype), kvl, **kw)
        pairs = cs.unmasked_pairs(sq, sk, causal, window, kv_len or (sk,) * b)
        bound = cs.bound(4 * (q.numel() + k.numel()) * q.element_size()
                         + 4 * b * hq * sq + 4 * b, 10 * d * hq * pairs,
                         cs.TF32X3_FLOPS if f32 else cs.BF16_FLOPS)[0]
        dims = (b, hq, hkv, sq, sk, d, int(causal), int(window), float(cap),
                d ** -0.5, int(not f32))
        line = [f"({name})"]
        for vname, lib in libs.items():
            delta = torch.empty((b, hq, sq), device="cuda")
            qs, dq, dk, dv = (torch.empty_like(t) for t in (q, q, k, v))
            ptrs = [t.data_ptr() for t in (q, k, v, out, lse, dout, kvl,
                                           delta, qs, dq, dk, dv)]
            vdims = dims if vname == "parent" else dims + (3,)
            run_pass(lib, 0, ptrs, vdims)
            run_pass(lib, 1, ptrs, vdims)
            torch.cuda.synchronize()
            row, fro = cs.bwd_rel_errs((dq, dk, dv), want)
            ok = row <= cs.BWD_ROW_LIMIT[dname] and \
                fro <= cs.BWD_FRO_LIMIT[dname]
            bad |= not ok
            ms = [cs.time_ms(lambda w=w: run_pass(lib, w, ptrs, vdims), 5)
                  for w in (0, 1)]
            line.append(f"{vname}: row {row:.3e} fro {fro:.3e} "
                        f"{'ok' if ok else 'OVER THE LIMITS'}; dq "
                        f"{ms[0]:.4f} ms, dk/dv {ms[1]:.4f} ms, total "
                        f"{sum(ms):.4f} ms, frac of bound "
                        f"{bound / sum(ms):.4f}")
        print(" | ".join(line), flush=True)
        del want
        torch.cuda.empty_cache()
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
