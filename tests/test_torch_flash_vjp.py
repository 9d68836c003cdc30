"""Flash attention's backward on the CPU against the JAX package.

The port's ``nn/flash_vjp.py::flash_mha`` (an ``autograd.Function`` with
the reference's hand-written two-pass backward) must match ``jax.vjp`` of
``repro.nn.flash_vjp.flash_mha``: the output and (dq, dk, dv), over the
causal mask, the window, the softcap, GQA groups of 1 and 2 and query
offsets 0 and Sk - Sq, in the f32 band (``tests/tolerance.py``).

K5's side: ``flash_attention_plain(return_lse=True)`` must give the
reference ``_fwd_scan``'s row logsumexp, and ``flash_attention_bwd_plain``
(what K5's backward kernels are held against on the card) the gradients
of ``jax.grad`` through the reference's ``direct_attention``; K5's op
under autograd takes the plain versions for CPU tensors, and
``attention_block`` routes a training forward through it (cuda tier, with
its device check lifted) or through ``flash_attention_xla`` (torch tier,
past 2048 tokens).  The kernels themselves need a card:
tests/test_torch_cuda.py holds them there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tolerance import assert_allclose_dtype

from repro.nn import attention as jattn
from repro.nn import flash_vjp as jvjp
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import ops
from repro_torch.nn import attention as tattn
from repro_torch.nn import flash_vjp as tvjp

torch.set_num_threads(2)

RNG = np.random.default_rng(28)
B, HKV, SQ, SK, D = 2, 2, 32, 48, 16
#: K5 shapes: b, hq, hkv, sq, sk, d, causal, window, cap, kv_len
K5_CASES = [
    (2, 4, 2, 40, 40, 16, True, 0, 0.0, None),
    (1, 4, 2, 24, 56, 32, True, 0, 5.0, None),
    (2, 2, 1, 48, 48, 16, True, 12, 0.0, None),
    (1, 4, 4, 1, 30, 16, True, 0, 0.0, None),        # decode shape
    (1, 2, 2, 36, 36, 32, False, 0, 3.0, None),      # non-causal
    (2, 4, 2, 20, 50, 16, True, 8, 4.0, 44),         # kv_len, right-aligned
]


def _np(*shapes):
    return [RNG.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("q_start", [0, SK - SQ])
def test_flash_mha_matches_reference_vjp(causal, window, cap, g, q_start):
    q, k, v, do = _np((B, HKV, g, SQ, D), (B, HKV, SK, D), (B, HKV, SK, D),
                      (B, HKV, g, SQ, D))
    opts = (causal, window, cap, 16, 16)

    def ref(q_, k_, v_):
        return jvjp.flash_mha(q_, k_, v_, jnp.float32(q_start), *opts)

    want, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wq, wk, wv = vjp(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    got = tvjp.flash_mha(tq, tk, tv, q_start, *opts)
    gq, gk, gv = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    assert_allclose_dtype(got.detach(), want)
    for name, a, b in (("dq", gq, wq), ("dk", gk, wk), ("dv", gv, wv)):
        assert_allclose_dtype(a, b, err_msg=name)


def test_flash_mha_ragged_chunks_match_dividing_ones():
    """Chunks that do not divide the sequences give the dividing chunks'
    results: every row and tile is computed the same way."""
    q, k, v, do = _np((1, 2, 2, 40, D), (1, 2, 56, D), (1, 2, 56, D),
                      (1, 2, 2, 40, D))
    outs = []
    for qc, kc in ((8, 8), (24, 12)):
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        o = tvjp.flash_mha(tq, tk, tv, 16, True, 20, 5.0, qc, kc)
        outs.append([o] + list(torch.autograd.grad(
            o, (tq, tk, tv), torch.from_numpy(do))))
    for a, b in zip(*outs):
        assert_allclose_dtype(a.detach(), b.detach())


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,kvl", K5_CASES)
def test_plain_lse_matches_fwd_scan(b, hq, hkv, sq, sk, d, causal, window,
                                    cap, kvl):
    """K5's plain forward with ``return_lse=True`` against the reference's
    ``_fwd_scan`` (out and lse) on the grouped, pre-scaled q, query row 0
    at kv_len - Sq."""
    q, k, v = _np((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    n = sk if kvl is None else kvl
    kv_len = None if kvl is None else torch.full((b,), kvl, dtype=torch.int32)
    out, lse = k5.flash_attention_plain(*_t(q, k, v), kv_len, causal=causal,
                                        window=window, softcap=cap,
                                        q_chunk=16, kv_chunk=8,
                                        return_lse=True)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    qg = jnp.asarray(q).reshape(b, hkv, hq // hkv, sq, d) * d ** -0.5
    # the reference has no kv_len: its keys are the first n
    want_o, want_l = jvjp._fwd_scan(
        qg, jnp.asarray(k[:, :, :n]), jnp.asarray(v[:, :, :n]),
        jnp.float32(n - sq), causal=causal, window=window, cap=cap,
        q_chunk=sq, kv_chunk=n)
    assert_allclose_dtype(out, np.asarray(want_o).reshape(b, hq, sq, d))
    assert_allclose_dtype(lse, np.asarray(want_l).reshape(b, hq, sq))
    # the same out as without the lse, bit for bit
    assert torch.equal(out, k5.flash_attention_plain(
        *_t(q, k, v), kv_len, causal=causal, window=window, softcap=cap,
        q_chunk=16, kv_chunk=8))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,kvl", K5_CASES)
def test_plain_backward_matches_jax_grad(b, hq, hkv, sq, sk, d, causal,
                                         window, cap, kvl):
    """``flash_attention_bwd_plain`` from the plain forward's out and lse
    against ``jax.vjp`` of the reference's ``direct_attention`` (the same
    function, scores materialized)."""
    q, k, v, do = _np((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      (b, hq, sq, d))
    kv_len = None if kvl is None else torch.full((b,), kvl, dtype=torch.int32)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = k5.flash_attention_plain(tq, tk, tv, kv_len, causal=causal,
                                        window=window, softcap=cap,
                                        q_chunk=16, kv_chunk=8,
                                        return_lse=True)
    got = k5.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, kv_len,
                                       causal=causal, window=window,
                                       softcap=cap, q_chunk=16, kv_chunk=8)

    def ref(q_, k_, v_):
        return jattn.direct_attention(q_, k_, v_, causal=causal,
                                      window=window, cap=cap, kv_len=kvl)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, a, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do))):
        assert a.dtype == torch.float32
        assert_allclose_dtype(a, w, err_msg=name)


def test_plain_backward_all_masked_rows_give_zero_gradients():
    """kv_len = 0 masks every key of batch 0: its lse is about -1e30 and
    every gradient it feeds is 0, not NaN; batch 1 is unaffected."""
    q, k, v, do = _t(*_np((2, 4, 8, 16), (2, 2, 20, 16), (2, 2, 20, 16),
                          (2, 4, 8, 16)))
    kv_len = torch.tensor([0, 20], dtype=torch.int32)
    out, lse = k5.flash_attention_plain(q, k, v, kv_len, softcap=5.0,
                                        return_lse=True)
    assert bool((lse[0] <= -1e29).all()) and bool((lse[1] > -1e29).all())
    assert bool((out[0] == 0).all())
    dq, dk, dv = k5.flash_attention_bwd_plain(q, k, v, out, lse, do, kv_len,
                                              softcap=5.0)
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all()) and bool((g[0] == 0).all())
    assert float(dq[1].abs().max()) > 0


def test_flash_attention_function_on_cpu_matches_autograd():
    """K5's op under autograd on CPU tensors: the plain forward (with lse)
    and the plain backward, against autograd through the plain forward;
    the launch counters do not move."""
    q, k, v, do = _np((1, 4, 24, 16), (1, 2, 24, 16), (1, 2, 24, 16),
                      (1, 4, 24, 16))
    kw = dict(causal=True, window=10, softcap=5.0)
    n0 = (k5.flash_attention.launches, k5.flash_attention_bwd.launches)
    a = [t.requires_grad_() for t in _t(q, k, v)]
    got = k5.flash_attention(*a, **kw)
    ga = torch.autograd.grad(got, a, torch.from_numpy(do))
    b_ = [t.requires_grad_() for t in _t(q, k, v)]
    want = k5.flash_attention_plain(*b_, **kw)
    gb = torch.autograd.grad(want, b_, torch.from_numpy(do))
    assert torch.equal(got.detach(), want.detach())
    for x, y in zip(ga, gb):
        assert_allclose_dtype(x, y)
    assert (k5.flash_attention.launches,
            k5.flash_attention_bwd.launches) == n0


@pytest.fixture
def cuda_tier_on_cpu(monkeypatch):
    """The cuda tier with its device check lifted: K5's wrappers then get
    CPU tensors and run their plain versions inside the op's autograd."""
    def check(backend, x):
        assert backend in ("torch", "cuda")
    monkeypatch.setattr(ops, "_check_tier", check)


@pytest.fixture
def spy_function(monkeypatch):
    """Counts the forwards of K5's op under autograd (``_FlashAttention``,
    the op's Autograd kernel)."""
    count = {"n": 0}
    fwd = k5._FlashAttention.forward

    def spy(ctx, *args):
        count["n"] += 1
        return fwd(ctx, *args)
    monkeypatch.setattr(k5._FlashAttention, "forward", staticmethod(spy))
    return count


def _block_inputs(s):
    from repro_torch.configs import gemma2_9b
    cfg = gemma2_9b.reduced()
    gen = torch.Generator().manual_seed(0)
    p = tattn.Attention(cfg.d_model, cfg.attention, dtype=torch.float32,
                        device="cpu", generator=gen)
    x = torch.from_numpy(RNG.standard_normal(
        (1, s, cfg.d_model)).astype(np.float32))
    return cfg.attention, p, x


def _block_grads(impl, cfg, p, x, window):
    params = [p.wq, p.wk, p.wv, p.wo]
    xr = x.clone().requires_grad_()
    out, _ = tattn.attention_block(p, xr, cfg, layer_window=window,
                                   impl=impl)
    grads = torch.autograd.grad(out.square().sum(), params + [xr])
    return out.detach(), grads


@pytest.mark.parametrize("window", [0, 16])
def test_attention_block_cuda_tier_trains_through_the_function(
        cuda_tier_on_cpu, spy_function, window):
    """Under autograd the cuda tier's prefill goes through K5's op under
    autograd (its plain versions here); without a gradient it does not,
    and its output is the same.  The gradients match the direct
    path's."""
    cfg, p, x = _block_inputs(40)
    out, grads = _block_grads("cuda", cfg, p, x, window)
    assert spy_function["n"] == 1
    with torch.no_grad():
        again, _ = tattn.attention_block(p, x, cfg, layer_window=window,
                                         impl="cuda")
    assert spy_function["n"] == 1 and torch.equal(again, out)
    want, wgrads = _block_grads("direct", cfg, p, x, window)
    assert_allclose_dtype(out, want)
    for a, b in zip(grads, wgrads):
        assert_allclose_dtype(a, b, scale=10)


def test_attention_block_torch_tier_past_2048_takes_flash_attention_xla(
        monkeypatch):
    """The torch tier attends directly up to 2048 tokens and past it runs
    ``flash_attention_xla`` (the flash_vjp Function), as the reference
    does, with a gradient and without one -- the same output either
    way, and K5's plain version against it within the f32 band."""
    calls = {"n": 0}
    xla = tattn.flash_attention_xla

    def spy(*a, **kw):
        calls["n"] += 1
        return xla(*a, **kw)
    monkeypatch.setattr(tattn, "flash_attention_xla", spy)
    cfg, p, x = _block_inputs(2560)
    out, grads = _block_grads("torch", cfg, p, x, 16)
    assert calls["n"] == 1
    with torch.no_grad():
        again, _ = tattn.attention_block(p, x, cfg, layer_window=16,
                                         impl="torch")
        q, k, v = tattn._project(p, x, cfg, torch.arange(2560)[None, :])
        plain = ops.flash_attention(q, k, v, causal=cfg.causal, window=16,
                                    softcap=cfg.attn_logit_softcap,
                                    backend="torch")
        plain = plain.transpose(1, 2).reshape(1, 2560, cfg.q_dim) @ p.wo
    assert calls["n"] == 2 and torch.equal(again, out)
    assert_allclose_dtype(again, plain)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_flash_attention_xla_keeps_its_chunks_at_an_odd_length(monkeypatch):
    """At an odd length the chunks stay (2048, 1024) with a ragged last
    one, not halved to 1 until they divide it, and the output matches
    direct attention within the f32 band."""
    seen = []
    mha = tattn.flash_mha

    def spy(*a):
        seen.append(a[-2:])
        return mha(*a)
    monkeypatch.setattr(tattn, "flash_mha", spy)
    s = 2561
    q = torch.from_numpy(RNG.standard_normal((1, 2, s, 8)).astype(np.float32))
    k, v = (torch.from_numpy(RNG.standard_normal((1, 1, s, 8))
                             .astype(np.float32)) for _ in range(2))
    got = tattn.flash_attention_xla(q, k, v, causal=True, window=300,
                                    cap=30.0)
    assert seen == [(2048, 1024)]
    want = tattn.direct_attention(q, k, v, causal=True, window=300, cap=30.0)
    assert_allclose_dtype(got, want)
