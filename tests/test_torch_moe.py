"""The port's MoE layer and MoE stacks on the CPU against the JAX package.

Layer level: ``capacity`` and ``moe_ffn`` (``models/moe.py``) against
``repro.models.moe``, the reference's ``init_moe`` weights loaded into the
port's ``MoE``, the same numpy inputs on both sides.  Both sides route the
same inputs, so no route may differ: the port's top-k ids must equal the
reference's, and with drops (a skewed router) the outputs must match,
which they cannot if another assignment were dropped.  f32 in the f32 band
(aux within 1e-6), bf16 in the bf16 band; the gradients of ``out.sum() +
aux`` against ``jax.grad`` for x and every leaf.

Model level: reduced arctic (dense residual, top-2 of 4), reduced kimi
(top-2 of 8) and a stack of dense and MoE layers (``every_2``), in f32:
``lm_forward``, ``lm_prefill`` + ``lm_decode_step``, ``lm_loss`` with its
aux and gradients, one ``make_train_step`` step.  Across two frameworks a
router near a tie may pick another expert (an O(1) change of that token's
output, not an error of the port).  So the tests apply the route rule:
forward hooks on the port's ``MoE`` modules and ``jax.debug.callback`` in
a wrapper of the reference's ``moe_ffn`` record every MoE layer's router
probabilities; a route that differs with no differing route upstream of
it must be a near tie (the gap between the k-th and (k+1)-th probability
under ``TIE_GAP``); logits are compared only at positions with no
differing route at or before them in their sequence (a route reaches
later positions through attention and the capacity's ranks).  The loss,
its gradients and the training step need every route to agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from moe_routes import Routes
from tolerance import assert_allclose_dtype

from repro.config import MoEConfig as JMoEConfig
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.configs import arctic_480b as jarctic
from repro.configs import kimi_k2 as jkimi
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.optim import optimizer as jopt
from repro_torch.config import MoEConfig, OptimizerConfig, get_config
from repro_torch.configs import arctic_480b, kimi_k2
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe
from repro_torch.models import transformer as ttr
from repro_torch.optim.optimizer import make_train_state

torch.set_num_threads(2)

#: f32 band x 10 for whole-model logits (tests/test_torch_lm.py)
LM_SCALE = 10
#: each gradient leaf against the reference's, over that leaf's largest
#: magnitude (tests/test_torch_lm_train.py)
LEAF_LIMIT = 1e-4


def _every_2(mod):
    """Dense and MoE layers alternating (the reference's ``every_2``: the
    odd layers MoE), 4 layers, no dense residual."""
    c = mod.reduced()
    return dataclasses.replace(
        c, name="every2-smoke", num_layers=4,
        moe=dataclasses.replace(c.moe, layer_pattern="every_2",
                                dense_residual=False, dense_residual_d_ff=0))


ARCHS = {"arctic": (arctic_480b.reduced, jarctic.reduced),
         "kimi": (kimi_k2.reduced, jkimi.reduced),
         "every_2": (lambda: _every_2(arctic_480b),
                     lambda: _every_2(jarctic))}


def _jcfg(cfg: MoEConfig) -> JMoEConfig:
    return JMoEConfig(**dataclasses.asdict(cfg))


def _leaf_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,k,factor", [(4, 2, 1.25), (8, 2, 1.0),
                                        (128, 2, 1.25), (384, 8, 1.25)])
@pytest.mark.parametrize("t", [1, 7, 64, 1000, 4080])
def test_capacity_matches_reference(e, k, factor, t):
    cfg = MoEConfig(num_experts=e, top_k=k, expert_d_ff=8,
                    capacity_factor=factor)
    assert moe.capacity(cfg, t) == jmoe.capacity(_jcfg(cfg), t)
    c = moe.slots(cfg, t)
    assert c % 8 == 0 and c >= min(t * k, moe.capacity(cfg, t))
    assert moe.slots(cfg, t, dropless=True) == -(-max(8, t * k) // 8) * 8


def _layer(cfg: MoEConfig, activation, dtype, d=32, seed=0, skew=0.0):
    """(reference params, port MoE with the same weights); ``skew`` adds
    that much to the router's column of expert 0, so that tokens of a
    positive mean (``_x(offset=)``) pick it."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params = jmoe.init_moe(jax.random.PRNGKey(seed), d, _jcfg(cfg),
                           activation, jdt)
    if skew:
        w = params["router"]["w"]
        params["router"]["w"] = w.at[:, 0].add(skew)
    flat = {}
    for key, sub in params.items():
        ttr.flatten_into(flat, key, sub if isinstance(sub, dict) else
                         {"w": sub})
    flat = {n: np.asarray(v, np.float32) for n, v in flat.items()}
    layer = moe.MoE(d, cfg, activation, dtype=dtype, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    return params, ttr.load_flat(layer, flat)


def _x(shape, dtype, seed=1, offset=0.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x += offset
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    return jx, torch.tensor(np.asarray(jx.astype(jnp.float32))).to(dtype)


def _ref_ids(params, jx, k):
    xf = jx.reshape(-1, jx.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ params["router"]["w"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


def _check_layer(cfg, activation, dtype, dropless, shape=(2, 24, 32),
                 skew=0.0):
    params, layer = _layer(cfg, activation, dtype, d=shape[-1], skew=skew)
    jx, x = _x(shape, dtype, offset=1.0 if skew else 0.0)
    want, jaux = jmoe.moe_ffn(params, jx, _jcfg(cfg), activation,
                              dropless=dropless)
    with torch.no_grad():
        got, aux = layer(x, dropless=dropless)
        ids = moe.route(layer.router, x.reshape(-1, shape[-1]),
                        cfg.top_k)[2]
    # the same inputs route the same way: no flip
    np.testing.assert_array_equal(ids.numpy(), _ref_ids(params, jx,
                                                         cfg.top_k))
    assert got.dtype == dtype and got.shape == shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert_allclose_dtype(got.float(), np.asarray(want, np.float32),
                          dtype="f32" if dtype == torch.float32 else "bf16")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    return layer, x, ids


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dense_residual", [False, True])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_ffn_f32_matches_reference(activation, dense_residual, dropless):
    cfg = MoEConfig(num_experts=8, top_k=2, expert_d_ff=48,
                    dense_residual=dense_residual,
                    dense_residual_d_ff=40 if dense_residual else 0)
    _check_layer(cfg, activation, torch.float32, dropless)


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_ffn_bf16_matches_reference(dropless):
    cfg = MoEConfig(num_experts=8, top_k=2, expert_d_ff=48,
                    dense_residual=True, dense_residual_d_ff=40)
    _check_layer(cfg, "swiglu", torch.bfloat16, dropless)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_top8_matches_reference(dtype):
    """k = 8 of 16 experts: a token's eight slot outputs are added in the
    order of their sorted positions, as the reference's scatter-add."""
    cfg = MoEConfig(num_experts=16, top_k=8, expert_d_ff=32)
    _check_layer(cfg, "swiglu", dtype, False)


@pytest.mark.parametrize("dense_residual", [False, True])
def test_moe_ffn_drops_the_reference_assignments(dense_residual):
    """A router skewed to expert 0: its segment overflows the capacity and
    the assignments past it are dropped.  The test first asserts the drops
    (and that they change the output: dropless differs), then holds the
    output to the reference's, which it matches only with the same
    assignments dropped."""
    cfg = MoEConfig(num_experts=8, top_k=2, expert_d_ff=48,
                    dense_residual=dense_residual,
                    dense_residual_d_ff=40 if dense_residual else 0)
    layer, x, ids = _check_layer(cfg, "swiglu", torch.float32, False,
                                 skew=0.1)
    t = x.shape[0] * x.shape[1]
    c = moe.slots(cfg, t)
    keep = moe.dispatch(ids, cfg.num_experts, c)[3]
    dropped = int((~keep).sum())
    assert dropped > 0 and int((ids == 0).sum()) > c, (dropped, c)
    with torch.no_grad():
        full, _ = layer(x, dropless=True)
        part, _ = layer(x)
    assert not torch.allclose(full, part)
    # a token whose every assignment was dropped gets 0 from the experts
    if not dense_residual:
        order, _, _, keep, tok = moe.dispatch(ids, cfg.num_experts, c)
        kept = torch.zeros(t, dtype=torch.long).index_add_(
            0, tok, keep.long())
        assert torch.equal(part.reshape(t, -1)[kept == 0],
                           torch.zeros_like(part.reshape(t, -1)[kept == 0]))


@pytest.mark.parametrize("activation,dense_residual,skew",
                         [("swiglu", True, 0.0), ("gelu", False, 0.0),
                          ("geglu", False, 0.5)])
def test_moe_ffn_gradients_match_reference(activation, dense_residual, skew):
    """d(out.sum() + aux) for x and every leaf against ``jax.grad``: each
    within LEAF_LIMIT of that leaf's largest magnitude (the router's
    through the gates and the aux loss; with drops in the skewed case)."""
    cfg = MoEConfig(num_experts=8, top_k=2, expert_d_ff=48,
                    dense_residual=dense_residual,
                    dense_residual_d_ff=40 if dense_residual else 0)
    params, layer = _layer(cfg, activation, torch.float32, skew=skew)
    jx, x = _x((2, 24, 32), torch.float32, offset=1.0 if skew else 0.0)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, _jcfg(cfg), activation)
        return out.sum() + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jx)
    x.requires_grad_(True)
    out, aux = layer(x)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(out.sum() + aux,
                                [x] + [p for _, p in layer.named_parameters()])
    want = {}
    for key, sub in jgp.items():
        ttr.flatten_into(want, key, sub if isinstance(sub, dict) else
                         {"w": sub})
    assert sorted(want) == sorted(names)
    assert _leaf_err(grads[0].numpy(), np.asarray(jgx)) <= LEAF_LIMIT
    for n, g in zip(names, grads[1:]):
        assert _leaf_err(g.numpy(), np.asarray(want[n])) <= LEAF_LIMIT, n


def test_moe_init_draws_like_reference():
    """``MoE``'s leaves: the reference's names, shapes and dtypes (router
    f32, experts in the model's dtype), each leaf's std within 5 % of the
    reference's draw."""
    cfg = MoEConfig(num_experts=8, top_k=2, expert_d_ff=96,
                    dense_residual=True, dense_residual_d_ff=80)
    params, _ = _layer(cfg, "swiglu", torch.bfloat16, d=128)
    layer = moe.MoE(128, cfg, "swiglu", dtype=torch.bfloat16, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    want = {}
    for key, sub in params.items():
        ttr.flatten_into(want, key, sub if isinstance(sub, dict) else
                         {"w": sub})
    got = dict(layer.named_parameters())
    assert sorted(got) == sorted(want)
    for n, p in got.items():
        assert tuple(p.shape) == want[n].shape, n
        assert p.dtype == (torch.float32 if n == "router" else
                           torch.bfloat16), n
        ratio = p.float().std().item() / float(
            np.asarray(want[n], np.float32).std())
        assert abs(ratio - 1) < 0.05, (n, ratio)


def test_moe_flops_matches_reference():
    cfg = MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864)
    for act in ("swiglu", "gelu"):
        assert moe.moe_flops(cfg, 7168, 4080, act) == \
            jmoe.moe_flops(_jcfg(cfg), 7168, 4080, act)


# ---------------------------------------------------------------------------
# The stacks, under the route rule
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(ARCHS))
def stack(request):
    """(cfg, reference cfg, reference params, port model), f32."""
    tred, jred = ARCHS[request.param]
    cfg = dataclasses.replace(tred(), dtype="float32")
    jcfg = dataclasses.replace(jred(), dtype="float32")
    params = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    model = ttr.TransformerLM(cfg, device="cpu").params_from_reference(
        jax.tree.map(np.asarray, params))
    return cfg, jcfg, params, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _n_moe(cfg):
    return sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))


def test_stack_layers_and_params_from_reference(stack):
    """An MoE position holds ``moe`` in place of ``mlp``; the reference's
    ``blocks.posN.moe`` leaves (router, wi, wo, wg, dense) load by name,
    period 2 for ``every_2``."""
    cfg, _, params, model = stack
    assert [blk.is_moe for blk in model.layers] == \
        [cfg.layer_is_moe(i) for i in range(cfg.num_layers)]
    period = len(ttr.layer_positions(cfg))
    mine = dict(model.named_parameters())
    for n, blk in enumerate(model.layers):
        sub = params["blocks"][f"pos{n % period}"]
        if blk.is_moe:
            assert not hasattr(blk, "mlp")
            np.testing.assert_array_equal(
                mine[f"layers.{n}.moe.router"].detach().numpy(),
                np.asarray(sub["moe"]["router"]["w"][n // period]))
            np.testing.assert_array_equal(
                mine[f"layers.{n}.moe.wo"].detach().numpy(),
                np.asarray(sub["moe"]["wo"][n // period]))
            assert (f"layers.{n}.moe.dense.wi" in mine) == \
                cfg.moe.dense_residual
        else:
            assert "moe" not in sub and not hasattr(blk, "moe")


def test_stack_forward_prefill_decode_match_reference(stack, monkeypatch):
    cfg, jcfg, params, model = stack
    k, n_moe = cfg.moe.top_k, _n_moe(cfg)
    toks = _tokens(cfg, (2, 20), 1)
    routes = Routes(monkeypatch)
    want, jaux = jtr.lm_forward(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got = ttr.lm_forward(model, torch.from_numpy(toks))
    mask, share = routes.comparable(k, 2, [(list(range(20)), n_moe)])
    print(f"{cfg.name}: {share:.2%} of routes differ")
    assert mask.mean() >= 0.5
    assert_allclose_dtype(got.numpy()[mask], np.asarray(want)[mask],
                          scale=LM_SCALE)

    routes.port.clear(), routes.ref.clear()
    calls = [(list(range(16)), n_moe)]
    jlg, jcaches, jlen = jtr.lm_prefill(params, jcfg,
                                        jnp.asarray(toks[:, :16]),
                                        cache_size=24)
    with torch.no_grad():
        lg, caches, length = ttr.lm_prefill(
            model, torch.from_numpy(toks[:, :16]), 24)
        logits, jlogits = [lg], [jlg]
        for t in range(16, 20):
            jlg, jcaches, jlen = jtr.lm_decode_step(
                params, jcfg, jnp.asarray(toks[:, t:t + 1]), jcaches, jlen)
            lg, caches, length = ttr.lm_decode_step(
                model, torch.from_numpy(toks[:, t:t + 1]), caches, length)
            logits.append(lg), jlogits.append(jlg)
            calls.append(([t], n_moe))
    mask, _ = routes.comparable(k, 2, calls)
    routes.close()
    got = torch.cat(logits, 1).numpy()
    want = np.concatenate([np.asarray(a) for a in jlogits], 1)
    cols = mask[:, [15, 16, 17, 18, 19]]
    assert cols.mean() >= 0.5
    assert_allclose_dtype(got[cols], want[cols], scale=LM_SCALE)
    assert int(length) == int(jlen) == 20


def test_stack_decode_is_dropless_and_matches_forward(stack):
    """Decode is dropless (``cache`` given).  Over 8 tokens the forward's
    capacity (at least 8 slots) cannot drop either, since a token takes an
    expert once; so a decode step's logits are the full forward's at that
    position, on the port alone."""
    cfg, _, _, model = stack
    toks = torch.from_numpy(_tokens(cfg, (1, 8), 2))
    assert moe.slots(cfg.moe, 8) >= 8
    with torch.no_grad():
        full = ttr.lm_forward(model, toks)
        _, caches, length = ttr.lm_prefill(model, toks[:, :7], 16)
        lg, _, _ = ttr.lm_decode_step(model, toks[:, 7:], caches, length)
    assert_allclose_dtype(lg[:, 0], full[:, -1], scale=LM_SCALE)


def test_stack_loss_aux_and_gradients_match_reference(stack, monkeypatch):
    """``lm_loss`` returns ``ce + aux`` with aux the MoE layers' load
    losses summed in layer order; the loss, ce, aux and every gradient
    leaf against ``jax.value_and_grad``.  Every route must agree."""
    cfg, jcfg, params, model = stack
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)],
                            1)
    routes = Routes(monkeypatch)
    (jloss, jm), jgrad = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jcfg, jnp.asarray(toks),
                              jnp.asarray(labels), ce_chunk=16),
        has_aux=True)(params)
    loss, metrics = ttr.lm_loss(model, torch.from_numpy(toks),
                                torch.from_numpy(labels), ce_chunk=16)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    mask, _ = routes.comparable(cfg.moe.top_k, 2,
                                [(list(range(24)), _n_moe(cfg))])
    routes.close()
    assert mask.all(), "a route differs: the gradients are not comparable"
    assert float(metrics["aux"].detach()) > 0
    assert_allclose_dtype(loss.detach(), np.asarray(jloss))
    assert_allclose_dtype(metrics["ce"].detach(), np.asarray(jm["ce"]))
    np.testing.assert_allclose(float(metrics["aux"].detach()),
                               float(jm["aux"]),
                               rtol=0, atol=1e-6)
    assert torch.equal(loss.detach(), (metrics["ce"] + metrics["aux"]))
    want = ttr.flatten_reference(jax.tree.map(np.asarray, jgrad), cfg)
    assert sorted(want) == sorted(names)
    errs = {n: _leaf_err(g.numpy(), want[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_LIMIT, (worst, errs[worst])


def test_stack_train_step_matches_reference(stack, monkeypatch):
    """One AdamW ``make_train_step`` step from the reference's weights:
    the metrics in the f32 band, each parameter leaf within LEAF_LIMIT of
    its largest magnitude (norm scales as the 1 + scale they apply).
    Every route must agree."""
    cfg, jcfg, params, model = stack
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, weight_decay=0.0,
              eps=1e-6)
    opt, jopt_cfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": toks,
             "labels": np.roll(toks, -1, 1).astype(np.int32)}
    routes = Routes(monkeypatch)
    state = make_train_state(
        {n: p.detach().clone() for n, p in model.named_parameters()}, opt)
    state, metrics = tsteps.make_train_step(cfg, opt)(state, batch)
    jstate, jmetrics = jsteps.make_train_step(jcfg, jopt_cfg)(
        jopt.make_train_state(params, jopt_cfg),
        {k: jnp.asarray(v) for k, v in batch.items()})
    mask, _ = routes.comparable(cfg.moe.top_k, 2,
                                [(list(range(16)), _n_moe(cfg))])
    routes.close()
    assert mask.all(), "a route differs: the steps are not comparable"
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert_allclose_dtype(metrics[key], np.asarray(jmetrics[key]),
                              scale=10, err_msg=key)
    want = ttr.flatten_reference(jax.tree.map(np.asarray, jstate.params),
                                 cfg)
    scales = {n for n in want if n.endswith(".scale")}
    errs = {n: _leaf_err(p.numpy() + (n in scales), want[n] + (n in scales))
            for n, p in state.params.items()}
    assert all(e <= LEAF_LIMIT for e in errs.values()), \
        {n: e for n, e in errs.items() if e > LEAF_LIMIT}


def test_step_makers_take_the_moe_family(stack):
    """``launch/steps.py`` runs an MoE stack through ``TransformerLM``:
    ``make_prefill_step`` and ``make_decode_step`` bit for bit
    ``lm_prefill`` and ``lm_decode_step``, ``make_eval_step`` the loss's
    ce and aux."""
    cfg, _, _, model = stack
    toks = torch.from_numpy(_tokens(cfg, (2, 12), 5))
    with torch.no_grad():
        lg, caches, length = tsteps.make_prefill_step(cfg, 16)(
            model, {"tokens": toks[:, :11]})
        want, wcaches, wlength = ttr.lm_prefill(model, toks[:, :11], 16)
        assert torch.equal(lg, want) and int(length) == int(wlength) == 11
        lg, _, length = tsteps.make_decode_step(cfg)(
            model, {"token": toks[:, 11:], "caches": caches,
                    "length": length})
        want, _, _ = ttr.lm_decode_step(model, toks[:, 11:], wcaches,
                                        wlength)
        assert torch.equal(lg, want) and int(length) == 12
        params = {n: p.detach() for n, p in model.named_parameters()}
        metrics = tsteps.make_eval_step(cfg)(
            params, {"tokens": toks, "labels": torch.roll(toks, -1, 1)})
        _, wm = ttr.lm_loss(model, toks, torch.roll(toks, -1, 1))
    assert sorted(metrics) == ["aux", "ce"]
    assert torch.equal(metrics["aux"], wm["aux"]) and float(wm["aux"]) > 0
    assert torch.equal(metrics["ce"], wm["ce"])


def test_meta_skeleton_at_full_width_counts_param_count():
    """The published arctic-480b and kimi-k2 build on the ``meta`` device
    (no memory): their parameters are ``param_count`` plus the padded
    vocabulary rows and the norm scales."""
    for name in ("arctic-480b", "kimi-k2-1t-a32b"):
        cfg = get_config(name)
        model = ttr.TransformerLM(cfg, device="meta")
        n = sum(p.numel() for p in model.parameters())
        tables = 1 if cfg.tie_embeddings else 2
        extra = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * tables \
            + (2 * cfg.num_layers + 1) * cfg.d_model
        assert n == cfg.param_count() + extra, name
        assert all(blk.is_moe for blk in model.layers)
