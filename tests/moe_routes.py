"""The route rule of the MoE stack tests (``tests/test_torch_moe.py``,
``tests/test_torch_mamba2.py``): the router probabilities of every MoE
layer call on both sides, and which positions' logits are comparable."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as jtr
from repro_torch.models import moe

#: the route rule's near tie in f32: both sides' router inputs agree to
#: ~1e-6 relative, their probabilities (~1/E) to ~1e-7; a gap under 1e-5
#: can flip, a larger one cannot
TIE_GAP = 1e-5


class Routes:
    """Every MoE layer call's router probabilities, in call order, on both
    sides: a global forward hook that reads each port ``MoE`` call (also
    inside ``make_train_step``'s ``functional_call`` on its skeleton), and
    a wrapper of the reference's ``moe_ffn`` (monkeypatched into its
    transformer module) whose ``jax.debug.callback`` hands them back."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        self.handle = torch.nn.modules.module.register_module_forward_hook(
            self._hook)
        orig = jtr.moe_ffn

        def wrapped(params, x, cfg, activation, dropless=False):
            xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
            probs = jax.nn.softmax(xf @ params["router"]["w"], axis=-1)
            jax.debug.callback(
                lambda p: self.ref.append(np.asarray(p)), probs,
                ordered=True)
            return orig(params, x, cfg, activation, dropless)
        monkeypatch.setattr(jtr, "moe_ffn", wrapped)

    def _hook(self, mod, args, out):
        if not isinstance(mod, moe.MoE):
            return
        x = args[0]
        with torch.no_grad():
            probs = moe.route(mod.router, x.reshape(-1, x.shape[-1]),
                              mod.cfg.top_k)[0]
        self.port.append(probs.float().numpy())

    def comparable(self, k: int, b: int, calls):
        """The route rule over the calls so far.  ``calls``: per call of a
        stack ``(positions, layers)`` -- its rows are ``b`` sequences x
        ``positions`` (a list of position indices), run through ``layers``
        MoE layers in order.  A route that differs with no differing route
        upstream of it (at an earlier layer, at or before its position in
        its sequence: attention carries a flip forward, and the capacity
        ranks tokens in order) must be a near tie.  Returns (mask (b,
        positions) of the positions before a sequence's first differing
        route, share of (layer, token) routes that differ)."""
        jax.effects_barrier()
        n_pos = max(max(p) for p, _ in calls) + 1
        layers = max(n for _, n in calls)
        differ = np.zeros((layers, b, n_pos), bool)
        gaps = np.ones((layers, b, n_pos))
        assert len(self.port) == len(self.ref) == sum(n for _, n in calls)
        i = 0
        for positions, n in calls:
            for layer in range(n):
                p, r = self.port[i], self.ref[i]
                i += 1
                top = np.sort(p, -1)[:, ::-1]
                sets = [np.sort(np.argsort(-q, -1, kind="stable")[:, :k], -1)
                        for q in (p, r)]
                differ[layer][:, positions] = np.any(
                    sets[0] != sets[1], -1).reshape(b, len(positions))
                gaps[layer][:, positions] = (top[:, k - 1] - top[:, k]
                                             ).reshape(b, len(positions))
        upstream = np.zeros((b, n_pos), bool)
        for layer in range(layers):
            primary = differ[layer] & ~upstream
            assert np.all(gaps[layer][primary] < TIE_GAP), \
                gaps[layer][primary]
            upstream |= np.logical_or.accumulate(differ[layer], axis=1)
        return ~upstream, (differ.mean() if differ.size else 0.0)

    def close(self):
        self.handle.remove()
