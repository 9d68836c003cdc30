"""Per-device cost of a traced step: the port's counterpart of
``repro/core/hlo_cost.py``.

The reference walks compiled HLO text: FLOPs of dots and convolutions
(``dot_flops``) and one per result element elsewhere, bytes by its
fused-execution model, collectives by result-shape bytes, each ``while``
body scaled by its trip count.  PyTorch has no HLO.  The port counts the
step as it runs -- on fake tensors (``FakeTensorMode``) in the dry run, so
nothing is allocated and no kernel launches -- with a dispatch mode over
the ops each rank runs:

  * ``dot_flops``: the products, by ``torch.utils.flop_counter``'s
    formulas (mm, bmm, addmm, baddbmm, convolution, ...) and K5's
    (``kernels/flash_attention.py::flops_fwd`` / ``flops_bwd``, registered
    on its ops); ``flops`` adds one a result element for every other op
    that computes (the reference's generic elementwise term), and
    ``transcendentals`` counts exp, log, tanh, rsqrt, ... elements;
  * ``bytes_accessed``: each op that computes reads its tensor inputs and
    writes its outputs once -- the reference's byte model for an unfused
    op (PyTorch eager runs unfused, but K5, whose op moves only q, k, v
    and its outputs);
  * ``collectives``: the ``_c10d_functional`` ops that DTensor issues when
    it redistributes (all-gather, all-reduce, reduce-scatter, all-to-all),
    priced by result-shape bytes, under the reference's HLO names;
  * ``peak_bytes``: the most bytes of local tensors alive at once (the
    step's inputs counted from the start), one storage counted once.

A DTensor op is not counted itself: the mode declines it, DTensor runs the
rank's local ops, and those are counted -- per-device numbers, as the
reference's per-device HLO.  Ops that DTensor's sharding propagation runs
on global-shaped fake tensors are skipped (the mode wraps
``ShardingPropagator._propagate_tensor_meta_non_cached`` while it is
active, and fake tensors of another fake mode are not counted).  The layers
are a Python loop, so every layer's ops are seen: no trip-count logic is
needed where the reference's scans need it.
"""

from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}

_TRANSCENDENTAL = {"exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sigmoid",
                   "sin", "cos", "erf", "log_softmax", "_log_softmax",
                   "_softmax", "softmax", "silu", "gelu"}

#: ops that move or compute nothing (metadata, allocation, views)
_FREE = {"detach", "empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "device", "wait_tensor", "lift_fresh",
         "_local_scalar_dense", "set_", "is_same_size", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "dim", "size",
         "stride", "numel"}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class OpCost:
    """Per-device totals of one traced step (``HloCost``'s fields, and the
    step's peak live bytes), with one row per (op, shapes)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    transcendentals: float = 0.0
    dot_flops: float = 0.0
    peak_bytes: int = 0
    #: (op name, input shapes) -> [calls, flops, bytes]
    by_op: Dict[Tuple[str, str], list] = field(default_factory=dict)
    counts: Counter = field(default_factory=Counter)


def _op_name(func) -> Tuple[str, str]:
    """(namespace, name) of an OpOverload."""
    packet = func.overloadpacket
    ns = getattr(packet, "__module__", "").rsplit(".", 1)[-1]
    return ns, packet.__name__


def _shapes(tensors) -> str:
    return ",".join(f"{str(t.dtype).removeprefix('torch.')}"
                    f"{list(t.shape)}" for t in tensors)


class CostMode(TorchDispatchMode):
    """Counts the local ops of a step (see the module's docstring).
    ``fake_mode`` is the ``FakeTensorMode`` the step runs under (None for
    real tensors): fake tensors of another mode are DTensor's propagation
    and are skipped."""

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flops = flop_registry
        self.fake_mode = fake_mode
        self.cost = OpCost()
        self._live = 0
        self._skip = 0
        self._seen = weakref.WeakSet()

    # -- live bytes -------------------------------------------------------

    def _free(self, n: int) -> None:
        self._live -= n

    def track(self, *tensors) -> None:
        """Count ``tensors``' storages as live (the step's inputs)."""
        for t in tensors:
            if isinstance(t, self._dtensor):
                t = t.to_local()
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self._live += n
            weakref.finalize(st, self._free, n)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    # -- dispatch ---------------------------------------------------------

    def __enter__(self):
        # DTensor derives each output's global shape by running the op on
        # global-shaped fake tensors of the current fake mode: not a
        # rank's work, so the mode looks away while it does
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        cls = ShardingPropagator
        self._orig = cls.__dict__["_propagate_tensor_meta_non_cached"]
        mode = self

        def propagate(prop, op_schema):
            mode._skip += 1
            try:
                return mode._orig(prop, op_schema)
            finally:
                mode._skip -= 1
        cls._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._orig
        return super().__exit__(*exc)

    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode is not
                   self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        if self._skip or self._foreign(ins):
            return out
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        ns, name = _op_name(func)
        if name in _FREE or ns == "prim" or func.is_view:
            self.track(*outs)
            return out
        c = self.cost
        out_bytes = sum(tensor_bytes(o) for o in outs)
        kind = _COLLECTIVE_OPS.get(name) if "c10d" in ns or \
            ns == "_dtensor" else None
        key = (f"{ns}.{name}", _shapes(ins))
        row = c.by_op.setdefault(key, [0, 0.0, 0.0])
        row[0] += 1
        c.counts[f"{ns}.{name}"] += 1
        if kind is not None:
            c.collectives[kind] = c.collectives.get(kind, 0.0) + out_bytes
            c.collective_bytes += out_bytes
            self.track(*outs)
            return out
        moved = sum(tensor_bytes(t) for t in ins) + out_bytes
        c.bytes_accessed += moved
        row[2] += moved
        packet = func.overloadpacket
        if packet in self._flops:
            f = float(self._flops[packet](*args, **kwargs, out_val=out))
            c.dot_flops += f
        else:
            f = float(sum(o.numel() for o in outs))
            if name.rstrip("_") in _TRANSCENDENTAL:
                c.transcendentals += f
        c.flops += f
        row[1] += f
        self.track(*outs)
        return out


def count(fn, *args, fake_mode=None, inputs=(), **kwargs
          ) -> Tuple[Any, OpCost]:
    """``fn(*args, **kwargs)`` under a ``CostMode``: (its result, the
    per-device ``OpCost``).  ``inputs`` are tensors (or DTensors) alive
    before the step (its state and batch), counted into the peak."""
    mode = CostMode(fake_mode)
    with mode:
        mode.track(*inputs)
        out = fn(*args, **kwargs)
    return out, mode.cost


def top_ops(cost: OpCost, by: str = "bytes", top: int = 20):
    """The ``top`` (op, shapes) rows by ``"bytes"`` or ``"flops"``:
    ``[(value, calls, op, shapes), ...]`` largest first."""
    i = {"flops": 1, "bytes": 2}[by]
    rows = [(v[i], v[0], op, shp) for (op, shp), v in cost.by_op.items()
            if v[i]]
    return sorted(rows, reverse=True)[:top]
