"""Roofline terms and the paper's Table-3 phase report
(``repro/core/characterize.py``, :107-116 and :157-265).

  * ``StepCost`` -- FLOPs and device-memory bytes of one step (and its
    collective bytes, 0 on one card);
  * ``Roofline`` / ``roofline`` -- the three terms (compute, memory,
    collective) of a step against one ``Machine``;
  * ``phase_report`` -- each phase's arithmetic intensity classified
    against the paper's V100 balance and against a ``Machine``;
  * ``collective_bytes`` -- the bytes a distributed plan's collectives
    moved, per shard.  The reference sums operand bytes of the
    collectives in compiled XLA HLO (:59); the port counts them in its
    own collectives (``core.distributed.Mesh``), under the same keys.

  * ``shape_bytes``, ``cost_from_compiled`` and ``cost_of`` -- a step's
    ``StepCost``: the reference lowers and compiles the step and reads
    its HLO; the port traces it (on fake tensors, where its arguments are
    fake) and counts its ops (``core/op_cost.py``, the counterpart of
    ``repro/core/hlo_cost.py``).

The default machine is ``H100``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.profile.machine import H100, V100, Machine


@dataclass
class StepCost:
    flops: float
    hbm_bytes: float
    collective: Dict[str, int] = field(default_factory=dict)
    peak_memory_per_device: Optional[float] = None
    output_bytes: Optional[float] = None

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1.0, self.hbm_bytes)


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    chips: int
    flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops: float = 0.0
    machine: Machine = H100

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def step_time_s(self) -> float:
        """Lower bound on step time: the largest term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time over the bound step time; ``model_flops``
        (per device) counts as the useful work when given."""
        useful = self.model_flops or self.flops
        ideal = useful / self.machine.peak_flops
        return ideal / max(self.step_time_s, 1e-30)

    @property
    def mfu(self) -> float:
        return self.roofline_fraction

    def row(self) -> Dict[str, Any]:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": (self.model_flops / self.flops) if self.flops else 0,
            "roofline_fraction": self.roofline_fraction,
            "machine": self.machine.name,
        }


#: bytes an element of each dtype name takes (the reference's HLO names)
_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "s32": 4,
                "s16": 2, "s8": 1, "u8": 1, "pred": 1}


def shape_bytes(tok_dtype: str, tok_dims: str) -> int:
    """Bytes of a ``dtype[dims]`` shape (``shape_bytes``, :51): dims a
    comma list, empty for a scalar."""
    n = 1
    for d in tok_dims.split(","):
        if d.strip():
            n *= int(d)
    return n * _DTYPE_BYTES[tok_dtype]


def cost_from_compiled(record) -> StepCost:
    """A step's ``StepCost`` from its trace record (``core/op_cost.py::
    OpCost``; the reference's ``cost_from_compiled``, :119, reads a
    compiled executable): FLOPs, bytes accessed, collective bytes by kind
    with their ``"total"``, and the peak live bytes."""
    coll = {k: int(v) for k, v in record.collectives.items()}
    coll["total"] = int(record.collective_bytes)
    return StepCost(flops=record.flops, hbm_bytes=record.bytes_accessed,
                    collective=coll,
                    peak_memory_per_device=float(record.peak_bytes))


def cost_of(fn, *args, fake_mode=None, **kwargs) -> StepCost:
    """Trace ``fn(*args)`` and count it (``cost_of``, :144, which lowers
    and compiles): args may be fake tensors (``fake_mode``, detected from
    them when not given) or DTensors of them, so nothing is allocated and
    no kernel launches."""
    from torch._guards import detect_fake_mode
    from torch.utils._pytree import tree_flatten

    from repro_torch.core import op_cost
    leaves = [a for a in tree_flatten((args, kwargs))[0]
              if hasattr(a, "shape")]
    local = [a.to_local() if hasattr(a, "to_local") else a for a in leaves]
    fake_mode = fake_mode or detect_fake_mode(local)
    _, rec = op_cost.count(fn, *args, fake_mode=fake_mode, inputs=leaves,
                           **kwargs)
    return cost_from_compiled(rec)


def collective_bytes(mesh) -> Dict[str, Any]:
    """``{collective: bytes, ..., "total": bytes, "counts": {collective:
    calls}}`` one shard's collectives moved since ``mesh.reset_counts()``
    (``collective_bytes``, :59): the operand each takes in, counted by the
    mesh (``core.distributed.Mesh.collective_bytes``), keyed by the
    reference's HLO names ("all-gather", "reduce-scatter",
    "collective-permute", ...).  A plan's layer moves what
    ``core.distributed.schedule_wire_bytes`` prices for it."""
    return mesh.collective_bytes()


def roofline(cost: StepCost, chips: int, model_flops: float = 0.0,
             machine: Machine = H100) -> Roofline:
    """Three-term roofline against one ``Machine`` (``roofline``, :211).

    ``cost`` is per device; ``model_flops`` is the global useful work and
    is divided by ``chips``.
    """
    flops = cost.flops
    byt = cost.hbm_bytes
    coll = float(cost.collective.get("total", 0))
    return Roofline(
        compute_s=flops / machine.peak_flops,
        memory_s=byt / machine.hbm_bw,
        collective_s=coll / machine.interconnect_total,
        chips=chips, flops=flops, hbm_bytes=byt, collective_bytes=coll,
        model_flops=model_flops / max(chips, 1), machine=machine)


def phase_report(agg_cost: dict, comb_cost: dict,
                 machine: Machine = H100) -> Dict[str, Any]:
    """Classify each phase against a machine balance (Table 3;
    ``phase_report``, :242).

    Each phase is classified twice: against the paper's V100 balance
    (``"bound"``, Table 3 as published) and against ``machine``
    (``"bound_machine"``).  The reference's deprecated TPU aliases
    (``bound_v5e``, ``machine_balance_v5e``) are left out.
    """
    def classify(c):
        ai = c["arithmetic_intensity"]
        return {
            "arithmetic_intensity": ai,
            "bound": V100.classify(ai),
            "bound_machine": machine.classify(ai),
            "bytes": c["bytes"], "flops": c["flops"],
            # the paper's "DRAM bytes per operation"
            "bytes_per_op": c["bytes"] / max(1, c["flops"]),
        }
    return {"aggregation": classify(agg_cost),
            "combination": classify(comb_cost),
            "machine": machine.name,
            "machine_balance": machine.balance,
            "machine_balance_v100": V100.balance}
