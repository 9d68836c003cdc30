"""Phase-ordering scheduler (``repro/core/scheduler.py``; paper F2, Table 4).

Executing Combination before Aggregation cuts the Aggregation phase's data
by the in/out feature-length ratio (Reddit 602->128: 4.7x).  This module
prices both orderings (``ordering_cost``, ``ordering_time``; Table 4's
ratios, ``reduction_ratios``) and picks the cheaper LEGAL one
(``choose_ordering``): swapping is legal only for linear aggregation and
a single affine combination (``swap_is_legal``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.phases import aggregate_cost, combine_cost
from repro_torch.graph.structure import Graph
from repro_torch.profile.machine import Machine

COMBINE_FIRST = "combine_first"
AGGREGATE_FIRST = "aggregate_first"


@dataclass(frozen=True)
class OrderingCost:
    order: str
    agg_bytes: int
    agg_flops: int
    comb_bytes: int
    comb_flops: int
    halo_bytes_per_remote_edge: int

    @property
    def total_bytes(self) -> int:
        return self.agg_bytes + self.comb_bytes

    @property
    def total_flops(self) -> int:
        return self.agg_flops + self.comb_flops


def ordering_cost(g: Graph, in_len: int, out_len: int, order: str,
                  dtype_bytes: int = 4) -> OrderingCost:
    """Cost of one layer under a given phase ordering (``ordering_cost``,
    :52; paper Table 4 math)."""
    agg_len = out_len if order == COMBINE_FIRST else in_len
    agg = aggregate_cost(g, agg_len, dtype_bytes)
    comb = combine_cost(g.num_vertices, (in_len, out_len), dtype_bytes)
    return OrderingCost(
        order=order,
        agg_bytes=agg["bytes"], agg_flops=agg["flops"],
        comb_bytes=comb["bytes"], comb_flops=comb["flops"],
        halo_bytes_per_remote_edge=agg_len * dtype_bytes)


def ordering_time(oc: OrderingCost, machine: Machine) -> float:
    """Roofline seconds of one layer on ``machine`` (``ordering_time``,
    :69): each phase is max(compute, memory) and the phases serialize."""
    agg = max(oc.agg_flops / machine.peak_flops,
              oc.agg_bytes / machine.hbm_bw)
    comb = max(oc.comb_flops / machine.peak_flops,
               oc.comb_bytes / machine.hbm_bw)
    return agg + comb


def reduction_ratios(g: Graph, in_len: int, out_len: int) -> dict:
    """Paper Table 4's reductions, analytically (``reduction_ratios``,
    :86): the aggregation's bytes and operations aggregate-first over
    combine-first, and both orderings' costs."""
    cf = ordering_cost(g, in_len, out_len, COMBINE_FIRST)
    af = ordering_cost(g, in_len, out_len, AGGREGATE_FIRST)
    return {
        "data_access_reduction": af.agg_bytes / max(1, cf.agg_bytes),
        "computation_reduction": af.agg_flops / max(1, cf.agg_flops),
        "combine_first": cf, "aggregate_first": af,
    }


def swap_is_legal(agg_op: str, n_mlp_layers: int) -> bool:
    """Ordering may be swapped iff both phases commute (``swap_is_legal``,
    :97): sum/mean aggregation and a single affine layer."""
    return agg_op in ("sum", "mean") and n_mlp_layers <= 1


def choose_ordering(g: Graph, in_len: int, out_len: int, agg_op: str = "mean",
                    n_mlp_layers: int = 1,
                    semantic_order: Optional[str] = None,
                    machine: Optional[Machine] = None) -> str:
    """The cheaper legal ordering for one layer (``choose_ordering``,
    :108): ``semantic_order`` when swapping is illegal, else the lower
    ``ordering_time`` on ``machine`` (or, with no machine, fewer bytes)."""
    base = semantic_order or COMBINE_FIRST
    if not swap_is_legal(agg_op, n_mlp_layers):
        return base
    cf = ordering_cost(g, in_len, out_len, COMBINE_FIRST)
    af = ordering_cost(g, in_len, out_len, AGGREGATE_FIRST)
    if machine is not None:
        return COMBINE_FIRST if ordering_time(cf, machine) <= \
            ordering_time(af, machine) else AGGREGATE_FIRST
    return COMBINE_FIRST if cf.total_bytes <= af.total_bytes \
        else AGGREGATE_FIRST
