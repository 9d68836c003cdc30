"""Machine: one dataclass describing the hardware a cost model targets.

A copy of ``Machine``, its five presets and ``get_machine`` from
``repro/profile/machine.py`` (:51-219), and of the two priced decisions of
``build_plan``: the execution dtype (``dtype_model`` / ``choose_dtype``,
:244-337) and pair dedup (``dedup_model`` / ``choose_dedup``, :340-413).
The port's default machine is ``H100`` (the card it runs on); the
reference's ``machine_for_backend``, which maps its GPU tier to ``A100``,
is deliberately not carried over, so a ``machine=None`` here prices on
``H100`` where the reference's functions default to ``TPU_V5E``.

Presets::

    TPU_V5E   197 TFLOP/s bf16, 819 GB/s HBM, 4x50 GB/s ICI, 128 MiB VMEM
    TPU_V5P   459 TFLOP/s bf16, 2765 GB/s HBM2e, 6x100 GB/s ICI
    A100      312 TFLOP/s bf16, 1555 GB/s HBM, 12x25 GB/s NVLink
    H100      989 TFLOP/s bf16, 3350 GB/s HBM3, 18x25 GB/s NVLink 4,
              228 KiB SMEM/L1 carveout per SM
    V100      15.7 TFLOP/s fp32, 900 GB/s HBM -- the paper's machine
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Machine:
    """Hardware description consumed by the planner's cost models.

    Attributes:
      name: registry key ("tpu-v5e" | "a100" | "h100" | "v100" | ...).
      kind: accelerator family, "tpu" | "gpu" (selects the occupancy model
        ``suggest_tile_m`` applies).
      peak_flops: peak matmul FLOP/s at the native precision.
      hbm_bw: HBM bandwidth, bytes/s.
      interconnect_bw: per-link chip interconnect bandwidth, bytes/s.
      interconnect_links: number of such links per chip.
      on_chip_bytes: the fast scratch a fused tile must fit -- whole VMEM
        on TPU, the unified SMEM/L1 carveout per SM on GPU.
      link_latency_s: per-message latency of one interconnect hop.
      regfile_bytes: register file per SM (0 on TPU).
      target_ctas: resident CTAs per SM needed to hide HBM latency (0 on
        TPU).
      row_align: natural row granularity of a tile (8 on TPU, 32 on GPU).
      matrix_tile: systolic/tensor tile edge for pad-waste accounting.
      native_bf16: whether the matmul units run bf16 at ``peak_flops``.
    """

    name: str
    kind: str
    peak_flops: float
    hbm_bw: float
    interconnect_bw: float
    interconnect_links: int
    on_chip_bytes: int
    link_latency_s: float = 1e-6
    regfile_bytes: int = 0
    target_ctas: int = 0
    row_align: int = 8
    matrix_tile: int = 128
    native_bf16: bool = True

    def __post_init__(self):
        if self.kind not in ("tpu", "gpu"):
            raise ValueError(f"Machine.kind must be 'tpu' or 'gpu', "
                             f"got {self.kind!r}")

    @property
    def balance(self) -> float:
        """FLOPs per HBM byte at which compute and memory time are equal."""
        return self.peak_flops / self.hbm_bw

    @property
    def interconnect_total(self) -> float:
        """Aggregate interconnect bandwidth (all links), bytes/s."""
        return self.interconnect_bw * self.interconnect_links

    def hop_time(self, nbytes: float) -> float:
        """Seconds for one interconnect hop moving ``nbytes`` over a single
        link (``hop_time``, :113): ``link_latency_s + nbytes /
        interconnect_bw``."""
        return self.link_latency_s + nbytes / self.interconnect_bw

    def tile_budget(self) -> int:
        """On-chip bytes one fused tile may claim: half of VMEM on TPU, an
        SM-carveout share per resident CTA on GPU."""
        if self.kind == "gpu":
            return self.on_chip_bytes // max(1, self.target_ctas)
        return self.on_chip_bytes // 2

    def classify(self, arithmetic_intensity: float) -> str:
        """"memory" | "compute" bound classification against this balance."""
        return "memory" if arithmetic_intensity < self.balance else "compute"

    def matmul_peak(self, dtype: str = "f32") -> float:
        """Effective matmul FLOP/s at ``dtype`` on this machine."""
        if dtype == "bf16":
            return self.peak_flops if self.native_bf16 \
                else self.peak_flops / 2
        return self.peak_flops / 2 if self.native_bf16 else self.peak_flops


TPU_V5E = Machine(
    name="tpu-v5e", kind="tpu",
    peak_flops=197e12, hbm_bw=819e9,
    interconnect_bw=50e9, interconnect_links=4,
    on_chip_bytes=128 * 1024 * 1024,
    link_latency_s=1e-6,
    row_align=8, matrix_tile=128)

TPU_V5P = Machine(
    name="tpu-v5p", kind="tpu",
    peak_flops=459e12, hbm_bw=2765e9,
    interconnect_bw=100e9, interconnect_links=6,
    on_chip_bytes=128 * 1024 * 1024,
    link_latency_s=1e-6,
    row_align=8, matrix_tile=128)

A100 = Machine(
    name="a100", kind="gpu",
    peak_flops=312e12, hbm_bw=1555e9,
    interconnect_bw=25e9, interconnect_links=12,
    link_latency_s=2e-6,
    on_chip_bytes=192 * 1024,
    regfile_bytes=256 * 1024, target_ctas=4,
    row_align=32, matrix_tile=16)

H100 = Machine(
    name="h100", kind="gpu",
    peak_flops=989e12, hbm_bw=3350e9,
    interconnect_bw=25e9, interconnect_links=18,
    link_latency_s=2e-6,
    on_chip_bytes=228 * 1024,
    regfile_bytes=256 * 1024, target_ctas=4,
    row_align=32, matrix_tile=16)

V100 = Machine(
    name="v100", kind="gpu",
    peak_flops=15.7e12, hbm_bw=900e9,
    interconnect_bw=25e9, interconnect_links=6,
    link_latency_s=2e-6,
    on_chip_bytes=128 * 1024,
    regfile_bytes=256 * 1024, target_ctas=4,
    row_align=32, matrix_tile=16,
    native_bf16=False)

MACHINES: Dict[str, Machine] = {m.name: m
                                for m in (TPU_V5E, TPU_V5P, A100, H100, V100)}

#: the machine every port cost model prices against unless told otherwise
DEFAULT_MACHINE = H100


def get_machine(name_or_machine) -> Machine:
    """Resolve a registry name (or pass a Machine through) to a Machine;
    ``None`` resolves to ``DEFAULT_MACHINE``."""
    if name_or_machine is None:
        return DEFAULT_MACHINE
    if isinstance(name_or_machine, Machine):
        return name_or_machine
    try:
        return MACHINES[name_or_machine]
    except KeyError:
        raise ValueError(f"unknown machine {name_or_machine!r}; "
                         f"known: {sorted(MACHINES)}") from None


# --------------------------------------------------------------------------
# Execution dtype as a priced decision (build_plan(dtype="auto"))
# --------------------------------------------------------------------------

#: storage bytes per element at each plan dtype; ``int8-agg`` is the width
#: of the aggregation operand only (combination stays f32)
DTYPE_BYTES: Dict[str, int] = {"f32": 4, "bf16": 2, "int8-agg": 1}

#: least modeled fractional saving before ``choose_dtype`` leaves f32
DTYPE_SAVING_THRESHOLD = 0.05


def dtype_model(num_vertices: int, num_edges: int, feature_len: int,
                out_len: Optional[int] = None, *,
                machine: Machine = None, num_shards: int = 1,
                dtypes=("f32", "bf16")) -> Dict[str, Dict[str, float]]:
    """Modeled time of one layer at each candidate dtype (``dtype_model``,
    :247): the aggregation's HBM bytes (E gathered rows, V rows read and
    written, 8-byte edge indices) at the dtype's width, the combination's
    FLOPs at ``matmul_peak(dtype)`` against its bytes, the ring halo's
    hops when sharded, and the rows of ``feature_len`` one tile budget
    holds.  Returns ``{dtype: {"agg_s", "combine_s", "halo_s", "total_s",
    "tile_rows"}}``."""
    machine = get_machine(machine)
    out_len = feature_len if out_len is None else out_len
    v, e, f = float(num_vertices), float(num_edges), float(feature_len)
    out = {}
    for dt in dtypes:
        b = float(DTYPE_BYTES[dt])
        comb_b = 4.0 if dt == "int8-agg" else b
        agg_s = ((e + 2.0 * v) * f * b + e * 8.0) / machine.hbm_bw
        flops = 2.0 * v * f * out_len
        comb_bytes = v * (f + out_len) * comb_b + f * out_len * comb_b
        comb_s = max(flops / machine.matmul_peak(dt),
                     comb_bytes / machine.hbm_bw)
        halo_s = 0.0
        if num_shards > 1:
            block = -(-num_vertices // num_shards)
            halo_s = (num_shards - 1) * machine.hop_time(block * f * b)
        out[dt] = {"agg_s": agg_s, "combine_s": comb_s, "halo_s": halo_s,
                   "total_s": agg_s + comb_s + halo_s,
                   "tile_rows": float(machine.tile_budget() //
                                      max(1, int(f * b)))}
    return out


def choose_dtype(num_vertices: int, num_edges: int, feature_len: int,
                 out_len: Optional[int] = None, *,
                 machine: Machine = None, num_shards: int = 1) -> str:
    """Resolve ``build_plan(dtype="auto")`` to "f32" or "bf16"
    (``choose_dtype``, :299): bf16 when ``dtype_model`` prices it at least
    ``DTYPE_SAVING_THRESHOLD`` below f32.  "int8-agg" is never chosen.

    >>> choose_dtype(256, 1024, 128, machine=V100)
    'f32'
    >>> choose_dtype(256, 1024, 128, machine=TPU_V5E)
    'bf16'
    """
    model = dtype_model(num_vertices, num_edges, feature_len, out_len,
                        machine=machine, num_shards=num_shards,
                        dtypes=("f32", "bf16"))
    f32_s, bf16_s = model["f32"]["total_s"], model["bf16"]["total_s"]
    if f32_s <= 0:
        return "f32"
    return "bf16" if (f32_s - bf16_s) / f32_s >= DTYPE_SAVING_THRESHOLD \
        else "f32"


# --------------------------------------------------------------------------
# Pair-redundancy elimination as a priced decision (build_plan(dedup="auto"))
# --------------------------------------------------------------------------

#: least modeled fractional aggregation saving before ``choose_dedup``
#: leaves the naive layout
DEDUP_SAVING_THRESHOLD = 0.05


def dedup_model(num_vertices: int, num_edges: int, feature_len: int, *,
                num_pairs: int, num_edges2: int,
                machine: Machine = None,
                dtype: str = "f32") -> Dict[str, Dict[str, float]]:
    """The aggregation naive against two-level dedup (``dedup_model``,
    :343), both as HBM bytes over ``machine.hbm_bw`` at the dtype's width:
    naive ``(E + 2V) F B + 8E``; pairs ``(E2 + 3P + 2V) F B + 8 E2 + 8P``.
    Returns ``{"none": {...}, "pairs": {...}}`` with ``agg_bytes``,
    ``agg_s``, ``flops`` and ``saving`` (fraction of the naive time)."""
    machine = get_machine(machine)
    b = float(DTYPE_BYTES.get(dtype, 4))
    v, e, f = float(num_vertices), float(num_edges), float(feature_len)
    p, e2 = float(num_pairs), float(num_edges2)
    naive_bytes = (e + 2.0 * v) * f * b + e * 8.0
    dedup_bytes = (e2 + 3.0 * p + 2.0 * v) * f * b + e2 * 8.0 + 2.0 * p * 4.0
    naive_s = naive_bytes / machine.hbm_bw
    dedup_s = dedup_bytes / machine.hbm_bw
    saving = (naive_s - dedup_s) / naive_s if naive_s > 0 else 0.0
    return {
        "none": {"agg_bytes": naive_bytes, "agg_s": naive_s,
                 "flops": (e + v) * f, "saving": 0.0},
        "pairs": {"agg_bytes": dedup_bytes, "agg_s": dedup_s,
                  "flops": (p + e2 + v) * f, "saving": saving},
    }


def choose_dedup(num_vertices: int, num_edges: int, feature_len: int, *,
                 num_pairs: int, num_edges2: int,
                 machine: Machine = None, dtype: str = "f32") -> str:
    """Resolve ``build_plan(dedup="auto")`` to "none" or "pairs"
    (``choose_dedup``, :385): "pairs" when ``dedup_model`` saves at least
    ``DEDUP_SAVING_THRESHOLD`` of the naive aggregation time.

    >>> choose_dedup(96, 128, 128, num_pairs=8, num_edges2=80,
    ...              machine=TPU_V5E)
    'pairs'
    >>> choose_dedup(96, 128, 128, num_pairs=2, num_edges2=126,
    ...              machine=TPU_V5E)
    'none'
    """
    if num_pairs <= 0:
        return "none"
    model = dedup_model(num_vertices, num_edges, feature_len,
                        num_pairs=num_pairs, num_edges2=num_edges2,
                        machine=machine, dtype=dtype)
    return "pairs" if model["pairs"]["saving"] >= DEDUP_SAVING_THRESHOLD \
        else "none"
