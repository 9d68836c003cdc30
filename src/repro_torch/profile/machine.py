"""Machine: one dataclass describing the hardware a cost model targets.

A copy of ``Machine``, its five presets and ``get_machine`` from
``repro/profile/machine.py`` (:51-219).  The port's default machine is
``H100`` (the card it runs on); the reference's ``machine_for_backend``,
which maps its GPU tier to ``A100``, is deliberately not carried over.

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
from typing import Dict


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
