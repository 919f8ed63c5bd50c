"""Spot-instance cost model (paper §IV + §VI-C; counterpart of
``repro/core/cost_model.py``, a copy: the same inputs give equal prices).

    total = (overall_build_time + xfer_time) · cpu_price
          + (Σ accelerator_active_time + xfer_time) · accelerator_price

The CPU machine stays active the whole build (partition + merge + scheduling)
while each accelerator instance is billed only while running shard tasks.
Multiple cards inside one machine are free; multiple machines bill
separately — so the accelerator term sums *active time across machines*.

``paper_example()`` reproduces §VI-C's arithmetic exactly (DiskANN ≥ $67.3 vs
ScaleGANN ≤ $11.1 on Laion100M) and is asserted in tests/benchmarks.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.scheduler import (CPU_MACHINE, V100_ONDEMAND,
                                        V100_SPOT, InstanceType)


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    cpu_hours: float
    accelerator_hours: float
    transfer_hours: float
    cpu_cost: float
    accelerator_cost: float

    @property
    def total(self) -> float:
        return self.cpu_cost + self.accelerator_cost


def transfer_time_s(
    n_shards: int, shard_bytes: float, bandwidth_gbps: float = 10.0
) -> float:
    """Paper §VI-C: each shard task moves ≤ HBM-cap bytes each way; 'number
    of shards × 16GB / network bandwidth' is the stated upper bound."""
    return n_shards * shard_bytes / (bandwidth_gbps * 1e9 / 8)


def scalegann_cost(
    overall_build_s: float,
    accelerator_active_s: float,
    transfer_s: float,
    *,
    cpu: InstanceType = CPU_MACHINE,
    accel: InstanceType = V100_SPOT,
) -> CostBreakdown:
    cpu_h = (overall_build_s + transfer_s) / 3600.0
    acc_h = (accelerator_active_s + transfer_s) / 3600.0
    return CostBreakdown(
        cpu_hours=cpu_h,
        accelerator_hours=acc_h,
        transfer_hours=transfer_s / 3600.0,
        cpu_cost=cpu_h * cpu.price_per_hour,
        accelerator_cost=acc_h * accel.price_per_hour,
    )


def cpu_only_cost(
    overall_build_s: float, *, cpu: InstanceType = CPU_MACHINE,
    price_override: float | None = None,
) -> CostBreakdown:
    """DiskANN-style: one CPU machine active for the whole build."""
    price = price_override if price_override is not None else cpu.price_per_hour
    h = overall_build_s / 3600.0
    return CostBreakdown(
        cpu_hours=h, accelerator_hours=0.0, transfer_hours=0.0,
        cpu_cost=h * price, accelerator_cost=0.0,
    )


def fleet_cost(
    makespan_s: float,
    accelerator_active_s: float,
    n_shards: int,
    shard_bytes: float,
    *,
    cpu: InstanceType = CPU_MACHINE,
    accel: InstanceType = V100_SPOT,
    bandwidth_gbps: float = 10.0,
) -> CostBreakdown:
    """Price one fleet build (real-executor or simulated): the CPU
    coordinator is billed for the whole makespan, accelerators for their
    active time, and the §VI-C shard-transfer bound rides on both — the
    calibrated reporting path ``repro_torch.fleet`` uses for
    spot-vs-on-demand comparisons."""
    xfer = transfer_time_s(n_shards, shard_bytes, bandwidth_gbps)
    return scalegann_cost(
        makespan_s, accelerator_active_s, xfer, cpu=cpu, accel=accel
    )


def paper_example() -> dict:
    """§VI-C worked example, Laion100M (R=64, L=128):

    * DiskANN overall 62109 s = 17.25 h on a ≥$3.9/h CPU machine → ≥ $67.3.
    * ScaleGANN: 4-V100 build-only 2003 s = 0.56 h (Table VII), partition+
      merge = overall − build-only = 11259 − 6504 = 4755 s = 1.32 h,
      < 100 shards × 16 GB / 10 Gbps ≤ 160 s = 0.045 h transfer.
      cost ≤ (1.88 + 0.045)·$4.6 + (0.56 + 0.045)·$3.67 = $11.1 → ~6× cheaper.
    """
    diskann_overall_h = 62109 / 3600.0
    diskann = cpu_only_cost(62109, price_override=3.9)
    xfer_s = transfer_time_s(100, 16e9)  # 128 s ≤ paper's 160 s bound
    xfer_h_paper = 0.045  # the paper rounds to 0.045 h; use their figure
    pm_h = (11259 - 6504) / 3600.0
    build_h = 2003 / 3600.0
    overall_h = build_h + pm_h
    cpu_cost = (overall_h + xfer_h_paper) * 4.6
    acc_cost = (build_h + xfer_h_paper) * V100_SPOT.price_per_hour
    return {
        "diskann_overall_h": diskann_overall_h,
        "diskann_cost": diskann.total,
        "scalegann_overall_h": overall_h,
        "scalegann_cost": cpu_cost + acc_cost,
        "transfer_s_bound": xfer_s,
        "speedup_cost": diskann.total / (cpu_cost + acc_cost),
        "ondemand_note": (
            "even on-demand GPU beats CPU here: "
            f"{(overall_h + xfer_h_paper) * 4.6 + (build_h + xfer_h_paper) * V100_ONDEMAND.price_per_hour:.1f} "
            "USD < DiskANN"
        ),
    }
