"""Energy model: joules from roofline terms.

The port's own copy of the reference's cost model (the paper measures
watts with a hardware PMU, §3.3; this models energy the way the roofline
models time):

    E = FLOPs * e_flop + HBM_bytes * e_hbm + link_bytes * e_link + P_idle * t

The profiles are the reference's constants, copied verbatim so that the
port's ``core/scheduler.schedule`` places bricks exactly as the
reference's does: order-of-magnitude numbers for a TPU v5e-class chip
and the paper's RK3566 units (NPU, Mali GPU, Cortex CPU).  None of them
is a reading of the card the port runs on, and a latency or energy this
model gives is a modeled one.  What the model compares is relative
energy between placements and execution modes (monolithic, modular,
cascade), so constant offsets cancel.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EnergyProfile:
    name: str
    e_flop: float          # J per FLOP
    e_hbm: float           # J per HBM byte
    e_link: float          # J per interconnect byte
    p_idle: float          # W while powered
    peak_flops: float
    hbm_bw: float
    link_bw: float


# TPU v5e-class chip (brief constants; energy from ~200W/197TFLOPs class)
TPU_V5E = EnergyProfile("tpu-v5e", e_flop=0.8e-12, e_hbm=15e-12,
                        e_link=10e-12, p_idle=60.0,
                        peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)

# The paper's RK3566-class units (order-of-magnitude edge numbers):
EDGE_NPU = EnergyProfile("rk-npu", e_flop=0.5e-12, e_hbm=80e-12,
                         e_link=100e-12, p_idle=0.15,
                         peak_flops=1.0e12, hbm_bw=8e9, link_bw=4e9)
EDGE_GPU = EnergyProfile("rk-gpu", e_flop=2.0e-12, e_hbm=80e-12,
                         e_link=100e-12, p_idle=0.25,
                         peak_flops=0.5e12, hbm_bw=8e9, link_bw=4e9)
EDGE_CPU = EnergyProfile("rk-cpu", e_flop=20e-12, e_hbm=80e-12,
                         e_link=100e-12, p_idle=0.35,
                         peak_flops=0.05e12, hbm_bw=6e9, link_bw=4e9)


def step_energy(profile: EnergyProfile, flops: float, hbm_bytes: float,
                link_bytes: float, wall_s: float = 0.0) -> float:
    """Joules for one step on one unit."""
    return (flops * profile.e_flop + hbm_bytes * profile.e_hbm
            + link_bytes * profile.e_link + profile.p_idle * wall_s)


def step_time(profile: EnergyProfile, flops: float, hbm_bytes: float,
              link_bytes: float = 0.0) -> float:
    """Roofline step time on one unit (max of the three terms)."""
    return max(flops / profile.peak_flops, hbm_bytes / profile.hbm_bw,
               link_bytes / profile.link_bw if profile.link_bw else 0.0)


def watts(profile: EnergyProfile, flops: float, hbm_bytes: float,
          link_bytes: float = 0.0) -> float:
    """Average power of a unit running this workload back-to-back."""
    t = step_time(profile, flops, hbm_bytes, link_bytes)
    if t == 0:
        return profile.p_idle
    e = step_energy(profile, flops, hbm_bytes, link_bytes, wall_s=t)
    return e / t


def hours_on_battery(avg_watts: float, battery_mah: float = 2000.0,
                     volts: float = 3.7) -> float:
    """The paper's Fig. 8 metric: runtime on a COTS battery pack."""
    wh = battery_mah / 1000.0 * volts
    return wh / max(avg_watts, 1e-9)
