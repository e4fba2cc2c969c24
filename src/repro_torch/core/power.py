"""The port's own copy of the reference's module.

Battery-aware execution (paper §3.2 "Power-efficiency Strategy").

The three-state PMU-driven policy, verbatim from the paper:

  (i)   Unconstrained Performance  (B > T_high): full capacity, aggressive
        parallel offloading.
  (ii)  Proportional Throttling    (T_low < B <= T_high): graceful
        degradation with alpha = (B - T_low) / (T_high - T_low) linearly
        interpolating camera frame rate and memory read/write rate.
  (iii) Critical Conservation      (B <= T_low): switch to the On-Demand
        Cascade (sequential load->execute->release, core/cascade.py).

"Camera FPS / memory clocks" become the serving knobs the engine has —
admission rate, max batch, staging depth and KV shares — scaled by the
same alpha.  The PMU is simulated: callers drain it with modeled joules.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class PowerState(enum.Enum):
    UNCONSTRAINED = "unconstrained"
    THROTTLED = "throttled"
    CRITICAL = "critical"


@dataclass
class PMU:
    """Simulated power-management unit: integrates modeled joules into a
    battery state-of-charge, the signal the policy arbitrates on."""

    battery_mah: float = 2000.0
    volts: float = 3.7
    level: float = 1.0                       # state of charge, 0..1
    history: List[Tuple[float, float]] = field(default_factory=list)
    _t: float = 0.0

    @property
    def capacity_j(self) -> float:
        return self.battery_mah / 1000.0 * self.volts * 3600.0

    def drain(self, joules: float, dt: float = 0.0):
        self.level = max(0.0, self.level - joules / self.capacity_j)
        self._t += dt
        self.history.append((self._t, joules / max(dt, 1e-9) if dt else 0.0))

    def sample_watts(self) -> float:
        return self.history[-1][1] if self.history else 0.0


@dataclass(frozen=True)
class Knobs:
    """Execution knobs one policy state implies."""
    max_batch: int
    admission_rate: float        # fraction of offered requests admitted
    frame_rate_hz: float         # camera-equivalent input rate
    mem_clock_scale: float       # paper's memory read/write rate scale
    submesh_width: float         # fraction of the pod's "model" axis to use
    cascade: bool                # critical mode: one-shot sequential
    # re-lowering hook: backend registry name (core/backends) the holder of
    # an ExecutionPlan should relower static-shape (encoder-side) bricks
    # to, or None to keep/restore the compiled placement.  Deep THROTTLED
    # demotes to the transient HostBackend — encoder weights leave the
    # accelerator between events, trading latency for resident memory and
    # accelerator energy exactly like the paper's proportional throttling
    # of the camera/memory path.  The engine applies it via plan.relower().
    backend_demotion: Optional[str] = None
    # class-partitioned TABM admission hook: scale factor for per-class
    # staged-ahead depth (core/tabm.SlotClassPool.admission_table).
    # THROTTLED shrinks the *high-resolution* classes' depth first (the
    # largest slab scales fully by this factor, the thumbnail class keeps
    # full depth), so expensive multi-image vision staging is the first
    # load shed while cheap requests keep flowing; CRITICAL gates the
    # large classes entirely (scale 0).  Restored to 1.0 when charge
    # recovers — mirrors backend_demotion.
    class_depth_scale: float = 1.0
    # batched-staging hook: how many same-class requests the engine may
    # hand a class's producer thread as ONE microbatch (one batched
    # projector call + one strided slab commit).  Scaled down FIRST under
    # THROTTLED — losing batch amortization costs energy-per-stage but
    # keeps every class's staging depth, so the pipeline degrades to
    # one-at-a-time staging before it starts shedding whole classes
    # (class_depth_scale): batch is floored at 1 by alpha = 0.5 while the
    # depth scale is still at 0.5.  CRITICAL stages strictly one request
    # at a time.
    max_stage_batch: int = 1
    # paged-KV admission hook: scale factor for per-class KV *block*
    # budgets (core/scheduler.kv_block_budgets over the engine's
    # PagedKVCache).  Same high-resolution-first shed order as
    # class_depth_scale (core/slot_classes.shed_scales): under THROTTLED
    # the hi-res classes' share of the paged decode pool shrinks first,
    # so expensive long-context KV grants are shed while thumbnail
    # requests keep admitting; CRITICAL zeroes the large classes' share.
    class_kv_scale: float = 1.0


@dataclass
class PowerPolicy:
    t_high: float = 0.60
    t_low: float = 0.20
    full_batch: int = 128
    full_fps: float = 30.0
    full_stage_batch: int = 4          # staging microbatch at full charge

    def state(self, battery: float) -> PowerState:
        if battery > self.t_high:
            return PowerState.UNCONSTRAINED
        if battery > self.t_low:
            return PowerState.THROTTLED
        return PowerState.CRITICAL

    def alpha(self, battery: float) -> float:
        """The paper's scaling factor, clamped to [0, 1]."""
        a = (battery - self.t_low) / (self.t_high - self.t_low)
        return min(1.0, max(0.0, a))

    def knobs(self, battery: float) -> Knobs:
        st = self.state(battery)
        if st is PowerState.UNCONSTRAINED:
            return Knobs(self.full_batch, 1.0, self.full_fps, 1.0, 1.0,
                         cascade=False,
                         max_stage_batch=self.full_stage_batch)
        if st is PowerState.THROTTLED:
            a = self.alpha(battery)
            # batch shrinks BEFORE depth sheds: the stage microbatch
            # scales by (2a - 1), hitting 1 at alpha 0.5 while
            # class_depth_scale (= a) is still 0.5 — amortization is the
            # cheapest thing to give up, whole classes the last
            return Knobs(max(1, int(self.full_batch * a)),
                         admission_rate=a,
                         frame_rate_hz=max(1.0, self.full_fps * a),
                         mem_clock_scale=max(0.25, a),
                         submesh_width=max(0.25, a),
                         cascade=False,
                         backend_demotion="host" if a < 0.5 else None,
                         class_depth_scale=a,
                         max_stage_batch=max(1, int(
                             self.full_stage_batch * max(0.0, 2 * a - 1))),
                         class_kv_scale=a)
        return Knobs(1, admission_rate=0.0, frame_rate_hz=0.0,
                     mem_clock_scale=0.25, submesh_width=0.25, cascade=True,
                     backend_demotion="host", class_depth_scale=0.0,
                     max_stage_batch=1, class_kv_scale=0.0)


@dataclass
class BatteryAwareExecutor:
    """Glue: reads the PMU, exposes the knobs + the scheduler objective.

    Objective flips from latency to energy as charge drops — the paper's
    'arbitrates the trade-off between performance and longevity'."""

    pmu: PMU
    policy: PowerPolicy = field(default_factory=PowerPolicy)

    def current(self) -> Tuple[PowerState, Knobs, str]:
        b = self.pmu.level
        st = self.policy.state(b)
        objective = "latency" if st is PowerState.UNCONSTRAINED else "energy"
        return st, self.policy.knobs(b), objective
