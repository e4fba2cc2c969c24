"""Fleet-scale battery simulation: the paper's one device, times N (the
port's own copy of the reference's module; numpy over the port's
``core/power.py``).

A RAPS-``FLOPSManager``-style simulator (SNIPPETS.md): aggregate fleet
state lives in numpy vectors (levels, backlogs, survival), while each
device keeps its own :class:`~repro_torch.core.power.PMU` and shares one
:class:`~repro_torch.core.power.PowerPolicy` — every tick each device reads
its battery level, takes the policy's state/knobs, admits its share of
an arrival trace, processes tokens phase-by-phase at the modality
profile's rates, and drains the modeled joules into its PMU.  Devices
traverse UNCONSTRAINED -> THROTTLED -> CRITICAL as charge falls and die
at empty, yielding fleet-wide tokens/s, J/token, and a survival-hours
histogram — the paper's single-device Fig. 8 story scaled to a fleet.

The per-phase energy profile comes from a telemetry
:class:`~repro_torch.telemetry.ledger.Ledger` ("Modality Inflation",
PAPERS.md: vision staging, prefill and decode differ enough per token
that one blended J/token misprices the power policy's cuts), so the
same file a bench run wrote drives the fleet.

Determinism: the only randomness is the per-device offered-load draw at
construction (seeded); stepping is pure arithmetic with a fractional
arrival accumulator — same seed, same fleet, same report, equal to the
reference's for the same seed and profile.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Mapping, NamedTuple, Optional, Set, Tuple

import numpy as np

from repro_torch.core.power import PMU, PowerPolicy, PowerState
from repro_torch.telemetry.ledger import PHASES, Ledger

# tokens one request pushes through each phase: a frame's worth of
# vision staging, a short prompt, a short answer (fig8's event shape)
DEFAULT_REQUEST_TOKENS = {"stage": 64, "prefill": 32, "decode": 48}


@dataclass(frozen=True)
class ModalityProfile:
    """Per-phase J/token and tokens/s of ONE device's pipeline."""

    j_per_token: Mapping[str, float]
    tokens_per_s: Mapping[str, float]
    idle_w: float = 0.35            # fig8's standby draw (A55 + LPDDR)

    @classmethod
    def from_ledger(cls, ledger: Ledger, idle_w: float = 0.35
                    ) -> "ModalityProfile":
        """Sample the per-modality characterization from a ledger (the
        measured-or-modeled file a bench run wrote)."""
        jpt, tps = {}, {}
        for phase in PHASES:
            tot = ledger.total(phase)
            if tot.tokens <= 0:
                raise ValueError(f"ledger has no {phase!r} rows to "
                                 f"characterize the fleet from")
            jpt[phase] = tot.j_per_token
            tps[phase] = tot.tokens_per_s
        return cls(jpt, tps, idle_w=idle_w)

    @classmethod
    def default_edge(cls) -> "ModalityProfile":
        """RK3566-class fallback (no ledger at hand): numbers of the
        modeled edge pipeline at fig8's event shape — stage is
        vision-heavy but parallel, decode is memory-bound and slow."""
        return cls(
            j_per_token={"stage": 0.004, "prefill": 0.003, "decode": 0.012},
            tokens_per_s={"stage": 450.0, "prefill": 700.0, "decode": 40.0})


class FleetTraceEvent(NamedTuple):
    """One device-tick, replayable: drain ``joules`` over ``dt`` into a
    fresh PMU and the recorded ``state``/``level`` must reproduce."""

    t: float
    device: int
    state: str
    level: float                # state of charge AFTER this tick's drain
    tokens: float
    joules: float
    dt: float


@dataclass(frozen=True)
class FleetReport:
    n_devices: int
    hours: float                    # simulated horizon actually stepped
    tokens_per_s: float             # fleet aggregate over simulated time
    j_per_token: float
    survival_hours: np.ndarray      # per device; alive at horizon = horizon
    dead: int
    states_seen: Set[str]
    state_ticks: Dict[str, int]
    shed_tokens: float              # offered but not admitted (throttling)

    @property
    def survival_hours_p50(self) -> float:
        return float(np.median(self.survival_hours))

    def histogram(self, bins: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        return np.histogram(self.survival_hours, bins=bins)

    def summary(self) -> str:
        counts, edges = self.histogram()
        bars = "\n".join(
            f"  {lo:5.1f}-{hi:5.1f} h | {'#' * int(c)} {int(c)}"
            for lo, hi, c in zip(edges[:-1], edges[1:], counts))
        return (
            f"fleet: {self.n_devices} devices, {self.hours:.1f} h horizon\n"
            f"  tokens/s (fleet): {self.tokens_per_s:.1f}\n"
            f"  J/token  (fleet): {self.j_per_token:.4f}\n"
            f"  survival p50:     {self.survival_hours_p50:.2f} h "
            f"({self.dead}/{self.n_devices} dead)\n"
            f"  states seen:      {sorted(self.states_seen)}\n"
            f"  ticks per state:  {self.state_ticks}\n"
            f"  shed tokens:      {self.shed_tokens:.0f}\n"
            f"survival-hours histogram:\n{bars}")


class FleetSimulator:
    """Hundreds-to-thousands of simulated battery devices, one policy.

    ``request_hz``: per-device offered load is drawn uniformly from this
    range at construction (the only RNG use).  ``request_tokens``: the
    per-phase token cost of one request.  ``record_trace`` keeps a
    bounded :class:`FleetTraceEvent` log for replay tests."""

    def __init__(self, n_devices: int, profile: ModalityProfile, *,
                 policy: Optional[PowerPolicy] = None, seed: int = 0,
                 battery_mah: float = 2000.0, volts: float = 3.7,
                 dt_s: float = 30.0,
                 request_hz: Tuple[float, float] = (0.02, 0.25),
                 request_tokens: Optional[Mapping[str, int]] = None,
                 record_trace: bool = False, trace_cap: int = 65536):
        if n_devices < 1:
            raise ValueError("need at least one device")
        rng = np.random.default_rng(seed)
        self.profile = profile
        self.policy = policy or PowerPolicy()
        self.dt_s = float(dt_s)
        self.request_tokens = dict(request_tokens or DEFAULT_REQUEST_TOKENS)
        self._req_vec = np.array([self.request_tokens[p] for p in PHASES],
                                 float)
        self._jpt = np.array([profile.j_per_token[p] for p in PHASES])
        self._tps = np.array([profile.tokens_per_s[p] for p in PHASES])
        self.pmus = [PMU(battery_mah=battery_mah, volts=volts)
                     for _ in range(n_devices)]
        # FLOPSManager-style aggregate state: one vector per fleet signal
        self.levels = np.ones(n_devices)
        self.alive = np.ones(n_devices, dtype=bool)
        self.rates_hz = rng.uniform(*request_hz, size=n_devices)
        self._carry = np.zeros(n_devices)       # fractional arrivals
        self.backlog = np.zeros((n_devices, len(PHASES)))
        self.survival_h = np.zeros(n_devices)
        self.t = 0.0
        self.tokens_done = 0.0
        self.joules_spent = 0.0
        self.shed_tokens = 0.0
        self.states_seen: Set[str] = set()
        self.state_ticks: Dict[str, int] = {s.value: 0 for s in PowerState}
        self.trace: Optional[Deque[FleetTraceEvent]] = (
            deque(maxlen=trace_cap) if record_trace else None)

    def step(self) -> None:
        """Advance every live device by ``dt_s`` of simulated time.

        Host-side arithmetic only (a device sync per device-tick would
        serialize a thousand-device fleet)."""
        dt = self.dt_s
        self.t += dt
        req = self._req_vec
        for i, pmu in enumerate(self.pmus):
            if not self.alive[i]:
                continue
            st = self.policy.state(pmu.level)
            knobs = self.policy.knobs(pmu.level)
            self.states_seen.add(st.value)
            self.state_ticks[st.value] += 1
            # offered arrivals: deterministic fractional accumulator
            self._carry[i] += self.rates_hz[i] * dt
            offered = math.floor(self._carry[i])
            self._carry[i] -= offered
            if knobs.cascade:
                # critical: on-demand cascade serves ONE event per tick,
                # everything else is shed (paper state iii)
                admitted = min(offered, 1)
            elif st is PowerState.UNCONSTRAINED:
                admitted = offered
            else:
                # proportional throttling sheds offered load by alpha
                admitted = math.floor(offered * knobs.admission_rate)
            self.shed_tokens += (offered - admitted) * req.sum()
            self.backlog[i] += admitted * req
            # per-phase service capacity this tick, throttled through the
            # same knob the engine throttles its memory path with
            speed = 0.25 if knobs.cascade else knobs.mem_clock_scale
            done = np.minimum(self.backlog[i], self._tps * dt * speed)
            self.backlog[i] -= done
            # cascade drops to a deep-sleep duty cycle between events;
            # the other states pay full standby (fig8's 0.35 W floor)
            idle = self.profile.idle_w * (0.5 if knobs.cascade else 1.0)
            joules = (done * self._jpt).sum() + idle * dt
            pmu.drain(joules, dt)
            self.levels[i] = pmu.level
            tokens = done.sum()
            self.tokens_done += tokens
            self.joules_spent += joules
            if self.trace is not None:
                self.trace.append(FleetTraceEvent(
                    self.t, i, st.value, pmu.level, tokens, joules, dt))
            if pmu.level <= 0.0:
                self.alive[i] = False
                self.survival_h[i] = self.t / 3600.0

    def run(self, hours: float) -> FleetReport:
        steps = max(1, round(hours * 3600.0 / self.dt_s))
        for _ in range(steps):
            if not self.alive.any():
                break
            self.step()
        return self.report()

    def report(self) -> FleetReport:
        horizon_h = self.t / 3600.0
        # devices alive at the horizon are right-censored at the horizon
        survival = np.where(self.alive, horizon_h, self.survival_h)
        return FleetReport(
            n_devices=len(self.pmus), hours=horizon_h,
            tokens_per_s=self.tokens_done / max(self.t, 1e-9),
            j_per_token=self.joules_spent / max(self.tokens_done, 1e-9),
            survival_hours=survival,
            dead=int((~self.alive).sum()),
            states_seen=set(self.states_seen),
            state_ticks=dict(self.state_ticks),
            shed_tokens=self.shed_tokens)


def replay_trace(events, *, battery_mah: float = 2000.0,
                 volts: float = 3.7,
                 policy: Optional[PowerPolicy] = None
                 ) -> Dict[int, list]:
    """Re-drive recorded :class:`FleetTraceEvent` s through fresh
    PMU/PowerPolicy instances: for each device, drain the recorded
    joules tick-by-tick and return ``[(state, level), ...]`` as the
    fresh state machine saw them.  The satellite test asserts these
    match the recording — the power state machine is a pure function of
    the drain history."""
    pol = policy or PowerPolicy()
    pmus: Dict[int, PMU] = {}
    out: Dict[int, list] = {}
    for ev in events:
        pmu = pmus.setdefault(ev.device,
                              PMU(battery_mah=battery_mah, volts=volts))
        # state is read BEFORE the tick's drain, as the simulator does
        st = pol.state(pmu.level)
        pmu.drain(ev.joules, ev.dt)
        out.setdefault(ev.device, []).append((st.value, pmu.level))
    return out
