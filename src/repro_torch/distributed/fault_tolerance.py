"""Fault tolerance of the train loop on one card: the straggler tracker
and the recovery log (the port's own copy of the reference's two
classes; the heartbeat monitor and the re-mesh planner belong to the
multi-host deployment, which the port does not run).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class StragglerMitigator:
    """Per-worker step-time tracker with eviction policy."""

    n_workers: int
    window: int = 32
    multiplier: float = 2.0
    min_samples: int = 8

    def __post_init__(self):
        self.times: Dict[int, List[float]] = {w: []
                                              for w in range(self.n_workers)}

    def record(self, worker: int, step_time_s: float):
        buf = self.times.setdefault(worker, [])
        buf.append(step_time_s)
        del buf[:-self.window]

    def fleet_median(self) -> float:
        all_t = [t for buf in self.times.values() for t in buf]
        return float(np.median(all_t)) if all_t else 0.0

    def stragglers(self) -> List[int]:
        med = self.fleet_median()
        if med == 0.0:
            return []
        out = []
        for w, buf in self.times.items():
            if len(buf) >= self.min_samples \
                    and float(np.median(buf)) > self.multiplier * med:
                out.append(w)
        return sorted(out)

    def step_deadline(self) -> float:
        """Per-step deadline: fleet median x multiplier (the synchronous-
        step timeout after which the monitor treats a worker as failed)."""
        med = self.fleet_median()
        return med * self.multiplier if med else float("inf")


@dataclass
class RecoveryLog:
    """Audit trail of failures/re-meshes (exposed by the train loop)."""
    events: List[dict] = field(default_factory=list)

    def record(self, kind: str, **kw):
        self.events.append({"kind": kind, "t": time.time(), **kw})
