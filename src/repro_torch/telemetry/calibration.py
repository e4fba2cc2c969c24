"""Measured per-brick cost tables the scheduler consults (the port's own
copy of the reference's module).

The feedback edge of the telemetry subsystem: wall-time (and, when the
fleet simulator supplies them, energy) observations keyed by
``(brick, energy-profile)`` that ``core/scheduler.brick_cost`` blends
with its modeled roofline numbers — measured overrides modeled as the
sample count grows:

    w = n / (n + prior)          # 0 samples -> pure model,
    cost = (1-w)*modeled + w*measured    # n >> prior -> pure measurement

Lookup falls back from the exact ``(brick, profile)`` key to
``(brick, None)``: a probe that cannot attribute an accelerator (the
engine's default single-substrate plan) still calibrates every
candidate placement of that brick.

Only stdlib imports here — ``core/scheduler`` imports this module at
top level, and the reverse (static ledger population) goes through a
function-local import in ``Ledger.modeled`` (``telemetry/ledger.py``).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class CalSample:
    """Aggregated observations for one (brick, profile) key."""

    seconds: float = 0.0
    joules: float = 0.0
    tokens: float = 0.0
    n: int = 0                  # observation count (blending weight input)

    @property
    def seconds_per_token(self) -> float:
        return self.seconds / self.tokens if self.tokens else 0.0

    @property
    def joules_per_token(self) -> float:
        return self.joules / self.tokens if self.tokens else 0.0


class CostCalibration:
    """(brick, profile-or-None) -> :class:`CalSample` table.

    ``prior`` is the pseudo-count of trust in the model: at ``n ==
    prior`` measured and modeled weigh equally; the default (4) lets a
    handful of bench iterations already dominate hand-written
    constants."""

    def __init__(self, prior: int = 4):
        self.prior = max(1, int(prior))
        self._table: Dict[Tuple[str, Optional[str]], CalSample] = {}

    # -- population ---------------------------------------------------------
    def observe(self, brick: str, profile: Optional[str], seconds: float,
                tokens: float, joules: float = 0.0, n: int = 1) -> CalSample:
        key = (brick, profile)
        cur = self._table.get(key, CalSample())
        out = CalSample(cur.seconds + seconds, cur.joules + joules,
                        cur.tokens + tokens, cur.n + max(1, int(n)))
        self._table[key] = out
        return out

    @classmethod
    def from_ledger(cls, ledger, profile: Optional[str] = None,
                    prior: int = 4) -> "CostCalibration":
        """Fold a ledger's *measured* rows (``samples > 0``) into a
        table; modeled rows are skipped by definition — the whole point
        is that the scheduler already has the model."""
        cal = cls(prior=prior)
        for brick, _phase, rec in ledger.items():
            if rec.samples > 0 and rec.tokens > 0:
                cal.observe(brick, profile, rec.seconds, rec.tokens,
                            rec.joules, n=rec.samples)
        return cal

    # -- lookup -------------------------------------------------------------
    def sample(self, brick: str, profile: Optional[str] = None
               ) -> Optional[CalSample]:
        s = self._table.get((brick, profile))
        if s is None and profile is not None:
            s = self._table.get((brick, None))
        return s

    def weight(self, n: int) -> float:
        """Sample-count blending weight in [0, 1)."""
        return n / (n + self.prior)

    # -- wire links ---------------------------------------------------------
    # Measured transport bandwidth rides the same table under a reserved
    # brick key: ``(LINK_KEY, transport-name)`` with bytes in the tokens
    # column.  ``core/scheduler.fleet_accelerators`` blends the result
    # over the static per-class ``link_bw`` row exactly like brick costs
    # blend measured seconds over the roofline model.

    LINK_KEY = "__link__"

    def observe_link(self, transport_name: Optional[str],
                     bytes_moved: float, seconds: float,
                     n: int = 1) -> CalSample:
        """Record measured wire crossings for one transport
        (``Transport.sent_bytes`` over ``Transport.send_seconds``)."""
        return self.observe(self.LINK_KEY, transport_name, seconds,
                            bytes_moved, n=n)

    def link_bw(self, transport_name: Optional[str],
                modeled_bw: float) -> float:
        """Blend measured wire bandwidth over the modeled ``link_bw``:
        no observation -> the static row, a well-observed wire -> what
        the frames actually clocked."""
        s = self.sample(self.LINK_KEY, transport_name)
        if s is None or s.tokens <= 0 or s.seconds <= 0:
            return modeled_bw
        w = self.weight(s.n)
        return (1.0 - w) * modeled_bw + w * (s.tokens / s.seconds)

    def energy_pressure(self, brick: str, profile: Optional[str],
                        modeled_j_per_token: float) -> float:
        """Measured-over-modeled decode energy ratio (>= 0); 1.0 when no
        energy observation exists.  The engine feeds this into
        ``kv_block_budgets`` so hotter-than-modeled decode sheds hi-res
        KV grants earlier."""
        s = self.sample(brick, profile)
        if s is None or s.joules <= 0 or modeled_j_per_token <= 0:
            return 1.0
        return s.joules_per_token / modeled_j_per_token

    def __len__(self) -> int:
        return len(self._table)

    def __bool__(self) -> bool:
        return bool(self._table)

    # -- persistence --------------------------------------------------------
    def to_dict(self) -> Dict:
        return {"schema": 1, "prior": self.prior,
                "table": {f"{b}@{p or ''}": {
                    "seconds": s.seconds, "joules": s.joules,
                    "tokens": s.tokens, "n": s.n}
                    for (b, p), s in sorted(
                        self._table.items(),
                        key=lambda kv: (kv[0][0], kv[0][1] or ""))}}

    @classmethod
    def from_dict(cls, d: Mapping) -> "CostCalibration":
        cal = cls(prior=int(d.get("prior", 4)))
        for key, s in d.get("table", {}).items():
            brick, _, prof = key.rpartition("@")
            cal.observe(brick, prof or None, s["seconds"], s["tokens"],
                        s.get("joules", 0.0), n=s.get("n", 1))
        return cal

    def save(self, path: str) -> str:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "CostCalibration":
        with open(path) as f:
            return cls.from_dict(json.load(f))
