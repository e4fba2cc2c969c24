"""Per-brick, per-phase telemetry ledger with JSON persistence.

The accumulating-record pattern (SNIPPETS.md ``FlopCount`` +
``save_roofline_data``): one :class:`PhaseRecord` per (brick, phase)
holding flops / HBM bytes / link bytes / tokens / joules / seconds, with
closed arithmetic (``+`` merges, ``*`` scales) so ledgers from separate
bench runs compose into one trajectory file.

The port's own copy of the reference's ledger.  Two population paths
share one schema:

* **static** (:meth:`Ledger.modeled`) — the scheduler's roofline and
  energy model (``core/scheduler.brick_cost`` over ``analysis/energy``
  constants); ``samples == 0`` marks these rows as modeled, never
  measured;
* **dynamic** (:meth:`repro_torch.telemetry.probes.WallProbe.to_ledger`)
  — wall-time samples recorded by the plan/engine probes; ``samples >
  0`` marks a row as measured, which is what
  :meth:`repro_torch.telemetry.calibration.CostCalibration.from_ledger`
  feeds back into the scheduler.

Phase token semantics: bricks form a chain, so every brick of a phase
sees the SAME token stream — a phase's token count is the **max** over
its bricks (never the sum), while seconds/joules add across bricks.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterator, Mapping, Optional, Tuple

PHASES = ("stage", "prefill", "decode")

# which brick kinds run in which phase (the chain splits at the TABM
# edge: vision-side bricks stage, decoder-side bricks prefill + decode)
PHASE_KINDS = {
    "stage": ("frontend", "encoder", "projector"),
    "prefill": ("frontend", "encoder", "projector", "embed", "decoder",
                "head"),
    "decode": ("embed", "decoder", "head"),
}


@dataclass
class PhaseRecord:
    """One (brick, phase) accumulator — the FlopCount of this repo.

    ``samples`` counts *measured* wall-time observations folded in;
    modeled (static) rows keep ``samples == 0`` so downstream consumers
    can tell observation from prediction in a merged ledger."""

    flops: float = 0.0
    bytes: float = 0.0          # HBM/weight traffic
    link_bytes: float = 0.0     # interconnect traffic
    tokens: float = 0.0
    joules: float = 0.0
    seconds: float = 0.0
    samples: int = 0

    def __add__(self, other: "PhaseRecord") -> "PhaseRecord":
        return PhaseRecord(
            self.flops + other.flops, self.bytes + other.bytes,
            self.link_bytes + other.link_bytes, self.tokens + other.tokens,
            self.joules + other.joules, self.seconds + other.seconds,
            self.samples + other.samples)

    def __mul__(self, k: float) -> "PhaseRecord":
        """Scale the extensive fields; ``samples`` stays a count."""
        return PhaseRecord(
            self.flops * k, self.bytes * k, self.link_bytes * k,
            self.tokens * k, self.joules * k, self.seconds * k,
            self.samples)

    __rmul__ = __mul__

    @property
    def j_per_token(self) -> float:
        return self.joules / self.tokens if self.tokens else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    def to_dict(self) -> Dict[str, float]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "PhaseRecord":
        return cls(**{k: d.get(k, 0) for k in
                      ("flops", "bytes", "link_bytes", "tokens", "joules",
                       "seconds")}, samples=int(d.get("samples", 0)))


@dataclass
class Ledger:
    """Accumulating (brick, phase) -> :class:`PhaseRecord` table."""

    records: Dict[Tuple[str, str], PhaseRecord] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)

    # -- accumulation -------------------------------------------------------
    def accumulate(self, brick: str, phase: str, rec: Optional[PhaseRecord]
                   = None, **fields) -> PhaseRecord:
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r} (want one of "
                             f"{PHASES})")
        add = rec if rec is not None else PhaseRecord(**fields)
        key = (brick, phase)
        self.records[key] = self.records.get(key, PhaseRecord()) + add
        return self.records[key]

    def record(self, brick: str, phase: str) -> PhaseRecord:
        return self.records.get((brick, phase), PhaseRecord())

    def items(self) -> Iterator[Tuple[str, str, PhaseRecord]]:
        for (brick, phase), rec in sorted(self.records.items()):
            yield brick, phase, rec

    def __len__(self) -> int:
        return len(self.records)

    # -- algebra ------------------------------------------------------------
    def merge(self, other: "Ledger") -> "Ledger":
        """In-place fold of another ledger (record-wise ``+``)."""
        for (brick, phase), rec in other.records.items():
            self.accumulate(brick, phase, rec)
        for k, v in other.meta.items():
            self.meta.setdefault(k, v)
        return self

    def __add__(self, other: "Ledger") -> "Ledger":
        return Ledger(dict(self.records), dict(self.meta)).merge(other)

    def scale(self, k: float) -> "Ledger":
        return Ledger({key: rec * k for key, rec in self.records.items()},
                      dict(self.meta))

    # -- derived ------------------------------------------------------------
    def total(self, phase: Optional[str] = None) -> PhaseRecord:
        """Sum of records (one phase, or all); ``tokens`` uses the
        chain max-rule per phase (see module docstring)."""
        phases = PHASES if phase is None else (phase,)
        out = PhaseRecord()
        for ph in phases:
            recs = [r for (b, p), r in self.records.items() if p == ph]
            if not recs:
                continue
            for r in recs:
                out = out + (r * 1.0)
            out.tokens -= sum(r.tokens for r in recs)
            out.tokens += max(r.tokens for r in recs)
        return out

    def j_per_token(self, phase: Optional[str] = None) -> float:
        return self.total(phase).j_per_token

    def tokens_per_s(self, phase: Optional[str] = None) -> float:
        return self.total(phase).tokens_per_s

    # -- persistence (à la SNIPPETS.md save_roofline_data) ------------------
    def to_dict(self) -> Dict:
        return {"schema": 1, "meta": dict(self.meta),
                "records": {f"{b}/{p}": r.to_dict()
                            for (b, p), r in sorted(self.records.items())}}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Ledger":
        led = cls(meta=dict(d.get("meta", {})))
        for key, rec in d.get("records", {}).items():
            brick, _, phase = key.rpartition("/")
            led.accumulate(brick, phase, PhaseRecord.from_dict(rec))
        return led

    def save(self, path: str) -> str:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)       # atomic: readers never see a torn file
        return path

    @classmethod
    def load(cls, path: str) -> "Ledger":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- static population (roofline + energy model) ------------------------
    @classmethod
    def modeled(cls, graph, accel_for, phase_tokens: Mapping[str, int],
                batch: int = 1) -> "Ledger":
        """Ledger predicted by the cost model, no execution needed.

        ``accel_for``: one :class:`~repro_torch.core.scheduler.Accelerator`
        for every brick, or a ``{brick_name: Accelerator}`` map (e.g.
        built from a ``Placement``).  ``phase_tokens``: tokens per call
        per phase, e.g. ``{"stage": 729, "prefill": 64, "decode": 1}``;
        bricks participate per :data:`PHASE_KINDS`.  Rows carry
        ``samples == 0``: modeled, not measured."""
        # local import: the scheduler imports telemetry.calibration, so
        # the static-population edge must not close an import cycle
        from repro_torch.core.scheduler import brick_cost
        led = cls(meta={"source": "modeled"})
        for phase, n_tokens in phase_tokens.items():
            for b in graph.bricks:
                if b.kind not in PHASE_KINDS.get(phase, ()):
                    continue
                acc = (accel_for[b.name] if isinstance(accel_for, Mapping)
                       else accel_for)
                c = brick_cost(b, acc, n_tokens, batch=batch)
                if not c.feasible:
                    continue
                units = n_tokens * max(1, batch)
                led.accumulate(
                    b.name, phase,
                    flops=b.flops_per_token * units,
                    bytes=float(max(b.param_bytes, 1)),
                    tokens=float(units), joules=c.energy_j,
                    seconds=c.latency_s, samples=0)
        return led
