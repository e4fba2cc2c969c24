"""Wall-time probes: the ledger's dynamic (measured) population path.

The port's own copy of the reference's probes.  A :class:`WallProbe`
collects timestamped per-brick samples from the
hot paths (``ExecutionPlan.run`` / ``produce_many``, the engine's
prefill and cohort-decode spans).  The collector is deliberately
host-only — ``time.perf_counter`` spans stamped with ``time.monotonic``
and a lock-free ``deque`` append — so recording is legal inside the
replint host-sync hot paths (``WallProbe.record`` is itself on that
list: no device syncs may ever creep in here).

Measurement caveat, stated once: on asynchronous backends a span that
does not end at an existing host sync measures *dispatch*, not device
completion.  The engine's spans end at syncs it already pays (the
per-token sampling read after decode, the ``insert_many`` length reads
after prefill), so those are true wall times; the plan's per-brick
staging spans are dispatch-inclusive lower bounds, still ordered
correctly for *relative* comparison.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, List, NamedTuple, Optional

from repro_torch.telemetry.ledger import Ledger


class Sample(NamedTuple):
    """One measured span: ``t`` is ``time.monotonic()`` at record time
    (orders samples across threads), ``dt`` the measured seconds,
    ``tokens`` how many tokens the span processed."""

    brick: str
    phase: str          # stage | prefill | decode
    t: float
    dt: float
    tokens: int


class WallProbe:
    """Thread-safe accumulator of :class:`Sample` spans.

    Appends are a single ``deque.append`` (atomic under the GIL), so the
    engine's staging worker threads and the step loop share one probe
    without a lock on the record path; the bound keeps a long-running
    server from growing it without limit (same contract as the engine
    trace)."""

    def __init__(self, maxlen: int = 65536):
        self._samples: Deque[Sample] = deque(maxlen=maxlen)

    def record(self, brick: str, phase: str, dt: float, tokens: int = 0
               ) -> None:
        self._samples.append(Sample(brick, phase, time.monotonic(), dt,
                                    tokens))

    def span(self, brick: str, phase: str, tokens: int = 0):
        """Context-manager form for cold paths; hot paths inline the
        two-line ``perf_counter`` form instead (no generator frames on
        the decode loop)."""
        return _Span(self, brick, phase, tokens)

    def samples(self) -> List[Sample]:
        return list(self._samples)

    def __len__(self) -> int:
        return len(self._samples)

    def clear(self) -> None:
        self._samples.clear()

    def to_ledger(self, meta: Optional[dict] = None) -> Ledger:
        """Fold the samples into a measured :class:`Ledger` (one record
        per brick/phase, ``samples`` = observation count).  Joules stay
        zero: the probe reads no power meter.  Joules enter through a
        table or ledger the caller feeds (``CostCalibration.observe(...,
        joules=)``, ``Ledger.accumulate(..., joules=)``), e.g. from the
        card's energy counter over a measured window."""
        led = Ledger(meta={"source": "probe", **(meta or {})})
        for s in self.samples():
            led.accumulate(s.brick, s.phase, seconds=s.dt,
                           tokens=float(s.tokens), samples=1)
        return led


class _Span:
    def __init__(self, probe: WallProbe, brick: str, phase: str,
                 tokens: int):
        self.probe, self.brick, self.phase, self.tokens = (
            probe, brick, phase, tokens)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.probe.record(self.brick, self.phase,
                          time.perf_counter() - self._t0, self.tokens)
        return False
