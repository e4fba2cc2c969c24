"""Disaggregated prefill/decode fleets over a Transport.

Batched prefill is compute-bound and decode memory-bound, so each side
runs its own :class:`~repro_torch.serving.engine.ServingEngine` and they
meet only at a serialized :class:`~repro_torch.core.transport.Transport`:

* :class:`PrefillWorker` drives the engine's staging and grouped batched
  prefill (``prefill_step``), exports every newly admitted request as a
  :class:`~repro_torch.core.transport.RemotePrefill` (committed TABM
  slab, the *written* KV blocks and the block grant, never a whole
  ``max_len`` lane) and streams it over the wire.  Its engine never
  decodes; its slots recycle the moment a request ships.
* :class:`DecodeWorker` receives frames, admits each prefill straight
  into its own paged pool (``engine.admit_remote``; a full pool decodes
  a step to retire capacity and retries), cohort-decodes everything to
  completion with the unmodified ``step`` (on the card: replays of its
  cohort graphs, which the imports leave valid), and streams per-request
  results back on the same transport.

Failure semantics (the wire contract, ``core/transport.py``): a frame
whose payload fails its checksum is *recoverable*, the stream stayed
aligned and the rid survived in the frame prefix, so the decode fleet
fails exactly that request (a ``result`` frame with the error) and keeps
serving.  A truncated or header-corrupt stream is fatal: every request
still unresolved fails with the stream error.  Prefill-side staging
failures cross as ``failed`` frames so the decode side accounts for
every submitted rid.

Frame kinds on the wire::

    prefill  prefill fleet -> decode fleet   RemotePrefill (slab + KV)
    failed   prefill fleet -> decode fleet   rid + error (staging failed)
    done     either direction                end of stream
    result   decode fleet -> prefill fleet   rid + tokens (+ error)

Decode tokens equal the single engine's: the decode worker runs the
unmodified ``step()`` over imported state that crossed the lossless
codec, with the first token picked from the same prefill logits.
Disaggregated serving is greedy only (temperature 0 is enforced at
submit): a sampled stream cannot be split across two engines'
generators.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.transport import (InProcTransport, RemotePrefill,
                                        Transport, TransportError)
from repro_torch.serving.engine import Request, ServingEngine


@dataclass
class DisaggResult:
    """One request's outcome as it crossed back over the wire."""

    rid: int
    tokens: List[int] = field(default_factory=list)
    error: Optional[str] = None


@dataclass
class PrefillStats:
    """Wire accounting of the prefill fleet: ``kv_wire_bytes`` (paged KV
    shipped) against ``lane_bytes_baseline`` (one whole ``max_len``
    lane), ``wire_seconds`` the transport's send clock."""

    sent: int = 0
    failed: int = 0
    wire_bytes: int = 0
    kv_wire_bytes: int = 0
    lane_bytes_baseline: int = 0
    wire_seconds: float = 0.0
    transport: str = ""


class PrefillWorker:
    """The prefill fleet: staging, projector and grouped batched prefill,
    streamed out as RemotePrefill frames."""

    def __init__(self, cfg, params, transport: Transport, *,
                 max_steps: int = 10_000, **engine_kwargs):
        engine_kwargs.setdefault("async_staging", False)
        self.transport = transport
        self.max_steps = max_steps
        self.engine = ServingEngine(cfg, params, capture_slab=True,
                                    **engine_kwargs)
        self.stats = PrefillStats()
        self._done_seen = 0

    def submit(self, req: Request) -> None:
        if req.temperature != 0.0:
            raise ValueError(
                f"disaggregated serving is greedy-only (request "
                f"{req.rid} has temperature {req.temperature})")
        self.engine.submit(req)

    def _flush_failures(self) -> None:
        """Staging and admission failures land in ``engine.done``: cross
        them as ``failed`` frames so the decode side accounts for every
        rid."""
        while self._done_seen < len(self.engine.done):
            req = self.engine.done[self._done_seen]
            self._done_seen += 1
            self.stats.failed += 1
            self.stats.wire_bytes += self.transport.send(
                "failed", {"rid": req.rid, "error": repr(req.error)},
                rid=req.rid)

    def run(self) -> PrefillStats:
        """Prefill and ship everything submitted, then send ``done``."""
        eng = self.engine
        self.stats.lane_bytes_baseline = eng.slots.slot_lane_bytes
        steps = 0
        while eng.queue or eng.live:
            if steps >= self.max_steps:
                raise RuntimeError(
                    f"prefill fleet made no progress in "
                    f"{self.max_steps} admission rounds")
            steps += 1
            for req in eng.prefill_step():
                rp = eng.export_remote(req)
                self.stats.sent += 1
                self.stats.kv_wire_bytes += rp.kv_wire_bytes()
                self.stats.wire_bytes += self.transport.send_prefill(rp)
            self._flush_failures()
        self.transport.send("done", {})
        return self.stats

    def collect(self, n: int) -> Dict[int, DisaggResult]:
        """Receive result frames until the decode fleet's ``done`` and
        return them by rid (``n``, the expected count, is the caller's
        accounting).  Draining to ``done`` is the close handshake: the
        decode side's last write has completed, so closing this end
        afterwards cannot break the pipe under its final frame."""
        results: Dict[int, DisaggResult] = {}
        while True:
            kind, meta, arrays, rid = self.transport.recv()
            if kind == "done":
                break
            if kind != "result":
                raise TransportError(
                    f"unexpected frame kind {kind!r} on the result path")
            tokens = [int(t) for t in arrays[0]] if arrays else []
            results[rid] = DisaggResult(rid=rid, tokens=tokens,
                                        error=meta.get("error"))
        return results


class DecodeWorker:
    """The decode fleet: admit RemotePrefill frames into the paged pool,
    cohort-decode to completion, stream results back."""

    def __init__(self, cfg, params, transport: Transport, *,
                 max_steps: int = 100_000, **engine_kwargs):
        engine_kwargs.setdefault("async_staging", False)
        self.transport = transport
        self.max_steps = max_steps
        self.engine = ServingEngine(cfg, params, **engine_kwargs)
        self.results: Dict[int, DisaggResult] = {}

    def _admit(self, rp: RemotePrefill) -> None:
        eng = self.engine
        while not eng.admit_remote(rp):
            # pool full: decode one step so a finishing request retires
            # and frees the slot and blocks this admission needs
            if not eng.live:
                raise RuntimeError(
                    f"request {rp.rid} needs {rp.blocks_granted} blocks "
                    f"but the idle pool cannot grant them (decode fleet "
                    f"sized too small for one request)")
            eng.step()

    def run(self) -> Dict[int, DisaggResult]:
        """Serve the stream to completion.  Recoverable wire errors fail
        only the owning request; a fatal stream error fails everything
        unresolved, then propagates."""
        eng = self.engine
        expected: List[int] = []               # rids in arrival order
        stream_error: Optional[TransportError] = None
        while True:
            try:
                kind, meta, arrays, rid = self.transport.recv()
            except TransportError as e:
                if e.recoverable:
                    # the frame was consumed whole and named its owner:
                    # fail exactly that request, keep receiving
                    if e.rid is not None:
                        expected.append(e.rid)
                        self.results[e.rid] = DisaggResult(
                            rid=e.rid, error=repr(e))
                    continue
                stream_error = e
                break
            if kind == "done":
                break
            if kind == "failed":
                expected.append(rid)
                self.results[rid] = DisaggResult(
                    rid=rid, error=meta.get("error"))
                continue
            if kind != "prefill":
                continue                       # ignore unknown kinds
            try:
                rp = RemotePrefill.from_wire(meta, arrays)
                self._admit(rp)
                expected.append(rp.rid)
            except TransportError as e:
                if e.rid is not None:
                    expected.append(e.rid)
                    self.results[e.rid] = DisaggResult(rid=e.rid,
                                                       error=repr(e))
        steps = 0
        while eng.live and steps < self.max_steps:
            eng.step()
            steps += 1
        for req in eng.done:
            if req.rid in self.results:
                continue
            self.results[req.rid] = DisaggResult(
                rid=req.rid, tokens=list(req.out_tokens),
                error=None if req.error is None else repr(req.error))
        if stream_error is not None:
            for rid in expected:
                if rid not in self.results:
                    self.results[rid] = DisaggResult(
                        rid=rid, error=repr(stream_error))
        for rid in expected:                   # arrival order, duplex back
            r = self.results[rid]
            self.transport.send(
                "result", {"rid": r.rid, "error": r.error},
                arrays=[np.asarray(r.tokens, np.int32)], rid=r.rid)
        self.transport.send("done", {})
        if stream_error is not None:
            raise stream_error
        return self.results


def serve_disagg_inproc(cfg, params, requests: List[Request], *,
                        prefill_kwargs: Optional[dict] = None,
                        decode_kwargs: Optional[dict] = None,
                        ) -> Tuple[Dict[int, DisaggResult], PrefillStats]:
    """The two-fleet topology in one process: an :class:`InProcTransport`
    pair, the decode worker on its own thread, both engines on one
    device.  Returns (results by rid, prefill-side wire stats); both
    engines are shut down.

    On the card the engines share no lock: the launch registry keeps each
    thread's counts apart, and the decode engine's graph captures (thread
    local, on a non-blocking stream) admit the prefill thread's launches
    and copies.  A device-wide synchronisation (``torch.cuda.synchronize``,
    ``torch.cuda.empty_cache``) in any thread while a capture is open
    invalidates it, so neither engine makes one, and a caller that clocks
    the fleets synchronises its own stream only."""
    a, b = InProcTransport.pair()
    pre = PrefillWorker(cfg, params, a, **(prefill_kwargs or {}))
    dec = DecodeWorker(cfg, params, b, **(decode_kwargs or {}))
    errs: List[BaseException] = []

    def _decode():
        try:
            dec.run()
        except BaseException as e:            # surfaces after join
            errs.append(e)
            b.close()                         # unblocks the collector

    t = threading.Thread(target=_decode, name="decode-fleet", daemon=True)
    t.start()
    try:
        for req in requests:
            pre.submit(req)
        stats = pre.run()
        try:
            results = pre.collect(len(requests))
        except TransportError:
            if errs:                          # the root cause, not the close
                raise errs[0]
            raise
        stats.wire_seconds = a.send_seconds
        stats.transport = a.name
    finally:
        t.join(timeout=600.0)
        pre.engine.shutdown()
        dec.engine.shutdown()
    if t.is_alive():
        raise RuntimeError("the decode fleet's thread outlived its join")
    if errs:
        raise errs[0]
    return results, stats
