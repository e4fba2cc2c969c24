"""Continuous-batching serving engine — a three-stage pipeline over a
class-partitioned TABM pool, batched at every stage:

    producer threads (StagingWorker,         consumer (step loop)
    one per slot class)                      ---------------------
    ------------------------------           plan.consume (per-slot,
    microbatch: vision frontend +            per-class ready wait) ->
    projector as ONE batched call ->         grouped batch-B prefill ->
    plan.produce_many -> ONE strided         PagedKVCache.insert_many ->
    class-slab ring commit (blocks on        cohort decode (fused
    class FULL = per-class backpressure)     kernels on the card)

The port of the reference's engine: the same staging, class-aware
admission (staged-ahead depth and KV-block budgets per slot class, both
shed high-resolution-first by the battery knobs), bucketed batched
prefill, power-of-2 cohort decode over the paged pool, shared staging of
identical vision bytes, cross-class aging and backend demotion.  The
reference's per-bucket ``jax.jit`` prefill executables are plain eager
calls here; its per-bucket decode executables (``_cohort_fn``) are CUDA
graphs on the card.

Decode runs ``kernels/fused_decode.cohort_step``: on the card a
fused-supported config decodes through the fused step (the Hopper
fused-QKV, fused-MLP and KV-row-scatter kernels) unless the caller passes
``use_fused=False`` for the composed step (softmax caches written by the
cache-row-update kernel, the pool by the KV-row scatter, slot state by an
in-place scatter).  On the card every decode step replays the step
captured as one CUDA graph for its cohort bucket
(``serving/cohort_graph.CohortGraph``, captured at the bucket's first
step, dropped at ``shutdown``); there is no eager fallback.  On the CPU
the step runs eagerly, its wrappers taking their plain versions.

The engine runs on ``device`` — the card unless the caller passes
``device="cpu"``.  For disaggregated fleets (``serving/disagg.py``) a
prefill engine runs admission rounds without decoding (``prefill_step``)
and hands each prefilled request off as a ``core/transport.
RemotePrefill`` (``export_remote``); a decode engine admits such a
request straight into its pool (``admit_remote``) and decodes it with
the unmodified ``step``.
"""
from __future__ import annotations

import hashlib
import queue
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bricks import decompose
from repro_torch.core.plan import compile_plan
from repro_torch.core.power import BatteryAwareExecutor, PMU, PowerState
from repro_torch.core.quantize import QTensor, tree_bytes
from repro_torch.core.scheduler import (brick_cost, class_staging_budgets,
                                        kv_block_budgets)
from repro_torch.core.tabm import SlotClassPool, TABMError
from repro_torch.core.transport import RemotePrefill
from repro_torch.kernels.fused_decode import cohort_step, fused_supported
from repro_torch.models import decoder as dec
from repro_torch.models.linear_attention import \
    PREFILL_CHUNK as LINEAR_PREFILL_CHUNK
from repro_torch.models import model as M
from repro_torch.serving.cohort_graph import CohortGraph
from repro_torch.serving.kv_cache import PagedKVCache, bucket_length
from repro_torch.serving.sampling import greedy, sample
from repro_torch.telemetry.calibration import CostCalibration
from repro_torch.telemetry.ledger import Ledger
from repro_torch.telemetry.probes import WallProbe
from repro_torch.tree import tree_map

EOS_ID = 1


class TraceEvent(NamedTuple):
    """One engine lifecycle event, stamped with ``time.monotonic()`` at
    record time — monotonic so producer-thread and step-loop events
    interleave in true order (the telemetry ledger's wall-time probes
    anchor to the same clock).  Tuple-compatible: existing consumers
    unpack ``(event, rid, t)``."""

    event: str
    rid: int
    t: float


class EngineClosed(RuntimeError):
    """The engine shut down before this request could complete."""


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                     # prompt token ids
    vision_feats: Optional[np.ndarray] = None
    n_images: int = 1                      # images the vision feats cover
    max_new_tokens: int = 32
    temperature: float = 0.0
    submit_t: float = field(default_factory=time.time)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    out_tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None                 # KV-cache slot once admitted
    tabm_slot: Optional[int] = None            # class-ring slot once staged
    slot_class: Optional[str] = None           # TABM class, set at submit
    stage_submitted: bool = False              # handed to the StagingWorker
    aging: int = 0                             # admission rounds spent queued
                                               # (cross-class KV reservation
                                               # once >= engine.aging_steps)
    error: Optional[BaseException] = None      # staging/engine failure
    # committed TABM slab, trimmed to its token count, copied to the host
    # at vision bind when the engine runs capture_slab=True (the prefill
    # fleet: the slab rides the wire so the hand-off is self-contained)
    slab: Optional[torch.Tensor] = field(default=None, repr=False)
    # staged-slab sharing: identical vision bytes stage once.  share_of
    # points at the request that owns the staging; the owner's sharers
    # list is granted refcounted views of its slot at bind time
    share_of: Optional["Request"] = None
    sharers: List["Request"] = field(default_factory=list, repr=False)
    _share_key: Optional[tuple] = None
    _tabm_gen: Optional[int] = None            # seqlock gen at consume
    _staged_ev: threading.Event = field(default_factory=threading.Event,
                                        repr=False)

    @property
    def staged(self) -> bool:
        """Producer half already ran (committed or failed).  Derived from
        the event so the admission check and the idle park can never
        desynchronize."""
        return self._staged_ev.is_set()

    @property
    def e2e_latency(self) -> Optional[float]:
        return None if self.finish_t is None else self.finish_t - self.submit_t


@dataclass
class EngineStats:
    decoded_tokens: int = 0
    prefills: int = 0
    steps: int = 0
    finished: int = 0
    failed: int = 0
    start_t: float = field(default_factory=time.time)

    def tokens_per_s(self) -> float:
        dt = time.time() - self.start_t
        return self.decoded_tokens / dt if dt > 0 else 0.0


_STOP = object()


class StagingWorker:
    """The pipeline's producer stage: one thread *per slot class*, each
    draining its class's hand-off queue into **microbatches** through
    ``plan.produce_many`` — one batched vision-encode+projector call and
    one strided slab commit per drain, up to ``stage_batch(cls)`` requests
    (the battery-scaled ``Knobs.max_stage_batch`` × the arch's
    ``max_stage_batch``, clamped to the class ring's capacity).

    The worker owns the ring-write side of the TABM contract, per class:
    a class thread blocks *inside* ``acquire_write_many`` on its own FULL
    ring (so backpressure stalls exactly that class's producer — never
    the decode loop, never another class's staging), aborts the whole
    slab if a brick raises — then **isolates** the failure by restaging
    the microbatch one request at a time, so one request's bad input
    fails only its owner, never its batchmates — and attaches any
    failure to the originating request before flagging it staged.
    ``shutdown`` closes the pool first — waking every stalled class
    thread — then joins them all; requests still queued at that point
    are cancelled with :class:`EngineClosed`.

    ``classes=(None,)`` (the default) degenerates to the single-ring,
    single-thread pipeline; ``stage_batch=None`` to K=1 staging."""

    def __init__(self, plan, trace, classes=(None,), stage_batch=None):
        self.plan = plan
        self._trace = trace                     # (event, rid) -> None
        self._classes = tuple(classes)
        self._stage_batch = stage_batch         # (slot_class) -> int | None
        self._qs: Dict[Optional[str], "queue.Queue"] = {
            c: queue.Queue() for c in self._classes}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # handed over, not yet staged — charged per class at hand-off
        self._in_flight: Dict[Optional[str], int] = {
            c: 0 for c in self._classes}
        self._threads: Dict[Optional[str], threading.Thread] = {}

    def in_flight(self, slot_class: Optional[str] = None) -> int:
        with self._lock:
            return self._in_flight[slot_class]

    def in_flight_by_class(self) -> Dict[Optional[str], int]:
        with self._lock:
            return dict(self._in_flight)

    def start(self, slot_class: Optional[str] = None):
        if slot_class not in self._threads:
            name = "tabm-staging" if slot_class is None \
                else f"tabm-staging[{slot_class}]"
            t = threading.Thread(target=self._run, args=(slot_class,),
                                 name=name, daemon=True)
            self._threads[slot_class] = t
            t.start()

    def submit(self, reqs):
        """Hand one request — or one list of same-class requests, the
        admission round's microbatch — to the owning class thread."""
        batch = reqs if isinstance(reqs, list) else [reqs]
        if not batch:
            return
        if self._stop.is_set():
            raise EngineClosed("staging worker already shut down")
        cls = batch[0].slot_class
        if any(r.slot_class != cls for r in batch):
            raise EngineClosed("a staging microbatch must be one class")
        if cls not in self._qs:
            raise EngineClosed(f"no staging queue for slot class {cls!r}")
        self.start(cls)
        with self._lock:
            self._in_flight[cls] += len(batch)
        self._qs[cls].put(batch)

    def _cap(self, slot_class: Optional[str]) -> int:
        if self._stage_batch is None:
            return 1
        return max(1, int(self._stage_batch(slot_class)))

    def _run(self, slot_class: Optional[str]):
        q = self._qs[slot_class]
        pending: "deque[Request]" = deque()
        stop_seen = False
        while True:
            if not pending:
                item = q.get()
                if item is _STOP:
                    break
                pending.extend(item if isinstance(item, list) else [item])
            while True:                        # opportunistic drain, no block
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_seen = True
                    break
                pending.extend(nxt if isinstance(nxt, list) else [nxt])
            cap = self._cap(slot_class)        # battery-scaled, per drain
            batch = [pending.popleft()
                     for _ in range(min(cap, len(pending)))]
            self._stage_batch_now(slot_class, batch)
            if stop_seen and not pending:
                break

    def _stage_batch_now(self, slot_class: Optional[str],
                         batch: List[Request]):
        """One microbatch through produce_many: K FIFO slots, one batched
        projector call, one strided slab commit; per-request commit
        events so consumers see the same per-slot signals as K=1."""
        try:
            if self._stop.is_set():
                raise EngineClosed("engine shut down before staging")
            for req in batch:
                self._trace("stage_start", req.rid)
            slots = self.plan.produce_many(
                [{"vision_feats": torch.as_tensor(r.vision_feats)}
                 for r in batch],
                slot_class=slot_class, block=True)
            if slots is None:                  # ring closed mid-stall
                raise EngineClosed("ring closed while staging stalled")
            for req, slot in zip(batch, slots):
                req.tabm_slot = slot
                self._trace("stage_commit", req.rid)
            if len(batch) > 1:                 # the acceptance evidence
                self._trace("slab_commit", len(batch))
        except BaseException as e:
            if len(batch) > 1 and not isinstance(e, EngineClosed):
                # the slab was aborted whole (abort-all-on-failure);
                # isolate the bad request by restaging one at a time so
                # the error lands only on its owner
                self._restage_isolated(slot_class, batch)
            else:
                for req in batch:              # propagate to the request(s)
                    req.error = e
                    self._trace("stage_error", req.rid)
        finally:
            with self._lock:
                self._in_flight[slot_class] -= len(batch)
            for req in batch:
                req._staged_ev.set()            # marks staged

    def _restage_isolated(self, slot_class: Optional[str],
                          batch: List[Request]):
        for req in batch:
            try:
                if self._stop.is_set():
                    raise EngineClosed("engine shut down before staging")
                slot = self.plan.produce(
                    {"vision_feats": torch.as_tensor(req.vision_feats)},
                    slot_class=slot_class, block=True)
                if slot is None:
                    raise EngineClosed("ring closed while staging stalled")
                req.tabm_slot = slot
                self._trace("stage_commit", req.rid)
            except BaseException as e:
                req.error = e
                self._trace("stage_error", req.rid)

    def shutdown(self, timeout: float = 10.0) -> bool:
        """Stop accepting, cancel in-flight staging, join every class
        thread.  Returns True when all threads are fully dead (no daemon
        leak)."""
        self._stop.set()
        if self.plan.tabm is not None:
            self.plan.tabm.close()        # wakes every class's FULL stall
        threads = list(self._threads.items())
        for cls, _ in threads:
            self._qs[cls].put(_STOP)
        deadline = time.monotonic() + timeout
        alive = False
        for _, t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
            alive = alive or t.is_alive()
        return not alive


class ServingEngine:
    """Decoder-only (dense / vlm / ssm) continuous-batching engine."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 8,
                 max_len: int = 2048, executor: Optional[
                     BatteryAwareExecutor] = None,
                 rng_seed: int = 0, async_staging: bool = True,
                 placement=None, accels=None,
                 backend=None, stage_batch: Optional[int] = None,
                 aging_steps: int = 32, block_size: int = 64,
                 kv_blocks: Optional[int] = None,
                 max_cohort: Optional[int] = None,
                 share_staged: bool = True,
                 use_fused: Optional[bool] = None,
                 capture_slab: bool = False,
                 calibration: Optional[CostCalibration] = None,
                 device="cuda"):
        if cfg.encdec:
            raise ValueError("the engine serves decoder-only archs")
        dec.check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        # weights live on the engine's device (a no-op when they already do)
        self.params = tree_map(
            lambda l: l.to(self.device)
            if isinstance(l, (torch.Tensor, QTensor)) else l, params)
        # cohort decode: the fused step (Hopper kernels on the card) for
        # fused-supported configs; False = the composed path
        self.use_fused = (fused_supported(cfg) if use_fused is None
                          else bool(use_fused))
        self.slots = PagedKVCache(cfg, n_slots, max_len,
                                  block_size=block_size,
                                  total_blocks=kv_blocks, device=self.device)
        self.max_len = max_len
        self.max_cohort = max_cohort
        self._rotate = 0
        # the cohort step per bucket (``_cohort_fn``); on the card the
        # CUDA graphs share one memory pool and one capture stream
        self._cohort_cache: Dict[int, object] = {}
        self._graph_pool = self._capture_stream = None
        self.graph_stats = {"captures": 0, "replays": 0, "capture_s": 0.0}
        self.executor = executor or BatteryAwareExecutor(PMU())
        self._stage_batch_override = stage_batch
        self.aging_steps = aging_steps
        self.queue: List[Request] = []
        self.live: Dict[int, Request] = {}      # slot -> request
        self.done: List[Request] = []
        self.stats = EngineStats()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self.trace: "deque[TraceEvent]" = deque(maxlen=4096)
        # wall-time probe: per-brick staging spans (via the plan) + the
        # engine's prefill/decode spans, each ending at a host sync the
        # loop already pays (first-token / sampled-token reads)
        self.probe = WallProbe()
        # ``calibration`` (optional, e.g. a previous run's measured table)
        # lets admission price KV budgets from observation
        # (_kv_energy_pressure)
        self.calibration = calibration
        self._kv_pressure: Optional[float] = None
        # class-partitioned TABM pool between the vision side and the
        # decoder (vlm archs): one class-sized ring per image-count x
        # resolution bucket
        self.tabm = SlotClassPool.from_config(
            cfg, dim=cfg.d_model, slots_per_class=max(2, n_slots // 2),
            device=self.device) if cfg.vlm else None
        # the one brick runtime: staging runs the plan's bricks up to the
        # TABM edge.  A placement (``core/scheduler.schedule``) lowers each
        # brick through its unit's backend; the ``device`` row, and every
        # brick when there is no placement, lowers to the engine's device
        self.plan = compile_plan(
            decompose(cfg), self.params, tabm=self.tabm, backend=backend,
            placement=placement, accels=accels, probe=self.probe,
            device=self.device)
        self._lowered_backends = {s.brick.name: s.backend
                                  for s in self.plan.steps}
        self._demoted_to: Optional[str] = None
        self.async_staging = bool(async_staging and self.tabm is not None)
        self._worker = None
        if self.async_staging:
            # the worker references the engine only weakly, and a
            # finalizer joins its threads for callers that skip shutdown()
            wself = weakref.ref(self)

            def _trace(event, rid):
                eng = wself()
                if eng is not None:
                    eng._trace_event(event, rid)

            def _stage_cap(slot_class):
                eng = wself()
                return 1 if eng is None else eng._class_stage_batch(
                    slot_class)

            self._worker = StagingWorker(
                self.plan, _trace, classes=tuple(self.tabm.names()),
                stage_batch=_stage_cap)
            self._finalizer = weakref.finalize(
                self, StagingWorker.shutdown, self._worker, 1.0)
        self._closed = False
        self.share_staged = bool(share_staged and self.tabm is not None)
        self._stage_keys: Dict[tuple, Request] = {}
        # prefill-fleet mode: keep each request's committed slab (a host
        # copy) for the wire
        self.capture_slab = bool(capture_slab)

    # -- public api ----------------------------------------------------------
    def submit(self, req: Request):
        if self._closed:
            raise EngineClosed("engine already shut down")
        if self.tabm is None or req.vision_feats is None:
            req._staged_ev.set()           # text-only: nothing to commit
        elif req.slot_class is None:
            # classify from the vision spec (token count x image count) —
            # the request is charged against exactly this class's ring and
            # admission depth; an unservable spec fails fast, at submit
            req.slot_class = self.tabm.classify(
                int(np.asarray(req.vision_feats).shape[1]), req.n_images)
        else:
            self.tabm.ring(req.slot_class)     # unknown class fails fast
        if self.share_staged and req.vision_feats is not None:
            # staged-slab dedup: identical vision bytes (class + shape +
            # content hash) stage once; later twins take refcounted read
            # views of the owner's slot at bind time (_grant_shares)
            key = self._stage_key(req)
            req._share_key = key
            owner = self._stage_keys.get(key)
            if (owner is not None and owner.error is None
                    and owner.finish_t is None):
                req.share_of = owner
                owner.sharers.append(req)
            else:
                self._stage_keys[key] = req
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        while (self.queue or self.live) and self.stats.steps < max_steps:
            self.step()
        return self.done

    def shutdown(self, timeout: float = 10.0) -> bool:
        """Tear the pipeline down: stop+join the producer thread (a FULL
        stall is woken via ring close), drain staged-but-unconsumed slots
        back to EMPTY, and resolve every outstanding request — live
        mid-decode ones keep their partial tokens — as failed with
        EngineClosed.  Idempotent; returns True when no worker thread is
        left alive.  The cohort step's CUDA graphs and their memory are
        dropped."""
        self._closed = True
        self._cohort_cache.clear()
        self._graph_pool = self._capture_stream = None
        joined = True
        if self._worker is not None:
            joined = self._worker.shutdown(timeout)
            if joined:
                # torn down manually; a thread that outlived the join
                # timeout keeps its finalizer as the reaping safety net
                self._finalizer.detach()
        elif self.tabm is not None:
            self.tabm.close()
        if self.tabm is not None and joined:
            self.tabm.drain()              # READY/CONSUMED leftovers -> EMPTY
        for slot, req in list(self.live.items()):
            if req.error is None:
                req.error = EngineClosed("engine shut down mid-decode")
            self.slots.release(slot)
            self._fail(req)                # partial out_tokens are kept
        self.live.clear()
        while self.queue:
            req = self.queue.pop(0)
            if req.error is None:
                req.error = EngineClosed("engine shut down before admission")
            self._fail(req)
        return joined

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def _trace_event(self, event: str, rid: int):
        self.trace.append(TraceEvent(event, rid, time.monotonic()))

    def _stage_key(self, req: Request) -> tuple:
        """Dedup identity of a request's staged vision: class + slab
        shape + dtype + content hash — equal keys would commit
        byte-identical slabs, so one commit can serve all of them."""
        feats = np.asarray(req.vision_feats)
        return (req.slot_class, feats.shape, str(feats.dtype),
                hashlib.sha1(feats.tobytes()).hexdigest())

    def _prefill(self, tokens, vision_embeds, last_idx):
        """Right-padded bucket prefill of a bucket-matched group: tokens
        (B, bucket); logits read at each true prompt end (last_idx - 1).
        The cache width is the bucket rounded up to whole KV blocks, so a
        short prompt's prefill writes only the blocks its grant covers.
        ``last_idx`` is also the stack's ``valid_len``: Mamba-2 and
        linear-attention state is taken at each true prompt end, not
        after the padding (the reference engine's padding fault, ROADMAP
        §3)."""
        cfg = self.cfg
        B, S = tokens.shape
        bs = self.slots.block_size
        decode_len = -(-S // bs) * bs
        rope_fn = M.prompt_rope_fn(cfg, B, S, self.device)
        with torch.no_grad():
            x = self.params["embed"][tokens]
            if vision_embeds is not None:
                x = torch.cat([vision_embeds.to(x.dtype),
                               x[:, vision_embeds.shape[1]:]], dim=1)
            x, caches, _ = dec.stack_forward(
                self.params["layers"], cfg, x, rope_fn, causal=True,
                want_cache=True, decode_len=decode_len, valid_len=last_idx)
            x_last = x[torch.arange(B, device=self.device),
                       (last_idx - 1).to(torch.long)][:, None]
            logits = M._head(self.params, cfg, x_last)
        return logits[:, 0], {"layers": caches}

    def _cohort_bucket(self, n: int) -> int:
        """Pad the cohort to the next power of two (capped at n_slots):
        a handful of step shapes instead of one per live count."""
        return min(1 << max(0, n - 1).bit_length(), self.slots.n_slots)

    def _cohort_slots(self) -> List[int]:
        """The slots decoding this step.  Uncapped: every live slot —
        ONE batched call serves the whole fleet.  Capped (max_cohort): a
        rotating window so excluded rows are never starved."""
        slots = sorted(self.live)
        if self.max_cohort is not None and len(slots) > self.max_cohort:
            k = self._rotate % len(slots)
            slots = (slots[k:] + slots[:k])[: self.max_cohort]
            self._rotate += self.max_cohort
        return slots

    def _cohort_step(self, tokens, lengths, slot_ids, tables, pool):
        """The eager cohort step (``kernels/fused_decode.cohort_step``):
        what the CPU runs and the card captures."""
        return cohort_step(
            self.params, self.cfg, tokens, lengths, slot_ids, tables, pool,
            block_size=self.slots.block_size, paged=self.slots.paged,
            use_fused=self.use_fused)

    def _cohort_fn(self, bc: int):
        """The cohort step of bucket ``bc``, one cached callable a bucket
        as the reference's ``_cohort_fn``: on the card a
        :class:`CohortGraph` captured now on the engine's pool (a failed
        capture raises), on the CPU the eager step."""
        fn = self._cohort_cache.get(bc)
        if fn is not None:
            return fn
        if self.device.type != "cuda":
            fn = self._cohort_step
        else:
            t0 = time.perf_counter()
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
            with torch.no_grad():
                fn = CohortGraph(self._cohort_step, self.slots.pool, bc,
                                 self.slots.blocks_per_slot,
                                 self.slots.n_slots, self.slots.n_blocks,
                                 self.device, self._graph_pool,
                                 self._capture_stream)
            self.graph_stats["captures"] += 1
            self.graph_stats["capture_s"] += time.perf_counter() - t0
        self._cohort_cache[bc] = fn
        return fn

    def _decode(self, tokens, lengths, slot_ids, tables):
        """One batched cohort decode step over the paged pool, from the
        step's host arrays: each row's context gathered through its block
        table, the new K/V position written back into its current block,
        the pool written in place; padded rows carry sentinel ids (zeros
        in, nothing written).  On the card a replay of the bucket's graph
        (captured at the bucket's first step): the logits returned are its
        static buffer, which the next replay of any bucket may overwrite.
        Returns (logits, pool)."""
        fn = self._cohort_fn(int(tokens.shape[0]))
        if self.device.type != "cuda":
            with torch.no_grad():
                return fn(*(torch.from_numpy(a) for a in (
                    tokens, lengths, slot_ids, tables)), self.slots.pool)
        out = fn(tokens, lengths, slot_ids, tables, self.slots.pool)
        self.graph_stats["replays"] += 1
        return out

    def _stage(self, depth_scale: float = 1.0):
        """Synchronous fallback producer (``async_staging=False``): run the
        plan's frontend/projector stages inline for queued vlm requests,
        class by class.  A FULL class ring stalls *that class* — its
        requests keep their FIFO positions and retry next step — while
        later requests of other classes continue staging (per-class
        backpressure, never a bypass, never cross-class head-of-line
        blocking).  The battery knob gates classes exactly like the async
        hand-off: a class whose scaled depth is already met stages
        nothing this step (high-resolution classes shed first)."""
        if self.tabm is None:
            return
        table = self.tabm.admission_table(depth_scale)
        stalled: set = set()                   # classes FULL this pass
        for req in self.queue:
            if req.staged or req.vision_feats is None \
                    or req.share_of is not None:
                continue
            if req.slot_class in stalled:      # keep FIFO within the class
                continue
            ring, cap = table[req.slot_class]
            staged_now = ring.staged_ahead() if ring is not None else 0
            if cap < self.tabm.max_ahead(req.slot_class) \
                    and staged_now >= cap:
                # the *throttle* binds (scaled depth met) — skip the class
                # without touching the ring; plain FULL still goes through
                # produce below so backpressure stalls are observable
                stalled.add(req.slot_class)
                continue
            if not req.stage_submitted:    # one stage_start per request,
                req.stage_submitted = True  # even across FULL-stall retries
                self._trace_event("stage_start", req.rid)
            try:
                slot = self.plan.produce(
                    {"vision_feats": torch.as_tensor(req.vision_feats)},
                    slot_class=req.slot_class)
            except Exception as e:             # surface on the owning request
                req.error = e
                req._staged_ev.set()            # marks staged
                self._trace_event("stage_error", req.rid)
                continue
            if slot is None:                   # class FULL -> stall the class
                stalled.add(req.slot_class)
                continue
            req.tabm_slot = slot
            req._staged_ev.set()           # marks staged
            self._trace_event("stage_commit", req.rid)

    def _class_stage_batch(self, slot_class: Optional[str]) -> int:
        """The effective staging microbatch for one class *right now*:
        the engine override, else min(arch ``max_stage_batch``, battery
        ``Knobs.max_stage_batch``) — THROTTLED shrinks the batch before
        any depth sheds — clamped to the class ring's capacity (a slab
        larger than the ring could never commit)."""
        if self._stage_batch_override is not None:
            cap = self._stage_batch_override
        else:
            _, knobs, _ = self.executor.current()
            cap = min(self.cfg.max_stage_batch, knobs.max_stage_batch)
        if self.tabm is not None and slot_class is not None:
            cap = min(cap, self.tabm.classes[slot_class].n_slots)
        return max(1, cap)

    def _feed_staging(self, knobs=None):
        """Admission's producer hand-off, charged per class *and per
        microbatch*: each round, every class collects its eligible queued
        requests — up to its staged-ahead depth budget
        (core/scheduler.class_staging_budgets), itself capped at one
        staging microbatch — and hands them to its class thread as ONE
        list, which the worker commits as one strided slab
        (``produce_many``).  The depth cap is each class's own
        ``max_ahead`` — by default the class ring's capacity, so the
        hand-off queue is bounded by the ring and shutdown cancellation
        stays cheap — scaled by the battery knob ``class_depth_scale``
        (high-resolution classes shrink first; the microbatch shrinks
        before that).  A class with no budget (FULL, throttled, or
        saturated hand-off) is simply skipped; later requests of other
        classes still hand off — the class isolation the single FIFO cap
        could not give."""
        if knobs is None:
            _, knobs, _ = self.executor.current()
        # the battery knobs are constant within one admission round: read
        # them once (the caller's copy), clamp per class against the
        # static ring capacities — never re-poll the executor per request
        if self._stage_batch_override is not None:
            global_cap = max(1, self._stage_batch_override)
        else:
            global_cap = max(1, min(self.cfg.max_stage_batch,
                                    knobs.max_stage_batch))
        budgets = class_staging_budgets(
            self.tabm, self._worker.in_flight_by_class(),
            knobs.class_depth_scale, stage_batch=global_cap)
        groups: Dict[str, List[Request]] = {}
        for req in self.queue:
            if req.staged or req.stage_submitted \
                    or req.vision_feats is None or req.share_of is not None:
                continue
            # budgets are already microbatch- and ring-capacity-capped
            if len(groups.get(req.slot_class, ())) >= \
                    budgets.get(req.slot_class, 0):
                continue                       # class exhausted; others go on
            req.stage_submitted = True
            groups.setdefault(req.slot_class, []).append(req)
        for batch in groups.values():          # one hand-off = one microbatch
            self._worker.submit(batch)

    def _ring_of(self, req: Request):
        """The class ring holding this request's staged embeds."""
        return self.tabm.ring(req.slot_class)

    def _bind_vision(self, req: Request) -> Optional[torch.Tensor]:
        """Consumer half: per-slot ready wait on the request's class ring,
        then bind that ring's oldest READY slot as the prefill's vision
        input.  FIFO commit order == FIFO admission order *within a
        class*, so the bound slot is this request's; the seqlock
        generation is captured so release can assert the zero-copy view
        stayed valid across the prefill."""
        if req.tabm_slot is None:
            return None
        if req.share_of is not None:
            # refcounted read view of the owner's consumed slot — the
            # slab was staged once, this request never touched the ring
            got = self.plan.shared_view(req.tabm_slot, req._tabm_gen,
                                        slot_class=req.slot_class)
            if got is None:
                raise TABMError(
                    f"shared slot {req.tabm_slot} ({req.slot_class}) "
                    f"recycled before request {req.rid} bound its view")
            view, n = got
            if self.capture_slab:
                req.slab = view[:n].to("cpu", copy=True)
            return view[None, :n]
        # normally immediate — admission only runs once `staged` is set,
        # which the worker sets strictly after commit — but this is the
        # formal consumer-side gate (and the blocking point if admission
        # ever runs ahead of the staged flag)
        if not self.plan.wait_ready(req.tabm_slot, timeout=30.0,
                                    slot_class=req.slot_class):
            raise TABMError(
                f"slot {req.tabm_slot} ({req.slot_class}) did not become "
                f"READY (aborted, ring closed, or timed out)")
        got = self.plan.consume(slot_class=req.slot_class)
        if got is None or got[0] != req.tabm_slot:
            # enforced with a real raise (not assert): this is the
            # per-class FIFO contract the zero-copy hand-off stands on
            raise TABMError(
                f"consume returned {got and got[0]}, expected request "
                f"{req.rid}'s slot {req.tabm_slot} of class "
                f"{req.slot_class} (per-class FIFO order broken)")
        slot, view, n = got
        req._tabm_gen = self._ring_of(req).slot_generation(slot)
        self._grant_shares(req, slot)
        if self.capture_slab:
            req.slab = view[:n].to("cpu", copy=True)
        return view[None, :n]

    def _grant_shares(self, owner: Request, slot: int):
        """The owner's slab just got consumed: grant every waiting twin
        a refcounted view of the same slot (tabm.addref) so they admit
        without ever staging.  A twin the addref misses (slot already
        on its way out) falls back to staging privately."""
        if owner._share_key is not None and \
                self._stage_keys.get(owner._share_key) is owner:
            self._stage_keys.pop(owner._share_key)
        for s in owner.sharers:
            if (s.error is not None or s.finish_t is not None
                    or s.share_of is not owner):
                continue
            if self.plan.addref(slot, owner._tabm_gen,
                                slot_class=owner.slot_class):
                s.tabm_slot = slot
                s._tabm_gen = owner._tabm_gen
                s._staged_ev.set()         # admissible, no staging needed
                self._trace_event("stage_share", s.rid)
            else:
                s.share_of = None          # stage privately instead
        owner.sharers = []

    def _unshare(self, req: Request):
        """A request leaves the dedup registry (failed or shut down):
        sharers not yet granted a view go back to staging privately."""
        if req._share_key is not None and \
                self._stage_keys.get(req._share_key) is req:
            self._stage_keys.pop(req._share_key)
        for s in req.sharers:
            if s.share_of is req and s.tabm_slot is None:
                s.share_of = None
        req.sharers = []

    def _fail(self, req: Request):
        self._unshare(req)
        req.finish_t = req.finish_t or time.time()
        self.stats.failed += 1
        self._trace_event("failed", req.rid)
        self.done.append(req)

    def _apply_backend_knobs(self, knobs):
        """The PowerPolicy re-lowering hook: demote the static-shape
        (encoder-side) bricks to the knob's cheaper backend under deep
        THROTTLED, and restore the original substrate when charge
        recovers.  plan.relower swaps each step atomically, so the
        staging thread's in-flight produce is never torn."""
        target = knobs.backend_demotion
        if target == self._demoted_to:
            return
        for s in list(self.plan.steps):
            if not s.brick.static_shape:
                continue
            self.plan.relower(
                s.brick.name,
                target if target is not None
                else self._lowered_backends[s.brick.name])
        self._demoted_to = target
        self._trace_event(f"relower:{target or 'restore'}", -1)

    def _group_key(self, req: Request):
        """Bucket-match key for grouped prefill: requests sharing a
        prompt bucket and an identical vision spec (class + staged token
        count — one slab shape, one prefill shape) may
        prefill as one batch.  Text-only requests group by bucket."""
        bucket = bucket_length(len(req.tokens), buckets=self._buckets())
        vis = None
        if self.tabm is not None and req.vision_feats is not None:
            vis = (req.slot_class,
                   int(np.asarray(req.vision_feats).shape[1]))
        return (bucket, vis)

    def _admissible(self, req: Request) -> bool:
        return not (self.tabm is not None and req.vision_feats is not None
                    and not req.staged)

    def _block_need(self, req: Request) -> int:
        """KV blocks this request's lifetime needs: the block-aligned
        prompt bucket (the prefill writes that many), grown to cover
        max_new_tokens of decode, capped at a full slot's worth."""
        bs = self.slots.block_size
        bucket = bucket_length(len(req.tokens), buckets=self._buckets())
        aligned = -(-bucket // bs) * bs
        want = max(aligned,
                   min(self.max_len, len(req.tokens) + req.max_new_tokens))
        return min(self.slots.blocks_per_slot, -(-want // bs))

    def _collect_group(self, i: int, max_n: int,
                       kv_budget: Optional[int] = None) -> List[Request]:
        """Pop the maximal run of *consecutive* bucket-matched admissible
        requests starting at queue position i (consecutive, so per-class
        ring-FIFO consume order and overall admission FIFO both hold).
        The run also stops where its cumulative KV-block need would
        outrun the free pool (or the class's battery-scaled block
        budget) — the caller admits what fits, the rest keeps FIFO."""
        key = self._group_key(self.queue[i])
        blocks_left = self.slots.free_block_count
        if kv_budget is not None:
            blocks_left = min(blocks_left, kv_budget)
        blocks_left -= self._block_need(self.queue[i])
        j = i + 1
        while j < len(self.queue) and j - i < max_n:
            nxt = self.queue[j]
            if (nxt.error is not None or not self._admissible(nxt)
                    or self._group_key(nxt) != key):
                break
            need = self._block_need(nxt)
            if need > blocks_left:
                break
            blocks_left -= need
            j += 1
        group = self.queue[i:j]
        del self.queue[i:j]
        return group

    def _admit_group(self, group: List[Request]):
        """One batch-B prefill call for a bucket-matched group: bind each
        request's staged slab view (class-FIFO consume order == group
        order), run the bucket prefill once over the stacked
        batch, then write all B prefilled caches into B KV slots in a
        single strided ``insert_many``.  On any failure the whole group
        fails: every KV slot and every consumed ring slot is released —
        nothing leaks, the engine keeps serving.  Unlike the staging
        side there is no one-by-one retry: the ring slots were already
        consumed, so releasing them destroys the staged vision (a retry
        would need a full restage), and a prefill-time failure is
        batch-level in practice — the per-request inputs (bucketed int
        tokens, validated slab views) cannot individually fail a
        prefill call."""
        t0 = time.perf_counter()
        taken: List[int] = []
        try:
            for req in group:
                slot = self.slots.take_slot()
                if slot is None:               # sized by the caller; defensive
                    raise RuntimeError("KV slots exhausted mid-group")
                taken.append(slot)
                # the lifetime block grant, charged to the class — the
                # caller (_collect_group) sized the group to fit
                self.slots.grant_blocks(slot, self._block_need(req),
                                        slot_class=req.slot_class)
            B = len(group)
            bucket = self._group_key(group[0])[0]
            padded = np.zeros((B, bucket), np.int32)
            lens = np.zeros((B,), np.int32)
            for b, req in enumerate(group):
                prompt = np.asarray(req.tokens, np.int32)
                padded[b, :len(prompt)] = prompt   # right-pad into the bucket
                lens[b] = len(prompt)
            views = [v for v in (self._bind_vision(r) for r in group)
                     if v is not None]
            vision = torch.cat(views, dim=0) if views else None
            logits, cache = self._prefill(
                torch.from_numpy(padded).to(self.device), vision,
                torch.from_numpy(lens).to(self.device))
            for req in group:                  # prefill consumed the views
                if req.tabm_slot is not None:
                    if not self._ring_of(req).view_valid(req.tabm_slot,
                                                         req._tabm_gen):
                        raise TABMError(
                            f"slot {req.tabm_slot} recycled under request "
                            f"{req.rid}'s zero-copy view (seqlock "
                            f"violation)")
                    self.plan.release(req.tabm_slot,
                                      slot_class=req.slot_class)
        except Exception as e:
            # neither a KV slot nor a ring slot may leak, and every
            # request must still be accounted for (e.g. the ring closed
            # under a concurrent shutdown mid-admission): fail the group,
            # keep serving
            for req in group:
                if req.tabm_slot is None:
                    pass
                elif (req._tabm_gen is not None
                        and self._ring_of(req).view_valid(req.tabm_slot,
                                                          req._tabm_gen)):
                    self.plan.release(req.tabm_slot,   # consumed, unreleased
                                      slot_class=req.slot_class)
                elif req._tabm_gen is None:
                    # staged but never consumed (a bind earlier in the
                    # group raised): its committed slot is the class
                    # ring's oldest READY — pull it out and release, or
                    # an ownerless slot would wedge every later same-
                    # class consume (per-class FIFO).  A closed ring
                    # (consume -> None) is drained at shutdown instead.
                    got = self.plan.consume(slot_class=req.slot_class)
                    if got is not None and got[0] == req.tabm_slot:
                        self.plan.release(got[0], slot_class=req.slot_class)
                req.error = e
                self._fail(req)
            for slot in taken:
                self.slots.release(slot)
            return
        self.slots.insert_many(taken, cache, [int(n) for n in lens])
        # first token from each request's row of the prefill logits (the
        # one host read of the group: the prefill has finished after it)
        toks = self._pick_rows(logits, group)
        for slot, req, tok in zip(taken, group, toks):
            req.slot = slot
            self.live[slot] = req
            self.stats.prefills += 1
            self._trace_event("prefill", req.rid)
            req.out_tokens.append(tok)
            req.first_token_t = time.time()
        if len(group) > 1:                     # the acceptance evidence
            self._trace_event("prefill_batch", len(group))
        # measured prefill span: ends past insert_many and the first-token
        # reads, so device work is complete — true wall time of the group
        self.probe.record("decoder", "prefill", time.perf_counter() - t0,
                          tokens=int(lens.sum()))

    def _admit(self):
        state, knobs, _ = self.executor.current()
        self._apply_backend_knobs(knobs)
        power_ok = (knobs.admission_rate > 0
                    or state is PowerState.UNCONSTRAINED)
        if power_ok:
            if self._worker is not None:
                # producer threads run ahead, charged per class and scaled
                # by the battery knob (batch shrinks first, then high-res
                # classes shed depth)
                self._feed_staging(knobs)
            else:
                # sync fallback: inline, same per-class battery gating —
                # the equivalence oracle throttles like the async path
                self._stage(knobs.class_depth_scale)
        budget = min(len(self.slots.free), knobs.max_batch)
        if not power_ok:
            budget = 0
        # per-class KV *block* budgets, battery-scaled exactly like the
        # staging depth (shed_scales): under THROTTLED the hi-res
        # classes' share of the paged pool shrinks first, so expensive
        # long-context grants are shed while thumbnails keep admitting
        kv_budgets = None
        if self.tabm is not None:
            kv_budgets = kv_block_budgets(
                self.tabm, self.slots.n_blocks, self.slots.used_blocks,
                knobs.class_kv_scale,
                energy_pressure=self._kv_energy_pressure())
        # cross-class aging: classes of requests that have waited out
        # aging_steps admission rounds while skipped (class stalled or
        # slow); each holds one KV-slot reservation that newer requests
        # of OTHER classes may not take — a thumbnail flood can no longer
        # absorb every freed slot while a hi-res head waits.  A class the
        # battery policy deliberately shed (depth gated to zero) earns no
        # reservation: fairness must not undo the power policy's choice
        # to keep cheap classes flowing.
        shed: set = set()
        if self.tabm is not None:
            shed = {name for name, (_, cap) in self.tabm.admission_table(
                knobs.class_depth_scale).items() if cap <= 0}
        # ONE reservation per aged class, not per aged request: a class
        # admits FIFO, so one held slot guarantees its aged head makes
        # progress, while a deeply-backlogged class can never reserve the
        # whole KV pool away from everyone else
        aged_classes: set = set()
        # classes with a request skipped earlier in THIS pass: later
        # classmates must be skipped too, even if their staged flag reads
        # True by now — admission samples `staged` at different times per
        # request, and admitting a younger classmate whose older sibling
        # was mid-staging a moment ago would consume the sibling's ring
        # slot (per-class FIFO violation)
        stalled: set = set()
        i = 0
        while i < len(self.queue) and budget > 0:
            req = self.queue[i]
            if not self._admissible(req) or (
                    req.vision_feats is not None
                    and req.slot_class in stalled):
                # this request's class producer is stalled (FULL ring,
                # throttled depth, or an earlier classmate this pass) —
                # skip it, keep its FIFO position, and let staged
                # requests of *other* classes admit behind it: a stalled
                # high-res class never blocks thumbnails
                stalled.add(req.slot_class)
                req.aging += 1                 # a real skip, not residency
                if req.aging >= self.aging_steps \
                        and req.slot_class not in shed:
                    aged_classes.add(req.slot_class)
                i += 1
                continue
            # error is read only after the staged flag: the worker stores
            # error before staged=True, so a failed request can never slip
            # through as staged-with-no-slot and prefill without vision
            if req.error is not None:          # staging failed: finish failed
                self.queue.pop(i)
                self._fail(req)
                continue
            # KV slots reserved by aged classes other than this request's
            # stay free for them (their class may stage any round now)
            reserved = sum(1 for c in aged_classes if c != req.slot_class)
            avail = len(self.slots.free) - reserved
            if avail <= 0:
                if req.vision_feats is not None:
                    stalled.add(req.slot_class)    # keep class FIFO
                req.aging += 1
                i += 1                         # reserved: skip, keep position
                continue
            # paged-KV admission: the head's lifetime block need must fit
            # the class's battery-scaled share (hi-res classes shed
            # first) AND the free pool; a gated head keeps its FIFO
            # position — blocks freed by any finishing request are
            # grantable the very next round (continuous batching)
            need = self._block_need(req)
            kv_cap = (kv_budgets.get(req.slot_class)
                      if kv_budgets is not None
                      and req.vision_feats is not None else None)
            if kv_cap is not None and need > kv_cap:
                stalled.add(req.slot_class)    # keep class FIFO
                req.aging += 1
                self._trace_event("kv_gated", req.rid)
                i += 1
                continue
            if need > self.slots.free_block_count:
                if req.vision_feats is not None:
                    stalled.add(req.slot_class)
                req.aging += 1
                i += 1
                continue
            group = self._collect_group(i, min(budget, avail),
                                        kv_budget=kv_cap)
            budget -= len(group)
            self._admit_group(group)
            # queue shrank at position i: the next candidate is at i again
        if not self.live and self.queue:
            waiter = None
            if self._worker is not None:
                # idle consumer waiting on the producer: park briefly on
                # the first pending staged event instead of hot-spinning
                # the loop (only stage_submitted requests qualify — the
                # worker WILL stage those; gated heads won't set it)
                waiter = next((r for r in self.queue
                               if r.error is None and r.stage_submitted
                               and not r.staged), None)
            if waiter is not None:
                waiter._staged_ev.wait(0.05)
            elif not any(r.staged and r.error is None for r in self.queue):
                # nothing live, nothing admissible, nothing being staged —
                # every queued request is power- or class-depth-gated.
                # Breathe instead of hot-spinning the step loop at full
                # CPU (which would burn the very battery the throttle is
                # conserving) until charge recovers.
                time.sleep(0.005)

    def _pick_rows(self, logits, reqs: List[Request]) -> List[int]:
        """Next token of each request from its row of ``logits``: greedy
        rows by one argmax over all rows (one host read), temperature
        rows drawn with the engine's generator."""
        top1 = greedy(logits[:len(reqs)]).tolist()
        out = []
        for b, req in enumerate(reqs):
            if req.temperature == 0.0:
                out.append(int(top1[b]))
            else:
                out.append(int(sample(logits[b:b + 1], self.generator,
                                      temperature=req.temperature)[0]))
        return out

    def _buckets(self):
        caps = [b for b in (128, 256, 512, 1024, 2048, 4096)
                if b <= self.max_len - 1]
        if caps:
            return tuple(caps)
        # one short bucket: a chunked slot-state mixer's prefill takes a
        # whole number of chunks (or one chunk), so its bucket is rounded
        # up to the chunk; its pool has no length axis for it to outgrow
        b, chunk = self.max_len - 1, self._prefill_chunk()
        if chunk and b > chunk and b % chunk:
            b = -(-b // chunk) * chunk
        return (b,)

    def _prefill_chunk(self) -> Optional[int]:
        """The chunk of a chunked slot-state mixer's prefill (Mamba-2's
        SSD, linear attention) at any group position (a hybrid group's
        Mamba-2 sublayers), None for softmax attention alone."""
        mixers = {dec.mixer_of(self.cfg, pos)
                  for pos in range(dec.group_size(self.cfg))}
        if "mamba" in mixers:
            return self.cfg.ssm.chunk_size
        return LINEAR_PREFILL_CHUNK if "linear" in mixers else None

    def step(self):
        self._admit()
        if not self.live:
            self.stats.steps += 1
            return
        # cohort decode: every in-flight request rides ONE batched
        # step, padded to a power-of-two cohort bucket (sentinel rows:
        # gathers fill, scatters drop).  Rows are independent, so a
        # request admitted or retired between steps never perturbs the
        # others' tokens — mid-flight continuous batching
        cohort = self._cohort_slots()
        bc = self._cohort_bucket(len(cohort))
        tokens = np.zeros((bc, 1), np.int32)
        lengths = np.zeros((bc,), np.int32)
        slot_ids = np.full((bc,), self.slots.n_slots, np.int32)
        tables = np.full((bc, self.slots.blocks_per_slot),
                         self.slots.n_blocks, np.int32)
        tables[:len(cohort)] = self.slots.gather_tables(cohort)
        for b, slot in enumerate(cohort):
            req = self.live[slot]
            tokens[b, 0] = req.out_tokens[-1]
            lengths[b] = self.slots.lengths[slot]
            slot_ids[b] = slot
        # the span takes in a bucket's capture at its first step, as the
        # reference's takes in its jit compile
        t0 = time.perf_counter()
        # the step writes the pool in place: it is never reassigned
        logits, _ = self._decode(tokens, lengths, slot_ids, tables)
        self.stats.steps += 1
        self._trace_event("decode_step", self.stats.steps)
        self._trace_event("decode_cohort", len(cohort))

        finished = []
        # the per-step sampling read: the sampled ids feed the next step's
        # host-side token buffer and the EOS check
        toks = self._pick_rows(logits, [self.live[s] for s in cohort])
        for slot, t in zip(cohort, toks):
            req = self.live[slot]
            req.out_tokens.append(t)
            self.slots.bump(slot)
            self.stats.decoded_tokens += 1
            over_len = self.slots.lengths[slot] + 1 >= self.max_len
            if (t == EOS_ID or len(req.out_tokens) >= req.max_new_tokens
                    or over_len):
                req.finish_t = time.time()
                finished.append(slot)
        # measured decode span for the telemetry ledger: the per-token
        # sampling read above already synced, so this is true wall time
        # of one cohort step
        self.probe.record("decoder", "decode", time.perf_counter() - t0,
                          tokens=len(cohort))
        for slot in finished:
            req = self.live.pop(slot)
            self.done.append(req)
            # the retiring request's KV blocks return to the free pool
            # NOW — grantable to the next admission round, mid-flight
            self.slots.release(slot)
            self.stats.finished += 1
            self._trace_event("finish", req.rid)

    # -- disaggregated fleets (serving/disagg.py) ----------------------------
    def prefill_step(self) -> List[Request]:
        """One admission round without decoding, the prefill fleet's step:
        staging hand-off and grouped batched prefill exactly as
        :meth:`step` runs them, but the newly admitted requests (cache
        landed, first token picked from the prefill logits) are returned
        for :meth:`export_remote` instead of decoded.  Requests whose
        staging failed land in ``done`` as usual."""
        before = set(self.live)
        self._admit()
        self.stats.steps += 1
        return [self.live[s] for s in sorted(set(self.live) - before)]

    def export_remote(self, req: Request) -> RemotePrefill:
        """Hand a just-prefilled request off the engine: export its
        written KV blocks, ``ceil(bucket / block_size)`` of them (the
        block-aligned prompt bucket the prefill wrote; none for a pool
        with no paged position), or its slot-state row, then drop it from
        the live set and release its slot and blocks: the decode fleet
        owns it now.  Runs before any decode step touches the slot."""
        slot = req.slot
        if slot is None or self.live.get(slot) is not req:
            raise RuntimeError(
                f"request {req.rid} is not live on this engine")
        bs = self.slots.block_size
        bucket = bucket_length(len(req.tokens), buckets=self._buckets())
        nb_written = -(-bucket // bs) if any(self.slots.paged) else 0
        rp = RemotePrefill(
            rid=req.rid,
            prompt=np.asarray(req.tokens, np.int32),
            first_token=int(req.out_tokens[0]),
            max_new_tokens=int(req.max_new_tokens),
            blocks_granted=len(self.slots.block_tables[slot]),
            paged=self.slots.paged,
            kv=self.slots.export_blocks(slot, nb_written),
            slot_class=req.slot_class,
            slab=req.slab,
            prompt_len=int(self.slots.lengths[slot]))
        del self.live[slot]
        self.slots.release(slot)
        req.slot = None
        self._trace_event("export_remote", req.rid)
        return rp

    def admit_remote(self, msg: RemotePrefill) -> bool:
        """Admit a :class:`RemotePrefill` from a prefill fleet straight
        into the pool: take a slot, grant the request's block count, land
        the shipped blocks (``PagedKVCache.import_blocks``, in place), and
        enter the request live with its first token; from here
        :meth:`step` decodes it as a locally prefilled request.

        Returns False, admitting and changing nothing, when no slot or
        too few free blocks are available (the caller decodes a step to
        retire capacity and retries).  A paged layout other than this
        pool's raises (the fleets' configs differ)."""
        if self._closed:
            raise EngineClosed("engine already shut down")
        if tuple(msg.paged) != tuple(self.slots.paged):
            raise RuntimeError(
                f"remote prefill paged layout {tuple(msg.paged)} does not "
                f"match this pool's {tuple(self.slots.paged)} (fleet "
                f"config mismatch)")
        if int(msg.blocks_granted) > self.slots.free_block_count:
            return False
        slot = self.slots.take_slot()
        if slot is None:
            return False
        self.slots.grant_blocks(slot, int(msg.blocks_granted),
                                slot_class=msg.slot_class)
        try:
            self.slots.import_blocks(slot, msg.kv)
        except BaseException:
            self.slots.release(slot)
            raise
        self.slots.lengths[slot] = int(msg.prompt_len)
        req = Request(rid=int(msg.rid),
                      tokens=np.asarray(msg.prompt, np.int32),
                      max_new_tokens=int(msg.max_new_tokens),
                      slot_class=msg.slot_class)
        req.slot = slot
        req.out_tokens.append(int(msg.first_token))
        req.first_token_t = time.time()
        req._staged_ev.set()
        self.live[slot] = req
        self.stats.prefills += 1
        self._trace_event("admit_remote", req.rid)
        return True

    # -- reporting / telemetry ----------------------------------------------
    def memory_bytes(self) -> Dict[str, int]:
        return {"weights": tree_bytes(self.params),
                "kv_pool": self.slots.nbytes,
                "tabm": self.tabm.nbytes if self.tabm else 0}

    def _kv_energy_pressure(self) -> float:
        """Measured-over-modeled decode J/token for ``kv_block_budgets``
        (cached: one lookup, not one per admission round).  1.0, no
        tightening, without a calibration table, without an energy
        observation, or when the plan's decoder step carries no
        accelerator to price the model against."""
        if self.calibration is None:
            return 1.0
        if self._kv_pressure is None:
            press = 1.0
            for s in self.plan.steps:
                if s.brick.kind == "decoder" and s.accel is not None:
                    modeled = brick_cost(s.brick, s.accel, 1)
                    press = self.calibration.energy_pressure(
                        s.brick.name, s.accel.profile.name,
                        modeled.energy_j)
                    break
            self._kv_pressure = press
        return self._kv_pressure

    def measured_ledger(self) -> Ledger:
        """The probe-fed ledger of this engine run: per-brick staging
        spans plus the engine's prefill/decode spans."""
        return self.probe.to_ledger(meta={"collector": "serving-engine"})

    def measured_calibration(self, prior: int = 4) -> CostCalibration:
        """A scheduler-consumable table from this run's measured ledger:
        ``schedule(graph, accels, n, calibration=eng.measured_calibration())``
        prices the next placement from what this engine observed."""
        return CostCalibration.from_ledger(self.measured_ledger(),
                                           prior=prior)
