"""Token-Aware Buffer Manager (TABM) — the paper's zero-copy hand-off
between the vision side (producer) and the decoder (consumer), as a
thread-safe ring of slots in device memory.

Slot lifecycle (docs/TABM.md):

    EMPTY -> STAGING -> READY -> CONSUMED -> EMPTY

The port's own copy of the reference's control plane (states, FIFO
pointers, seqlock generations, refcounted shared reads, strided slab
commits, drain), with a torch data plane: the pool is one tensor
``(n_slots, max_tokens, dim)`` on ``device``, a commit writes the slot
rows in place, and a consumer binds ``pool[slot]`` — a view, no copy.
Device work on the pool is issued under the ring's lock and on the
caller's current stream; producer and consumer threads share the default
stream, so a slot's later reuse is ordered after the reads of its view.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import torch_dtype

EMPTY = 0
STAGING = 1
READY = 2
CONSUMED = 3

_STATE_NAMES = {EMPTY: "EMPTY", STAGING: "STAGING", READY: "READY",
                CONSUMED: "CONSUMED"}

_VALID = {EMPTY: {STAGING},
          STAGING: {READY, EMPTY},
          READY: {CONSUMED},
          CONSUMED: {EMPTY}}


class TABMError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# device ops (data plane)
# ---------------------------------------------------------------------------

def _write_slot(pool: torch.Tensor, slot: int, embeds: torch.Tensor):
    """pool[slot] <- embeds (tokens, d), padded tail zeroed, in place."""
    row = pool[slot]
    row.zero_()
    row[: embeds.shape[0]] = embeds.to(pool.dtype)


def _write_slab(pool: torch.Tensor, slots: List[int], embeds: torch.Tensor,
                lengths: List[int]):
    """pool rows ``slots`` <- embeds (K, T, d) in one indexed write, each
    row's tail beyond its true length zeroed."""
    k, t, d = embeds.shape
    slab = torch.zeros((k, pool.shape[1], d), dtype=pool.dtype,
                       device=pool.device)
    slab[:, :t] = embeds.to(pool.dtype)
    lens = torch.as_tensor(lengths, device=pool.device)
    mask = (torch.arange(pool.shape[1], device=pool.device)[None, :, None]
            < lens[:, None, None])
    idx = torch.as_tensor(slots, dtype=torch.long, device=pool.device)
    pool[idx] = torch.where(mask, slab, torch.zeros((), dtype=pool.dtype,
                                                    device=pool.device))


def _read_slot(pool: torch.Tensor, slot: int) -> torch.Tensor:
    """Bind a slot as consumer input: a view of the pool row, no copy."""
    return pool[slot]


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------

@dataclass
class RingBuffer:
    """One TABM pool: device array + thread-safe host-side slot machine."""

    n_slots: int
    max_tokens: int
    dim: int
    dtype: str = "bfloat16"
    device: str = "cuda"

    def __post_init__(self):
        self.pool = torch.zeros((self.n_slots, self.max_tokens, self.dim),
                                dtype=torch_dtype(self.dtype),
                                device=torch.device(self.device))
        self.states: List[int] = [EMPTY] * self.n_slots
        self.tokens: List[int] = [0] * self.n_slots
        # seqlock-style: +1 on every transition; captured at acquire_read
        # so a zero-copy view can be validated against slot recycling
        self.generation: List[int] = [0] * self.n_slots
        self._write_ptr = 0
        self._read_ptr = 0
        # consumer refcount per slot: acquire_read pins with 1, addref
        # pins further bucket-matched sharers; release drops the slot back
        # to EMPTY only at zero, so one staged embedding can feed >1
        # prefill (prefix/repeated-image reuse)
        self.refs: List[int] = [0] * self.n_slots
        self._cond = threading.Condition()
        self._closed = False
        self.stats = {"writes": 0, "reads": 0, "stalls": 0, "aborts": 0,
                      "slab_commits": 0, "shares": 0}

    # -- state machine (always called with self._cond held) -----------------
    def _transition(self, slot: int, to: int):
        """Caller must hold ``self._cond`` (enforced by replint
        lock-discipline: every call site is checked)."""
        frm = self.states[slot]
        if to not in _VALID[frm]:
            raise TABMError(
                f"slot {slot}: illegal {_STATE_NAMES[frm]} -> "
                f"{_STATE_NAMES[to]}")
        self.states[slot] = to
        self.generation[slot] += 1

    def acquire_write(self, block: bool = False,
                      timeout: Optional[float] = None) -> Optional[int]:
        """Producer asks for a slot; None = ring full (producer must stall —
        the paper's producer/consumer smoothing signal).

        ``block=True`` parks the calling thread until the head slot frees
        (the async engine's StagingWorker stalls *here*, off the step
        loop); returns None only on timeout or :meth:`close`."""
        with self._cond:
            if self.states[self._write_ptr] != EMPTY:
                self.stats["stalls"] += 1
            if block:
                ok = self._cond.wait_for(
                    lambda: self._closed
                    or self.states[self._write_ptr] == EMPTY,
                    timeout)
                if not ok or self._closed:
                    return None
            slot = self._write_ptr
            if self.states[slot] != EMPTY:
                return None
            self._transition(slot, STAGING)
            self._write_ptr = (slot + 1) % self.n_slots
            return slot

    def commit_write(self, slot: int, embeds: torch.Tensor):
        """In-place write of the slot rows, then mark READY."""
        with self._cond:
            if self.states[slot] != STAGING:
                raise TABMError(f"commit on slot {slot} in "
                                f"{_STATE_NAMES[self.states[slot]]}")
            n = embeds.shape[0]
            if n > self.max_tokens:
                raise TABMError(
                    f"{n} tokens > slot capacity {self.max_tokens}")
            # the write is issued under the lock, in stream order with
            # every earlier read of this ring
            _write_slot(self.pool, slot, embeds)
            self.tokens[slot] = n
            self._transition(slot, READY)
            self.stats["writes"] += 1
            self._cond.notify_all()

    def abort_write(self, slot: int):
        """Producer abandons an acquired slot (staging failed or the engine
        is shutting down).  FIFO ring: only the most recently acquired slot
        can abort, and the write pointer rewinds to it — otherwise a later
        commit would land ahead of the read pointer and wedge the ring
        (reads stuck on an EMPTY slot)."""
        with self._cond:
            if self.states[slot] != STAGING:
                raise TABMError(f"abort_write on slot {slot} in "
                                f"{_STATE_NAMES[self.states[slot]]} — only "
                                f"a STAGING slot can abort (consumers use "
                                f"release)")
            if (slot + 1) % self.n_slots != self._write_ptr:
                raise TABMError(
                    f"abort_write out of order: slot {slot} is not "
                    f"the most recent acquire")
            self._transition(slot, EMPTY)
            self.tokens[slot] = 0
            self._write_ptr = slot
            self.stats["aborts"] += 1
            self._cond.notify_all()

    # -- strided multi-slot producer ops (the batched staging pipeline) -----
    def _head_run_free(self, k: int) -> bool:
        """True when the k slots from the write pointer are all EMPTY.
        FIFO invariant: EMPTY slots form one contiguous run starting at
        the write pointer, so this is *the* k-slot availability check."""
        return all(self.states[(self._write_ptr + i) % self.n_slots] == EMPTY
                   for i in range(k))

    def acquire_write_many(self, k: int, block: bool = False,
                           timeout: Optional[float] = None
                           ) -> Optional[List[int]]:
        """Producer asks for k FIFO-contiguous slots at once — the write
        side of one strided slab commit.  All-or-nothing: either the whole
        run from the write pointer is EMPTY (each slot moves to STAGING,
        in order) or None is returned (ring cannot hold the microbatch
        yet — the caller stalls, exactly like the K=1 backpressure).

        ``block=True`` parks the calling thread until k slots free from
        the head (or timeout / :meth:`close`).  ``k`` may not exceed the
        ring capacity — a microbatch that can never fit is a caller bug,
        not backpressure."""
        if k < 1 or k > self.n_slots:
            raise TABMError(f"cannot acquire {k} slots from a "
                            f"{self.n_slots}-slot ring")
        with self._cond:
            if not self._head_run_free(k):
                self.stats["stalls"] += 1
            if block:
                ok = self._cond.wait_for(
                    lambda: self._closed or self._head_run_free(k), timeout)
                if not ok or self._closed:
                    return None
            if not self._head_run_free(k):
                return None
            slots = []
            for _ in range(k):
                slot = self._write_ptr
                self._transition(slot, STAGING)
                self._write_ptr = (slot + 1) % self.n_slots
                slots.append(slot)
            return slots

    def _check_slab_run(self, slots: List[int], op: str):
        """Slab ops cover one contiguous FIFO run of STAGING slots."""
        if not slots:
            raise TABMError(f"{op} with no slots")
        for a, b in zip(slots, slots[1:]):
            if (a + 1) % self.n_slots != b:
                raise TABMError(f"{op} slots {slots} are not one "
                                f"contiguous FIFO run")
        for slot in slots:
            if self.states[slot] != STAGING:
                raise TABMError(f"{op} on slot {slot} in "
                                f"{_STATE_NAMES[self.states[slot]]}")

    def commit_many(self, slots: List[int], embeds: torch.Tensor,
                    lengths: Optional[List[int]] = None):
        """One strided slab write covering the whole microbatch: embeds
        (K, T, d) lands in the K acquired slots as a single in-place
        scatter (:func:`_write_slab`), then every slot flips to READY —
        each bump of its generation wakes that slot's :meth:`wait_ready`
        waiters individually, so per-slot ready semantics are identical
        to K sequential commits.  ``lengths`` carries each request's true
        token count (default: T for all)."""
        with self._cond:
            k = len(slots)
            if embeds.ndim != 3 or embeds.shape[0] != k:
                raise TABMError(f"slab embeds {embeds.shape} do not cover "
                                f"{k} slots")
            lengths = [int(embeds.shape[1])] * k if lengths is None \
                else [int(n) for n in lengths]
            if len(lengths) != k:
                raise TABMError(f"{len(lengths)} lengths for {k} slots")
            self._check_slab_run(slots, "commit_many")
            if embeds.shape[1] > self.max_tokens:
                raise TABMError(f"{embeds.shape[1]} tokens > slot capacity "
                                f"{self.max_tokens}")
            for n in lengths:
                if n > embeds.shape[1]:
                    raise TABMError(f"length {n} > slab width "
                                    f"{embeds.shape[1]}")
            # same lock discipline as commit_write
            _write_slab(self.pool, slots, embeds, lengths)
            for slot, n in zip(slots, lengths):
                self.tokens[slot] = n
                self._transition(slot, READY)
            self.stats["writes"] += k
            if k > 1:
                self.stats["slab_commits"] += 1
            self._cond.notify_all()

    def abort_many(self, slots: List[int]):
        """Abort-all-on-failure for a slab acquisition: the whole run goes
        back to EMPTY and the write pointer rewinds to its first slot.
        Same FIFO invariant as :meth:`abort_write` — the run must be the
        most recent acquisition, or a later commit could land ahead of
        the read pointer and wedge the ring."""
        with self._cond:
            self._check_slab_run(slots, "abort_many")
            if (slots[-1] + 1) % self.n_slots != self._write_ptr:
                raise TABMError(
                    f"abort_many out of order: slots {slots} are not the "
                    f"most recent acquisition")
            for slot in reversed(slots):
                self._transition(slot, EMPTY)
                self.tokens[slot] = 0
            self._write_ptr = slots[0]
            self.stats["aborts"] += len(slots)
            self._cond.notify_all()

    def acquire_read(self, block: bool = False,
                     timeout: Optional[float] = None
                     ) -> Optional[Tuple[int, torch.Tensor, int]]:
        """Consumer takes the oldest READY slot: (slot, view, n_tokens)."""
        with self._cond:
            if block:
                ok = self._cond.wait_for(
                    lambda: self._closed
                    or self.states[self._read_ptr] == READY,
                    timeout)
                if not ok or self._closed:
                    return None
            slot = self._read_ptr
            if self.states[slot] != READY:
                return None
            self._transition(slot, CONSUMED)
            self._read_ptr = (slot + 1) % self.n_slots
            self.refs[slot] = 1
            view = _read_slot(self.pool, slot)
            self.stats["reads"] += 1
            return slot, view, self.tokens[slot]

    def addref(self, slot: int, gen: int) -> bool:
        """Pin an already-CONSUMED slot for one more bucket-matched
        consumer (the seqlock generation captured by the first consumer
        must still match, i.e. the slot was not recycled).  Each addref
        must be paired with one :meth:`release`; the slot returns to
        EMPTY only when every holder has released.  Returns False when
        the slot moved on — the caller stages its own copy instead."""
        with self._cond:
            if self.states[slot] != CONSUMED or self.generation[slot] != gen:
                return False
            self.refs[slot] += 1
            self.stats["shares"] += 1
            return True

    def shared_view(self, slot: int, gen: int
                    ) -> Optional[Tuple[torch.Tensor, int]]:
        """Zero-copy (view, n_tokens) of a CONSUMED slot for a sharing
        holder (:meth:`addref`), or None when the slot was recycled
        (generation mismatch) — the read-side twin of acquire_read that
        does not advance the FIFO read pointer."""
        with self._cond:
            if self.states[slot] != CONSUMED or self.generation[slot] != gen:
                return None
            return (_read_slot(self.pool, slot),
                    self.tokens[slot])

    def release(self, slot: int):
        """Consumer returns a slot.  Only legal from CONSUMED — a producer
        abandoning a write must use abort_write.  With sharing
        (:meth:`addref`) each release drops one reference; the slot stays
        CONSUMED — generation untouched, other holders' views still
        seqlock-valid — until the last holder releases."""
        with self._cond:
            if self.states[slot] != CONSUMED:
                raise TABMError(f"release on slot {slot} in "
                                f"{_STATE_NAMES[self.states[slot]]}")
            self.refs[slot] -= 1
            if self.refs[slot] > 0:
                return
            self.refs[slot] = 0
            self._transition(slot, EMPTY)
            self.tokens[slot] = 0
            self._cond.notify_all()

    # -- per-slot waiting / seqlock validation ------------------------------
    def wait_ready(self, slot: int, timeout: Optional[float] = None) -> bool:
        """Block until `slot` is committed (READY or beyond).  The engine's
        consumer half waits here — on the exact slot its request owns —
        instead of polling the ring.

        Returns False on timeout, on :meth:`close`, or when the slot's
        current lifecycle ends without a commit (the producer aborted) —
        detected via the generation counter, so a waiter can never hang on
        a slot that will no longer become READY, nor mistake a later
        request's commit (after abort + recycle) for its own.  Call with
        the slot in STAGING or later."""
        with self._cond:
            st = self.states[slot]
            if st in (READY, CONSUMED):
                return True
            if st != STAGING:
                return False                   # no live write to wait on
            g0 = self.generation[slot]         # this lifecycle's STAGING gen
            self._cond.wait_for(
                lambda: self._closed or self.generation[slot] != g0,
                timeout)                       # any transition ends the wait
            # committed in THIS lifecycle — not a later request's commit
            # after an abort recycled the slot (generation arithmetic:
            # commit bumps to g0+1, a subsequent consume to g0+2)
            return (not self._closed
                    and ((self.states[slot] == READY
                          and self.generation[slot] == g0 + 1)
                         or (self.states[slot] == CONSUMED
                             and self.generation[slot] == g0 + 2)))

    def slot_generation(self, slot: int) -> int:
        with self._cond:
            return self.generation[slot]

    def view_valid(self, slot: int, gen: int) -> bool:
        """Seqlock check: a view captured at acquire_read (generation `gen`)
        is valid while the slot is still CONSUMED at that generation — i.e.
        it was not released/recycled for a later request."""
        with self._cond:
            return self.states[slot] == CONSUMED \
                and self.generation[slot] == gen

    # -- shutdown / drain ---------------------------------------------------
    def close(self):
        """Wake every thread blocked in acquire_write/acquire_read; they
        return None.  Idempotent; part of the engine drain protocol."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self) -> int:
        """Release every READY and CONSUMED slot in FIFO order so the ring
        ends fully EMPTY (engine shutdown with staged-but-unconsumed
        slots).  STAGING slots are the producer's to abort — draining with
        one still staging means the worker was not joined first."""
        drained = 0
        with self._cond:
            if any(s == STAGING for s in self.states):
                raise TABMError("drain with a slot still STAGING — join the "
                                "producer thread before draining")
            # consumed-but-unreleased slots belong to requests that will
            # never prefill; recycle them
            for slot in range(self.n_slots):
                if self.states[slot] == CONSUMED:
                    self._transition(slot, EMPTY)
                    self.tokens[slot] = 0
                    self.refs[slot] = 0        # outstanding shares are void
                    drained += 1
            while self.states[self._read_ptr] == READY:
                slot = self._read_ptr
                self._transition(slot, CONSUMED)
                self._transition(slot, EMPTY)
                self.tokens[slot] = 0
                self.refs[slot] = 0
                self._read_ptr = (slot + 1) % self.n_slots
                drained += 1
            self._cond.notify_all()
        return drained

    # -- signals ------------------------------------------------------------
    def staged_ahead(self) -> int:
        """Slots the producer holds ahead of the consumer (STAGING+READY) —
        the admission-depth signal core/scheduler.staging_budget reads."""
        return sum(s in (STAGING, READY) for s in self.states)

    @property
    def nbytes(self) -> int:
        return self.pool.numel() * self.pool.element_size()


# ---------------------------------------------------------------------------
# class-partitioned pool (core/slot_classes defines the classes)
# ---------------------------------------------------------------------------

class SlotClassPool:
    """Class-partitioned TABM: one :class:`RingBuffer` per request class.

    The single-ring pool pads every request into one ``max_tokens`` slab
    and admits against one FIFO depth, so a 1-image thumbnail competes
    with (and is starved behind) a 4-image full-resolution request.  The
    pool partitions both resources by :class:`~repro_torch.core.slot_classes.
    SlotClass` (image-count bucket × resolution bucket, from the arch
    config):

    * each class ring's ``max_tokens`` is the class slab — a thumbnail
      slot is thumbnail-sized, and an oversized commit into the wrong
      class raises :class:`TABMError` exactly like ring overflow;
    * each class has its own admission depth (``max_ahead``), charged per
      class at hand-off (``core/scheduler.class_staging_budgets``), so a
      FULL high-resolution ring stalls only its own class's producer;
    * :meth:`admission_table` scales depths for the battery policy
      (``Knobs.class_depth_scale``): the highest-resolution class shrinks
      first and most, the smallest class keeps full depth.

    Class rings **materialize lazily** on first use (:meth:`ring`): the
    cross product of image × resolution buckets describes what traffic
    *may* arrive, and only the classes that actually do arrive allocate a
    device pool — single-image traffic never pays for the 4-image
    full-resolution slab.  ``stats``, ``nbytes``, ``close`` and ``drain``
    aggregate over the materialized rings (an unmaterialized ring is
    trivially EMPTY and holds zero bytes)."""

    def __init__(self, classes, dim: int, dtype: str = "bfloat16",
                 device: str = "cuda"):
        ordered = sorted(classes.values(), key=lambda c: c.sort_key)
        self.classes = {c.name: c for c in ordered}
        self.dim, self.dtype, self.device = dim, dtype, device
        self._rings: "dict[str, RingBuffer]" = {}
        self._closed = False

    @classmethod
    def from_config(cls, cfg, dim: Optional[int] = None,
                    slots_per_class: int = 2, dtype: str = "bfloat16",
                    device: str = "cuda") -> "SlotClassPool":
        from repro_torch.core.slot_classes import build_slot_classes
        return cls(build_slot_classes(cfg, slots_per_class),
                   dim=dim or cfg.d_model, dtype=dtype, device=device)

    # -- class lookup -------------------------------------------------------
    def names(self) -> List[str]:
        return list(self.classes)

    def ring(self, name: str) -> RingBuffer:
        """The class's ring, materialized on first use (lazy: a class no
        request ever lands in allocates no device pool)."""
        if name not in self.classes:
            raise TABMError(f"unknown slot class {name!r}; classes: "
                            f"{list(self.classes)}")
        if name not in self._rings:
            c = self.classes[name]
            r = RingBuffer(n_slots=c.n_slots, max_tokens=c.max_tokens,
                           dim=self.dim, dtype=self.dtype,
                           device=self.device)
            if self._closed:               # pool already shut down: the
                r.close()                  # new ring is born closed
            self._rings[name] = r
        return self._rings[name]

    def classify(self, n_tokens: int, n_images: int = 1) -> str:
        from repro_torch.core.slot_classes import classify
        return classify(self.classes, n_tokens, n_images).name

    def classify_total(self, n_tokens: int) -> str:
        from repro_torch.core.slot_classes import classify_total
        return classify_total(self.classes, n_tokens).name

    # -- admission (the per-class {slot_class: (ring, max_ahead)} table) ----
    def max_ahead(self, name: str) -> int:
        c = self.classes[name]
        # class n_slots == ring capacity by construction; reading the spec
        # (not the ring) keeps unmaterialized classes unmaterialized
        return c.max_ahead if c.max_ahead is not None else c.n_slots

    def admission_table(self, depth_scale: float = 1.0
                        ) -> "dict[str, Tuple[Optional[RingBuffer], int]]":
        """``{slot_class: (ring, max_ahead)}`` under a battery depth scale.
        The ring element is None while the class is unmaterialized (lazy:
        nothing can be staged ahead in a ring that does not exist yet).

        ``depth_scale`` (``core/power.Knobs.class_depth_scale``, 1.0 when
        unconstrained) shrinks admission depth *high-resolution-first*:
        classes are ranked by slab size, the largest class scales fully by
        ``depth_scale`` (down to 0 — fully gated), intermediate classes
        proportionally less, and the smallest class keeps its full depth,
        so thumbnails keep flowing while the battery drains."""
        from repro_torch.core.slot_classes import shed_scales
        table = {}
        for name, eff in shed_scales(self.classes, depth_scale).items():
            base = self.max_ahead(name)
            table[name] = (self._rings.get(name),
                           max(0, min(base, int(base * eff))))
        return table

    # -- aggregate signals --------------------------------------------------
    @property
    def stats(self) -> "dict[str, int]":
        agg = {"writes": 0, "reads": 0, "stalls": 0, "aborts": 0,
               "slab_commits": 0, "shares": 0}
        for r in self._rings.values():
            for k in agg:
                agg[k] += r.stats[k]
        return agg

    @property
    def nbytes(self) -> int:
        """Allocated pool bytes — only materialized class rings count,
        which is the memory win over one eagerly-sized maximal ring."""
        return sum(r.nbytes for r in self._rings.values())

    # -- shutdown / per-class drain protocol --------------------------------
    def close(self):
        """Close every materialized class ring — wakes all per-class
        producer threads parked in ``acquire_write`` (engine shutdown
        fan-out).  Classes materialized afterwards are born closed."""
        self._closed = True
        for r in self._rings.values():
            r.close()

    def drain(self) -> int:
        """Per-class drain: every materialized class ring releases its
        READY/CONSUMED slots back to EMPTY.  Same precondition as the
        single ring, per class — a STAGING slot belongs to that class's
        live producer, so all per-class producer threads must be joined
        first."""
        staging = [n for n, r in self._rings.items()
                   if any(s == STAGING for s in r.states)]
        if staging:
            raise TABMError(f"drain with class(es) {staging} still STAGING "
                            f"— join the per-class producer threads first")
        return sum(r.drain() for r in self._rings.values())
