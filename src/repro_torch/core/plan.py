"""ExecutionPlan — the one brick runtime (paper §3.1–3.2 made executable).

``compile_plan(graph, params, tabm=..., backend=...)`` binds every brick
of a :class:`~repro_torch.core.bricks.BrickGraph` to a backend
(``core/backends``) and its params, and routes the edge whose producer
emits ``vision_embeds`` through the TABM ring (``core/tabm``):

* ``plan.run(inputs)`` — one full forward pass (logits), the ring
  crossed synchronously;
* ``plan.produce / produce_many`` — the producer half: vision frontend
  -> projector as ONE batched call per microbatch, committed as one
  strided slab; FULL ring = backpressure (None, or block);
* ``plan.consume / wait_ready / addref / shared_view / release`` — the
  consumer half the serving engine binds at prefill;
* ``plan.relower(brick, backend)`` — move one brick to another backend at
  runtime (the battery policy's THROTTLED demotion);
* ``residency="one-brick"`` — every brick through the transient host
  backend (load -> execute -> release), recording a :class:`PlanTrace`
  whose peak is max(brick) not sum(bricks).

The port's own copy of the reference's plan, without accelerator
placements (the placement DP is not ported): a ``backend=`` override —
one spec or a per-brick dict — picks each brick's substrate.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.backends import BACKENDS, Backend, resolve_backend
from repro_torch.core.bricks import Brick, BrickGraph, Port
from repro_torch.core.quantize import tree_bytes
from repro_torch.core.tabm import SlotClassPool


class PlanError(RuntimeError):
    pass


@dataclass
class PlanEvent:
    brick: str
    phase: str                 # load | execute | release
    t: float
    resident_bytes: int


@dataclass
class PlanTrace:
    events: List[PlanEvent] = field(default_factory=list)
    peak_bytes: int = 0
    sum_bytes: int = 0         # what a monolithic load would have held

    def record(self, brick, phase, resident):
        self.events.append(PlanEvent(brick, phase, time.time(), resident))
        self.peak_bytes = max(self.peak_bytes, resident)


@dataclass
class PlanStep:
    """One brick bound to its backend, params and callable."""

    brick: Brick
    fn: Callable                       # (params, ctx) -> out
    params: Any
    backend: Backend


class ExecutionPlan:
    """Bound, executable form of a BrickGraph (see the module docstring)."""

    def __init__(self, graph: BrickGraph, steps: List[PlanStep], *,
                 residency: str, params, tabm=None,
                 tabm_producer: Optional[int] = None, probe=None):
        self.graph = graph
        self.cfg = graph.cfg
        self.steps = steps
        self.residency = residency
        self.tabm = tabm
        self._tabm_producer = tabm_producer
        self.probe = probe
        self._params = params          # full tree, kept for relower()
        merged: Dict[str, Any] = {}
        for s in steps:
            merged.update(s.params)
        self._sum_bytes = tree_bytes(merged)
        self._resident_bytes = self._resident_baseline()

    def _resident_baseline(self) -> int:
        merged: Dict[str, Any] = {}
        for s in self.steps:
            if s.backend.resident:
                merged.update(s.params)
        return tree_bytes(merged)

    # -- re-lowering --------------------------------------------------------
    def relower(self, brick_name: str, backend) -> PlanStep:
        """Re-lower one brick to another backend at runtime: re-bind its
        params and swap its executable; the step is replaced atomically,
        so a concurrent ``produce`` sees the old or the new step."""
        be = resolve_backend(backend)
        for i, s in enumerate(self.steps):
            if s.brick.name != brick_name:
                continue
            if s.backend is be:
                return s
            new = PlanStep(brick=s.brick, fn=be.compile_fn(s.brick, self.cfg),
                           params=be.bind_params(s.brick, self._params),
                           backend=be)
            self.steps[i] = new        # atomic swap under the GIL
            self._resident_bytes = self._resident_baseline()
            return new
        raise KeyError(brick_name)

    # -- execution ----------------------------------------------------------
    @staticmethod
    def _check_port(port: Port, value):
        is_int = not (value.is_floating_point() or value.is_complex())
        if (port.dtype_kind == "int") != is_int:
            raise PlanError(f"port {port.name!r} expects {port.dtype_kind} "
                            f"values, got {value.dtype}")

    def _gather(self, step: PlanStep, env):
        ctx = {}
        for port in step.brick.in_ports:
            if port.name not in env or env[port.name] is None:
                if port.optional:
                    continue
                raise PlanError(f"brick {step.brick.name!r} missing required "
                                f"input port {port.name!r}")
            v = env[port.name]
            self._check_port(port, v)
            ctx[port.name] = v
        return ctx

    def run(self, inputs: Dict[str, Any],
            trace: Optional[PlanTrace] = None) -> Tuple[Any, PlanTrace]:
        """One full inference pass through every brick; the TABM edge
        really goes through a slot (commit -> bind -> release)."""
        trace = trace if trace is not None else PlanTrace()
        trace.sum_bytes = max(trace.sum_bytes, self._sum_bytes)
        resident = self._resident_bytes
        env: Dict[str, Any] = dict(inputs)
        out = None
        ring_slot = None
        for i, step in enumerate(self.steps):
            transient = not step.backend.resident
            dev_params = step.backend.load(step.brick, step.params)
            if transient:
                resident += tree_bytes(dev_params)
            trace.record(step.brick.name, "load", resident)
            t0 = time.perf_counter()
            out = step.fn(dev_params, self._gather(step, env))
            trace.record(step.brick.name, "execute", resident)
            if self.probe is not None:
                phase = ("stage" if self._tabm_producer is not None
                         and i <= self._tabm_producer else "prefill")
                ntok = int(out.shape[1]) if out.dim() >= 2 else 0
                self.probe.record(step.brick.name, phase,
                                  time.perf_counter() - t0, tokens=ntok)
            if self.tabm is not None and i == self._tabm_producer:
                out, ring, slot = self._through_ring(out)
                ring_slot = (ring, slot)
            env[step.brick.out_port.name] = out
            if transient:
                step.backend.unload(dev_params)
                resident -= tree_bytes(dev_params)
            trace.record(step.brick.name, "release", resident)
            del dev_params
        if ring_slot is not None:
            ring_slot[0].release(ring_slot[1])
        return out, trace

    def _through_ring(self, out):
        """Commit the producer's output to a slot, bind it straight back
        (the synchronous TABM crossing of :meth:`run`)."""
        if out.shape[0] != 1:
            raise PlanError("TABM slots hold one request's embeds (batch 1)")
        if isinstance(self.tabm, SlotClassPool):
            ring = self.tabm.ring(self.tabm.classify_total(out.shape[1]))
        else:
            ring = self.tabm
        slot = ring.acquire_write()
        if slot is None:
            raise PlanError("TABM ring full inside a synchronous run(); "
                            "a prior consumer never released its slot")
        try:
            ring.commit_write(slot, out[0])
        except Exception:
            ring.abort_write(slot)
            raise
        got = ring.acquire_read()
        if got is None:
            raise PlanError("committed TABM slot not readable")
        s, view, n = got
        return view[None, :n], ring, s

    # -- TABM edge, split for the engine's producer/consumer decoupling -----
    def _tabm_ring(self, slot_class: Optional[str]):
        if self.tabm is None:
            raise PlanError("plan compiled without a TABM ring")
        if isinstance(self.tabm, SlotClassPool):
            if slot_class is None:
                raise PlanError("class-partitioned TABM pool: pass "
                                "slot_class=")
            return self.tabm.ring(slot_class)
        if slot_class is not None:
            raise PlanError(f"slot_class={slot_class!r} given but the "
                            f"plan's TABM is a single ring")
        return self.tabm

    def produce(self, inputs: Dict[str, Any], *,
                slot_class: Optional[str] = None, block: bool = False,
                timeout: Optional[float] = None) -> Optional[int]:
        """Producer half for one request — the K=1 case of
        :meth:`produce_many`."""
        slots = self.produce_many([inputs], slot_class=slot_class,
                                  block=block, timeout=timeout)
        return None if slots is None else slots[0]

    def produce_many(self, batch_of_inputs: List[Dict[str, Any]], *,
                     slot_class: Optional[str] = None, block: bool = False,
                     timeout: Optional[float] = None
                     ) -> Optional[List[int]]:
        """Batched producer half: acquire K FIFO-contiguous ring slots, run
        the stages up to the TABM edge as ONE batched call over the
        microbatch (each request padded to the class slab; the stubs and
        the projector are token-wise, so padding cannot perturb real
        rows), commit one strided slab.  Returns the slot ids, or None
        when the ring cannot hold the microbatch.  If a brick raises, all
        K slots are aborted before the exception propagates."""
        if self.tabm is None:
            raise PlanError("plan compiled without a TABM ring")
        if not batch_of_inputs:
            raise PlanError("produce_many needs at least one request")
        feats = []
        for inputs in batch_of_inputs:
            extra = set(inputs) - {"vision_feats"}
            if extra:
                raise PlanError(f"produce_many batches the vision_feats "
                                f"port only; got extra inputs {sorted(extra)}")
            f = inputs.get("vision_feats")
            if f is None:
                raise PlanError("produce_many needs vision_feats for "
                                "every request in the microbatch")
            f = torch.as_tensor(f)
            if f.shape[0] != 1:
                raise PlanError("TABM slots hold one request's embeds "
                                "(batch 1 per request)")
            feats.append(f)
        if slot_class is None and isinstance(self.tabm, SlotClassPool):
            slot_class = self.tabm.classify_total(
                max(int(f.shape[1]) for f in feats))
        ring = self._tabm_ring(slot_class)
        lengths = [int(f.shape[1]) for f in feats]
        for n in lengths:
            if n > ring.max_tokens:
                raise PlanError(f"{n} vision tokens > slot capacity "
                                f"{ring.max_tokens} of the target ring")
        slots = ring.acquire_write_many(len(feats), block=block,
                                        timeout=timeout)
        if slots is None:
            return None
        try:
            slab = ring.max_tokens
            stacked = torch.zeros((len(feats), slab, feats[0].shape[-1]),
                                  dtype=feats[0].dtype,
                                  device=feats[0].device)
            for b, f in enumerate(feats):
                stacked[b, :lengths[b]] = f[0]
            env: Dict[str, Any] = {"vision_feats": stacked}
            out = None
            for step in self.steps[: self._tabm_producer + 1]:
                dev_params = step.backend.load(step.brick, step.params)
                t0 = time.perf_counter()
                out = step.fn(dev_params, self._gather(step, env))
                step.backend.unload(dev_params)
                env[step.brick.out_port.name] = out
                if self.probe is not None:
                    self.probe.record(step.brick.name, "stage",
                                      time.perf_counter() - t0,
                                      tokens=len(feats) * slab)
            if out.shape[0] != len(feats):
                raise PlanError(f"projector returned batch {out.shape[0]} "
                                f"for a {len(feats)}-request microbatch")
            if out.shape[1] != slab:
                raise PlanError(
                    f"upstream bricks changed the token count "
                    f"({slab} -> {out.shape[1]}); produce_many requires "
                    f"token-count-preserving staging bricks")
            ring.commit_many(slots, out, lengths)
        except Exception:
            ring.abort_many(slots)
            raise
        return slots

    def consume(self, *, slot_class: Optional[str] = None,
                block: bool = False, timeout: Optional[float] = None):
        """Consumer half: bind the oldest READY slot — (slot, view,
        n_tokens), or None when nothing is ready."""
        return self._tabm_ring(slot_class).acquire_read(block=block,
                                                        timeout=timeout)

    def wait_ready(self, slot: int, timeout: Optional[float] = None, *,
                   slot_class: Optional[str] = None) -> bool:
        return self._tabm_ring(slot_class).wait_ready(slot, timeout)

    def addref(self, slot: int, gen: int, *,
               slot_class: Optional[str] = None) -> bool:
        return self._tabm_ring(slot_class).addref(slot, gen)

    def shared_view(self, slot: int, gen: int, *,
                    slot_class: Optional[str] = None):
        return self._tabm_ring(slot_class).shared_view(slot, gen)

    def release(self, slot: int, *, slot_class: Optional[str] = None):
        self._tabm_ring(slot_class).release(slot)


def _backend_for(brick_name: str, *, override, residency: str) -> Backend:
    """Priority: an explicit ``backend=`` override (global or per-brick)
    > ``residency="one-brick"`` (the host backend) > the default device
    backend."""
    if override is not None:
        spec = override.get(brick_name) if isinstance(override, dict) \
            else override
        if spec is not None:
            be = resolve_backend(spec)
            if residency == "one-brick" and be.resident:
                raise PlanError(
                    f"residency='one-brick' needs a transient backend, "
                    f"but brick {brick_name!r} was overridden to the "
                    f"resident {be.name!r} backend")
            return be
    if residency == "one-brick":
        return BACKENDS["host"]
    return resolve_backend(None)


def compile_plan(graph: BrickGraph, params, *, tabm=None,
                 residency: str = "resident", backend=None,
                 probe=None) -> ExecutionPlan:
    """Compile a BrickGraph (+ optional TABM ring) into an
    :class:`ExecutionPlan`.  ``backend``: a registry name, a Backend, or a
    per-brick ``{brick_name: spec}`` dict; ``probe``: a
    :class:`~repro_torch.telemetry.probes.WallProbe` for per-brick spans."""
    if residency not in ("resident", "one-brick"):
        raise PlanError(f"unknown residency {residency!r}")
    steps: List[PlanStep] = []
    for b in graph.bricks:
        be = _backend_for(b.name, override=backend, residency=residency)
        steps.append(PlanStep(brick=b, fn=be.compile_fn(b, graph.cfg),
                              params=be.bind_params(b, params), backend=be))
    tabm_producer = None
    if tabm is not None:
        for i, s in enumerate(steps):
            if s.brick.out_port.name == "vision_embeds":
                tabm_producer = i
                break
        if tabm_producer is None:
            raise PlanError("tabm ring given but no brick produces "
                            "'vision_embeds'")
    return ExecutionPlan(graph, steps, residency=residency, params=params,
                         tabm=tabm, tabm_producer=tabm_producer, probe=probe)
