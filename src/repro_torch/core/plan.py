"""ExecutionPlan — the one brick runtime (paper §3.1–3.2 made executable).

``compile_plan(graph, params, placement=..., accels=..., tabm=...,
backend=...)`` binds every brick of a
:class:`~repro_torch.core.bricks.BrickGraph` to a backend
(``core/backends``) and its params, validates the wiring (every required
input port produced upstream or an external input, ``plan.input_ports``),
wires the transfers of edges that cross accelerators, and routes the edge
whose producer emits ``vision_embeds`` through the TABM ring
(``core/tabm``):

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

A ``Placement`` from ``core/scheduler.schedule`` binds each brick to an
accelerator, and its carried backends pick each brick's substrate; a
``backend=`` override (one spec or a per-brick dict) comes first.  A
brick whose input was produced on another accelerator gets that edge's
transfer (``Backend.make_edge``, or ``Transport.make_edge`` when a
``transport`` is given: the value crosses the wire codec first); the
TABM edge's transfer runs producer-side, so the ring stays on the
consumer's device.
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
    """One brick bound to its backend, accelerator, params and callable."""

    brick: Brick
    fn: Callable                       # (params, ctx) -> out
    params: Any
    backend: Backend
    accel: Optional[object] = None     # scheduler.Accelerator or None
    # port name -> transfer applied when the value was produced on a
    # different accelerator
    inbound: Dict[str, Callable] = field(default_factory=dict)


class ExecutionPlan:
    """Bound, executable form of a BrickGraph (see the module docstring)."""

    def __init__(self, graph: BrickGraph, steps: List[PlanStep], *,
                 residency: str, params, tabm=None,
                 tabm_producer: Optional[int] = None,
                 tabm_transfer: Optional[Callable] = None,
                 input_ports: Tuple[Port, ...] = (), probe=None,
                 device=None):
        self.graph = graph
        self.cfg = graph.cfg
        self.steps = steps
        self.residency = residency
        self.tabm = tabm
        self._tabm_producer = tabm_producer
        self._tabm_transfer = tabm_transfer
        self.input_ports = input_ports
        self.probe = probe
        self.device = device           # the ``device`` row's torch device
        self.pipes: Dict[Tuple[str, str, int], Any] = {}
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

    # -- introspection ------------------------------------------------------
    def brick_params(self, name: str) -> Any:
        for s in self.steps:
            if s.brick.name == name:
                return s.params
        raise KeyError(name)

    def backend_of(self, name: str) -> Backend:
        for s in self.steps:
            if s.brick.name == name:
                return s.backend
        raise KeyError(name)

    def describe(self) -> str:
        rows = []
        for s in self.steps:
            ins = ",".join(p.name + ("?" if p.optional else "")
                           for p in s.brick.in_ports)
            acc = s.accel.name if s.accel is not None else "-"
            rows.append(f"{s.brick.name}({ins})->{s.brick.out_port.name}"
                        f"@{acc}/{s.backend.name}")
        return " | ".join(rows)

    # -- re-lowering --------------------------------------------------------
    def relower(self, brick_name: str, backend) -> PlanStep:
        """Re-lower one brick to another backend at runtime: re-bind its
        params and swap its executable; the step is replaced atomically,
        so a concurrent ``produce`` sees the old or the new step.  Its
        accelerator and inbound transfers stay: re-lowering moves the
        brick's weights and compute, not the graph's wiring."""
        be = resolve_backend(backend, device=self.device)
        for i, s in enumerate(self.steps):
            if s.brick.name != brick_name:
                continue
            if s.backend is be:
                return s
            new = PlanStep(brick=s.brick, fn=be.compile_fn(s.brick, self.cfg),
                           params=be.bind_params(s.brick, self._params),
                           backend=be, accel=s.accel, inbound=s.inbound)
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

    def _gather(self, step: PlanStep, env, env_src):
        ctx = {}
        for port in step.brick.in_ports:
            if port.name not in env or env[port.name] is None:
                if port.optional:
                    continue
                raise PlanError(f"brick {step.brick.name!r} missing required "
                                f"input port {port.name!r}")
            v = env[port.name]
            self._check_port(port, v)
            src = env_src.get(port.name)
            if src is not step.accel and port.name in step.inbound:
                v = step.inbound[port.name](v)
            ctx[port.name] = v
        return ctx

    @staticmethod
    def _settle(out):
        """A transient brick's residency trace point: on a card, wait for
        its stream, so the brick's events mark when its work is done."""
        if isinstance(out, torch.Tensor) and out.device.type == "cuda":
            torch.cuda.current_stream(out.device).synchronize()
        return out

    def run(self, inputs: Dict[str, Any],
            trace: Optional[PlanTrace] = None) -> Tuple[Any, PlanTrace]:
        """One full inference pass through every brick; the TABM edge
        really goes through a slot (commit -> bind -> release)."""
        trace = trace if trace is not None else PlanTrace()
        trace.sum_bytes = max(trace.sum_bytes, self._sum_bytes)
        resident = self._resident_bytes
        env: Dict[str, Any] = dict(inputs)
        env_src: Dict[str, Any] = {k: None for k in env}
        out = None
        ring_slot = None
        for i, step in enumerate(self.steps):
            transient = not step.backend.resident
            dev_params = step.backend.load(step.brick, step.params)
            if transient:
                resident += tree_bytes(dev_params)
            trace.record(step.brick.name, "load", resident)
            t0 = time.perf_counter()
            out = step.fn(dev_params, self._gather(step, env, env_src))
            if transient:
                out = self._settle(out)
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
            env_src[step.brick.out_port.name] = step.accel
            if transient:
                freed = tree_bytes(dev_params)
                step.backend.unload(dev_params)
                resident -= freed
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
            v = out if self._tabm_transfer is None \
                else self._tabm_transfer(out)
            ring.commit_write(slot, v[0])
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
            env_src: Dict[str, Any] = {k: None for k in env}
            out = None
            for step in self.steps[: self._tabm_producer + 1]:
                transient = not step.backend.resident
                dev_params = step.backend.load(step.brick, step.params)
                t0 = time.perf_counter()
                out = step.fn(dev_params, self._gather(step, env, env_src))
                if transient:
                    out = self._settle(out)
                    step.backend.unload(dev_params)
                del dev_params
                env[step.brick.out_port.name] = out
                env_src[step.brick.out_port.name] = step.accel
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
            v = out if self._tabm_transfer is None \
                else self._tabm_transfer(out)
            ring.commit_many(slots, v, lengths)
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


def _backend_for(brick_name: str, accel, *, override, placement_backends,
                 residency: str, device) -> Backend:
    """Priority: an explicit ``backend=`` override (global or per-brick)
    > ``residency="one-brick"`` (the transient host backend) > the
    placement's carried backend name > the accelerator's profile / the
    default device backend (``core/backends.resolve_backend``)."""
    if override is not None:
        spec = override.get(brick_name) if isinstance(override, dict) \
            else override
        if spec is not None:
            be = resolve_backend(spec, accel, device)
            if residency == "one-brick" and be.resident:
                raise PlanError(
                    f"residency='one-brick' needs a transient backend, "
                    f"but brick {brick_name!r} was overridden to the "
                    f"resident {be.name!r} backend")
            return be
    if residency == "one-brick":
        return BACKENDS["host"]
    if placement_backends and brick_name in placement_backends:
        return resolve_backend(placement_backends[brick_name], accel, device)
    return resolve_backend(None, accel, device)


def compile_plan(graph: BrickGraph, params, *, placement=None, accels=None,
                 tabm=None, residency: str = "resident", backend=None,
                 probe=None, transport=None, device=None) -> ExecutionPlan:
    """Compile a BrickGraph (+ optional Placement and TABM ring) into an
    :class:`ExecutionPlan`.

    placement: a :class:`~repro_torch.core.scheduler.Placement` or a raw
        ``{brick_name: accel_name}`` dict; requires ``accels``.  A
        Placement's ``backends`` (``schedule()``'s, from each
        accelerator) pick each brick's lowering substrate.
    accels: the accelerators the placement names.
    tabm: a :class:`~repro_torch.core.tabm.RingBuffer` or
        :class:`~repro_torch.core.tabm.SlotClassPool` for the
        vision_embeds edge.
    residency: "resident" (params bound once) | "one-brick" (every brick
        through the transient host backend: load -> execute -> release).
    backend: a registry name, a Backend, or a per-brick
        ``{brick_name: spec}`` dict; comes before the placement's.
    probe: a :class:`~repro_torch.telemetry.probes.WallProbe` for
        per-brick spans.
    transport: a :class:`~repro_torch.core.transport.Transport` the
        plan's cross-accelerator edges are bound to: on a serializing
        one every such edge round-trips its value through the wire codec
        (``Transport.make_edge``); None = direct backend edges.
    device: the torch device the generic ``device`` row lowers to (None:
        the registry's, ``cuda``); the engine passes its own.
    """
    if residency not in ("resident", "one-brick"):
        raise PlanError(f"unknown residency {residency!r}")
    assignment = getattr(placement, "assignment", placement)
    placement_backends = getattr(placement, "backends", None)
    by_name = {a.name: a for a in (accels or [])}
    if assignment:
        missing = [b.name for b in graph.bricks if b.name not in assignment]
        if missing:
            raise PlanError(f"placement misses bricks: {missing}")
        unknown = sorted(set(assignment.values()) - set(by_name))
        if unknown:
            raise PlanError(f"placement names unknown accelerators: "
                            f"{unknown}")

    # wiring validation + external input discovery
    produced: Dict[str, Brick] = {}
    externals: List[Port] = []
    for b in graph.bricks:
        for p in b.in_ports:
            if p.name not in produced and not p.optional \
                    and all(e.name != p.name for e in externals):
                externals.append(p)
        produced[b.out_port.name] = b

    steps: List[PlanStep] = []
    src_accel: Dict[str, Any] = {}                 # port -> producing accel
    edges: Dict[Tuple[str, str, int], Any] = {}    # (src, dst, backend) -> fn
    for b in graph.bricks:
        accel = by_name[assignment[b.name]] if assignment else None
        be = _backend_for(b.name, accel, override=backend,
                          placement_backends=placement_backends,
                          residency=residency, device=device)
        inbound: Dict[str, Callable] = {}
        if accel is not None:
            for p in b.in_ports:
                src = src_accel.get(p.name)
                if src is accel:
                    continue
                # keyed on the backend instance: two instances of one
                # name (devices apart) must not share a transfer
                key = (src.name if src is not None else "-",
                       accel.name, id(be))
                if key not in edges:
                    edges[key] = (be.make_edge(src, accel)
                                  if transport is None
                                  else transport.make_edge(src, accel, be))
                inbound[p.name] = edges[key]
        steps.append(PlanStep(
            brick=b, fn=be.compile_fn(b, graph.cfg),
            params=be.bind_params(b, params),
            backend=be, accel=accel, inbound=inbound))
        src_accel[b.out_port.name] = accel

    # the TABM edge: the brick producing vision_embeds hands off through
    # the ring; a transfer to the consumer's unit runs producer-side, so
    # the ring lives on the consumer's device
    tabm_producer = tabm_transfer = None
    if tabm is not None:
        for i, s in enumerate(steps):
            if s.brick.out_port.name == "vision_embeds":
                tabm_producer = i
                break
        if tabm_producer is None:
            raise PlanError("tabm ring given but no brick produces "
                            "'vision_embeds'")
        nxt = steps[tabm_producer + 1] if tabm_producer + 1 < len(steps) \
            else None
        if nxt is not None and "vision_embeds" in nxt.inbound:
            tabm_transfer = nxt.inbound.pop("vision_embeds")

    plan = ExecutionPlan(graph, steps, residency=residency, params=params,
                         tabm=tabm, tabm_producer=tabm_producer,
                         tabm_transfer=tabm_transfer,
                         input_ports=tuple(externals), probe=probe,
                         device=device)
    plan.pipes = edges
    return plan
