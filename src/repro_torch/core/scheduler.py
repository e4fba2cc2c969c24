"""Cross-accelerator, module-level scheduler (paper §3.2), and the
serving engine's admission budgets.

NANOMIND's central mechanism: map each brick to the compute unit whose
characteristics match it ("NPUs excel at low-bit tensor ops but are
inefficient for floating-point workloads; GPUs are far better at
large-scale parallel floating-point").  The port's own copy of the
reference's scheduler:

* :func:`edge_accelerators` — the paper's RK3566 as scheduler rows (NPU:
  static shapes only, low-bit; Mali GPU; Cortex CPU), each priced by an
  energy profile of ``analysis/energy.py`` and lowered through the
  backend its substrate-table row names (``core/backends.SUBSTRATES``);
* :func:`brick_cost` / :func:`transfer_cost` — roofline latency and
  modeled energy of one brick on one unit, and of one cross-unit edge;
  with a measured table (``telemetry/calibration.CostCalibration``) the
  brick's observed seconds and joules per token blend over the model;
* :func:`schedule` — exact chain dynamic programming over the
  BrickGraph: ``dp[i][a]`` is the best cost of bricks ``0..i`` with brick
  ``i`` on unit ``a``, edge transfers included; the objective (latency |
  energy) comes from the battery policy (``core/power.py``);
* :func:`fleet_accelerators` / :func:`schedule_split` — the same DP over
  a disaggregated prefill fleet and decode fleet, every cross-fleet edge
  priced at the transport's ``link_bw``.

Latency and energy here are the model's, from the reference's edge
profiles, unless a calibration table blends measurements in; no modeled
number is a reading of the card.  The reference's pod profile
(``make_virtual_accelerators``, submeshes of a mesh) has no counterpart
on one card.  The admission budgets (staged-ahead depth, per-class
staging and paged-KV block budgets) close the module.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.energy import (EDGE_CPU, EDGE_GPU, EDGE_NPU,
                                         EnergyProfile, TPU_V5E,
                                         step_energy, step_time)
from repro_torch.core.backends import bit_efficiency, substrate_backend
from repro_torch.core.bricks import Brick, BrickGraph, brick_param_bytes
from repro_torch.core.slot_classes import shed_scales
from repro_torch.telemetry.calibration import CostCalibration


@dataclass(frozen=True)
class Accelerator:
    """A compute unit the scheduler can place a brick on.

    The cost model (:meth:`throughput_scale`) and backend resolution
    (:meth:`backend_name`) read the same substrate-table row of the
    unit's energy profile, so a unit is never priced as one substrate and
    lowered through another."""

    name: str
    profile: EnergyProfile
    static_only: bool = False          # paper §NPU: static graphs only
    backend: Optional[str] = None      # core/backends registry name; None
                                       # = the substrate table's row

    def throughput_scale(self, quant_label: str) -> float:
        return bit_efficiency(self.profile.name, quant_label)

    def backend_name(self) -> str:
        """The backend this unit lowers bricks through: its ``backend``
        field, else its profile's substrate row, else host (the paper's
        edge units are emulated on a pinned CPU thread; the ``submesh``
        row has no counterpart on one card and falls through to host)."""
        if self.backend:
            return self.backend
        sub = substrate_backend(self.profile.name)
        return sub if sub is not None and sub != "submesh" else "host"


def edge_accelerators() -> List[Accelerator]:
    """The paper's RK3566: NPU (static, low-bit), Mali GPU, Cortex CPU.
    The NPU and CPU lower through the host backend (a pinned CPU thread,
    plain versions of the kernels), the GPU through the device backend
    (the card)."""
    return [
        Accelerator("npu", EDGE_NPU, static_only=True),
        Accelerator("gpu", EDGE_GPU),
        Accelerator("cpu", EDGE_CPU),
    ]


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

@dataclass
class BrickCost:
    latency_s: float
    energy_j: float
    feasible: bool = True


def brick_cost(brick: Brick, acc: Accelerator, n_tokens: int,
               mem_clock_scale: float = 1.0, batch: int = 1,
               calibration: Optional[CostCalibration] = None) -> BrickCost:
    """Roofline latency + modeled energy of ONE call over a microbatch of
    ``batch`` requests (``n_tokens`` each) on one unit: compute scales
    with the microbatch, the brick's weight traffic is charged once per
    call.  A dynamic-shape brick on a static-only unit is infeasible.

    ``calibration``: when the table holds a sample for ``(brick,
    profile)``, or the brick's profile-agnostic key, its measured seconds
    per token (and joules per token, when observed) blend over the model
    with weight ``n / (n + prior)``.  Infeasible stays infeasible: no
    observation puts a dynamic brick on a static-only unit."""
    if not brick.static_shape and acc.static_only:
        return BrickCost(float("inf"), float("inf"), feasible=False)
    flops = brick.flops_per_token * n_tokens * max(1, batch)
    wbytes = max(brick.param_bytes, 1)
    scale = acc.throughput_scale(brick.quant_label)
    p = acc.profile
    eff = dataclasses.replace(
        p, peak_flops=p.peak_flops * max(scale, 1e-9),
        hbm_bw=p.hbm_bw * mem_clock_scale)
    t = step_time(eff, flops, wbytes)
    e = step_energy(eff, flops, wbytes, 0.0, wall_s=t)
    if calibration is not None:
        s = calibration.sample(brick.name, p.name)
        if s is not None and s.tokens > 0:
            w = calibration.weight(s.n)
            units = n_tokens * max(1, batch)
            t = (1.0 - w) * t + w * s.seconds_per_token * units
            if s.joules > 0:
                e = (1.0 - w) * e + w * s.joules_per_token * units
    return BrickCost(t, e)


def transfer_cost(bytes_moved: int, src: Accelerator, dst: Accelerator
                  ) -> Tuple[float, float]:
    """Edge hand-off: zero when staying put (the TABM zero-copy), the
    slower unit's link otherwise."""
    if src.name == dst.name:
        return 0.0, 0.0
    bw = min(src.profile.link_bw, dst.profile.link_bw)
    t = bytes_moved / bw
    e = bytes_moved * (src.profile.e_link + dst.profile.e_link) / 2
    return t, e


# ---------------------------------------------------------------------------
# placement (exact chain DP)
# ---------------------------------------------------------------------------

@dataclass
class Placement:
    assignment: Dict[str, str]
    latency_s: float
    energy_j: float
    per_brick: Dict[str, BrickCost] = field(default_factory=dict)
    # brick -> backend registry name, carried from each accelerator so
    # compile_plan lowers through the substrate the cost model priced
    backends: Dict[str, str] = field(default_factory=dict)

    def __str__(self):
        cells = " | ".join(f"{b}->{a}" for b, a in self.assignment.items())
        return (f"Placement[{cells}] lat={self.latency_s*1e3:.2f}ms "
                f"E={self.energy_j:.3f}J")


def edge_bytes(graph: BrickGraph, n_tokens: int) -> int:
    """Activation bytes crossing a brick edge: (tokens, d_model) bf16."""
    return n_tokens * graph.cfg.d_model * 2


def schedule(graph: BrickGraph, accels: List[Accelerator], n_tokens: int,
             objective: str = "latency", mem_clock_scale: float = 1.0,
             batch: int = 1,
             calibration: Optional[CostCalibration] = None) -> Placement:
    """Exact DP over the brick chain: ``dp[i][a]`` = best objective of
    bricks ``0..i`` with brick ``i`` on unit ``a``.  ``batch`` prices
    every brick and edge for a microbatch of that many requests;
    ``calibration`` threads measured per-brick costs into every cell
    (:func:`brick_cost`), so a brick the table shows slower than modeled
    on one unit migrates off it."""
    bricks = graph.bricks
    nA = len(accels)
    costs = [[brick_cost(b, a, n_tokens, mem_clock_scale, batch=batch,
                         calibration=calibration)
              for a in accels] for b in bricks]
    xfer = edge_bytes(graph, n_tokens) * max(1, batch)

    def metric(c: BrickCost, t_extra: float, e_extra: float) -> float:
        if objective == "energy":
            return c.energy_j + e_extra
        return c.latency_s + t_extra

    INF = float("inf")
    dp = [[INF] * nA for _ in bricks]
    back: List[List[int]] = [[-1] * nA for _ in bricks]
    for a in range(nA):
        if costs[0][a].feasible:
            dp[0][a] = metric(costs[0][a], 0.0, 0.0)
    for i in range(1, len(bricks)):
        for a in range(nA):
            if not costs[i][a].feasible:
                continue
            for pa in range(nA):
                if dp[i - 1][pa] == INF:
                    continue
                tt, te = transfer_cost(xfer, accels[pa], accels[a])
                cand = dp[i - 1][pa] + metric(costs[i][a], tt, te)
                if cand < dp[i][a]:
                    dp[i][a] = cand
                    back[i][a] = pa

    last = min(range(nA), key=lambda a: dp[-1][a])   # first minimum
    if dp[-1][last] == INF:
        raise RuntimeError("no feasible placement")
    order = [last]
    for i in range(len(bricks) - 1, 0, -1):
        order.append(back[i][order[-1]])
    order.reverse()

    assignment = {b.name: accels[a].name for b, a in zip(bricks, order)}
    backends = {b.name: accels[a].backend_name()
                for b, a in zip(bricks, order)}
    lat = e = 0.0
    per = {}
    prev = None
    for i, (b, a) in enumerate(zip(bricks, order)):
        c = costs[i][a]
        per[b.name] = c
        lat += c.latency_s
        e += c.energy_j
        if prev is not None and prev != a:
            tt, te = transfer_cost(xfer, accels[prev], accels[a])
            lat, e = lat + tt, e + te
        prev = a
    return Placement(assignment, lat, e, per, backends=backends)


def populate_brick_bytes(graph: BrickGraph, params) -> None:
    """Fill ``Brick.param_bytes`` from real (possibly quantized) params."""
    sizes = brick_param_bytes(graph, params)
    graph.bricks = [dataclasses.replace(b, param_bytes=sizes[b.name])
                    for b in graph.bricks]


# ---------------------------------------------------------------------------
# disaggregated fleets (prefill fleet + decode fleet over a Transport)
# ---------------------------------------------------------------------------

def fleet_accelerators(transport, n_devices: int = 2,
                       calibration: Optional[CostCalibration] = None
                       ) -> List[Accelerator]:
    """The two-fleet disaggregated topology as scheduler rows: a
    compute-rich, static-only prefill fleet (it takes the static vision
    and projector bricks; the dynamic decode bricks cannot land there)
    and a decode fleet at a quarter of the FLOPs but the full memory
    bandwidth, both on the TPU v5e-class profile with ``link_bw`` capped
    at ``transport.link_bw``, so every cross-fleet edge the DP prices is
    a wire crossing.  When ``calibration`` holds a link observation for
    this transport (``CostCalibration.observe_link``, fed from
    ``Transport.measured_link_bw``), the measured bytes/s blends over the
    static class row.  The fleets lower through ``"device:0"`` and
    ``"device:1"`` (``"device:0"`` both when ``n_devices`` is 1): on one
    card :func:`schedule_split` only prices the second."""
    bw = float(getattr(transport, "link_bw", 8e9))
    if calibration is not None:
        bw = calibration.link_bw(getattr(transport, "name", None), bw)
    wire = lambda p: dataclasses.replace(p, link_bw=min(p.link_bw, bw))
    prefill_p = TPU_V5E
    decode_p = dataclasses.replace(TPU_V5E,
                                   peak_flops=TPU_V5E.peak_flops * 0.25)
    dec_dev = "device:1" if n_devices > 1 else "device:0"
    return [
        Accelerator("prefill-fleet", wire(prefill_p), static_only=True,
                    backend="device:0"),
        Accelerator("decode-fleet", wire(decode_p), backend=dec_dev),
    ]


def schedule_split(graph: BrickGraph, transport, n_tokens: int,
                   objective: str = "latency", batch: int = 1,
                   calibration: Optional[CostCalibration] = None
                   ) -> Placement:
    """Price the prefill/decode split over a serialized transport: the
    chain DP of :func:`schedule` over :func:`fleet_accelerators`, so a
    slow wire pushes compute toward fewer crossings and a fast one frees
    the DP to cut where the roofline prefers.  ``transport``: a Transport
    class, instance or registry name (``core/transport``).
    ``calibration`` feeds both blending edges: measured per-brick costs
    into :func:`brick_cost` and measured wire bandwidth into the fleet
    rows' ``link_bw``."""
    if isinstance(transport, str):
        from repro_torch.core.transport import resolve_transport
        transport = resolve_transport(transport)
    return schedule(graph,
                    fleet_accelerators(transport, calibration=calibration),
                    n_tokens, objective, batch=batch,
                    calibration=calibration)


# ---------------------------------------------------------------------------
# admission budgets (the async TABM producer/consumer pipeline)
# ---------------------------------------------------------------------------

def staged_ahead_depth(ring) -> int:
    """How far the producer has run ahead of the consumer: slots STAGING
    or READY in the TABM ring (CONSUMED slots are behind the consumer)."""
    return ring.staged_ahead()


def staging_budget(ring, in_flight: int, max_ahead: Optional[int] = None
                   ) -> int:
    """How many more requests the engine may hand to the staging worker:
    ``max_ahead`` (default: ring size) less staged-ahead depth less
    requests already handed over but not committed."""
    cap = ring.n_slots if max_ahead is None else max_ahead
    return max(0, cap - staged_ahead_depth(ring) - in_flight)


def class_staging_budgets(pool, in_flight: Dict[str, int],
                          depth_scale: float = 1.0,
                          stage_batch: Optional[int] = None
                          ) -> Dict[str, int]:
    """Per-class admission budgets over a class-partitioned TABM pool:
    each class charged against its own ring and battery-scaled depth
    (``pool.admission_table``), capped at one staging microbatch."""
    budgets = {}
    for name, (ring, cap) in pool.admission_table(depth_scale).items():
        flight = in_flight.get(name, 0)
        if ring is None:                       # unmaterialized: EMPTY ring
            budget = max(0, cap - flight)
        else:
            budget = staging_budget(ring, flight, max_ahead=cap)
        if stage_batch is not None and stage_batch > 0:
            budget = min(budget, stage_batch)
        budgets[name] = budget
    return budgets


def kv_block_budgets(pool, total_blocks: int,
                     used: Dict[Optional[str], int],
                     kv_scale: float = 1.0,
                     energy_pressure: float = 1.0) -> Dict[str, int]:
    """Per-class paged-KV block budgets: each class's share of the block
    pool under the battery's ``class_kv_scale`` (high-resolution classes
    shed first, the order of :func:`shed_scales`), tightened by a
    measured-over-modeled ``energy_pressure`` above 1, less the blocks the
    class holds now (``used``)."""
    eff_scale = kv_scale / max(1.0, energy_pressure)
    budgets = {}
    for name, eff in shed_scales(pool.classes, eff_scale).items():
        cap = max(0, min(total_blocks, int(total_blocks * eff)))
        budgets[name] = max(0, cap - used.get(name, 0))
    return budgets
