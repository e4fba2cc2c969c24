"""Admission budgets of the serving engine (the part of the reference's
scheduler the port needs so far): staged-ahead depth, per-class staging
budgets and per-class paged-KV block budgets.  The placement DP
(``schedule``), accelerator profiles and ``brick_cost`` are not ported."""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.slot_classes import shed_scales


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
