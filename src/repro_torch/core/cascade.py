"""On-Demand Cascade Inference (paper §3.2, Fig. 2).

In Critical Conservation mode the system becomes event-triggered and
strictly sequential: each brick is loaded, performs its task, is
released, and passes only its output to the next stage — a domino-like
chain whose peak memory is max(brick) instead of sum(bricks).

The cascade is a backend strategy, not an interpreter: it compiles the
BrickGraph with :func:`repro_torch.core.plan.compile_plan`, every brick
lowered through a transient :class:`~repro_torch.core.backends.HostBackend`
(``residency="one-brick"``) whose execution device is the card unless
the caller passes ``device="cpu"``.  The params stay host-side (pinned
for the card); every ``run_once`` loads one brick onto the device,
applies it through the same brick callable the engine's plan uses,
and drops its params before the next brick loads.  There is no per-kind
dispatch here; the dataflow is the bricks' declared ports.  The trace's
resident bytes show the max-not-sum claim.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.core.backends import HostBackend
from repro_torch.core.bricks import BrickGraph
from repro_torch.core.plan import PlanEvent, PlanTrace, compile_plan

# the reference's names for the trace types
CascadeEvent = PlanEvent
CascadeTrace = PlanTrace


class CascadeRunner:
    """Event-triggered sequential pipeline over a BrickGraph: the
    one-brick lowering of the shared ExecutionPlan through a transient
    host backend on ``device``."""

    def __init__(self, graph: BrickGraph, params: Dict[str, Any],
                 device=None):
        """``params``: the full param tree, held host-side by the plan;
        nothing stays on ``device`` (default ``cuda``) between events."""
        self.graph = graph
        self.cfg = graph.cfg
        self.backend = HostBackend(device="cuda" if device is None
                                   else device)
        self.plan = compile_plan(graph, params, backend=self.backend,
                                 residency="one-brick")

    def run_once(self, inputs: Dict[str, Any],
                 trace: Optional[CascadeTrace] = None):
        """One event-triggered inference pass through every brick.
        Returns (final logits, residency trace)."""
        return self.plan.run(inputs, trace=trace)
