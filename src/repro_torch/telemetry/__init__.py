"""Telemetry of the port: wall-time probes and the per-brick ledger (own
copies of the reference's jax-free modules)."""
from repro_torch.telemetry.ledger import Ledger, PhaseRecord
from repro_torch.telemetry.probes import WallProbe

__all__ = ["Ledger", "PhaseRecord", "WallProbe"]
