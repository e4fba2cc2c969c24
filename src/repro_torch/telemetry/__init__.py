"""Telemetry of the port: wall-time probes, the per-brick ledger, the
measured cost table the scheduler consults and the fleet battery
simulator (own copies of the reference's jax-free modules)."""
from repro_torch.telemetry.calibration import CalSample, CostCalibration
from repro_torch.telemetry.ledger import Ledger, PhaseRecord
from repro_torch.telemetry.probes import WallProbe

__all__ = ["CalSample", "CostCalibration", "Ledger", "PhaseRecord",
           "WallProbe"]
