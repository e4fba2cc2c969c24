"""Analytic models of the port (the energy model the scheduler prices
placements with)."""
