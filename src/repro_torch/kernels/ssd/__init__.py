"""Mamba-2 SSD chunked scan: Hopper kernels (the forward and its
backward) with their plain versions and wrapper."""
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import (ref_ssd, ref_ssd_backward,
                                         ref_ssd_chunked)

__all__ = ["ssd", "ref_ssd", "ref_ssd_backward", "ref_ssd_chunked"]
