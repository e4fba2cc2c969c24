"""Mamba-2 SSD chunked scan: a Hopper kernel with its plain version and
wrapper."""
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ref_ssd, ref_ssd_chunked

__all__ = ["ssd", "ref_ssd", "ref_ssd_chunked"]
