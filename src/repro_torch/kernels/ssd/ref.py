"""Plain PyTorch versions of the SSD kernel: the port's ``ssd_chunked``
(the function the kernel computes, all arithmetic in fp32) and
``ssd_reference``, the sequential recurrence, as its oracle.

The wrapper in ``ops.py`` runs ``ref_ssd_chunked`` for CPU tensors; the
tests hold both against the reference package, and the card's checks
hold the kernel against ``ref_ssd_chunked``.
"""
from __future__ import annotations

from repro_torch.models.mamba2 import ssd_chunked as ref_ssd_chunked
from repro_torch.models.mamba2 import ssd_reference as ref_ssd

__all__ = ["ref_ssd", "ref_ssd_chunked"]
