"""KV-cache row update: a Hopper kernel (one decode step's K or V row
written into a donated cache in place) with its plain version and
wrapper."""
from repro_torch.kernels.cache_update.ops import cache_row_update
from repro_torch.kernels.cache_update.ref import ref_cache_row_update

__all__ = ["cache_row_update", "ref_cache_row_update"]
