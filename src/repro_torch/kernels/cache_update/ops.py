"""Public wrapper of the cache-row-update kernel.

``cache_row_update`` dispatches on the device of the cache alone: a CPU
tensor runs the plain version (``ref.ref_cache_row_update``); a CUDA
tensor launches the Hopper kernel (``kernel.py``) or raises — there is no
fallback.  Both write the cache in place: the caller donates it, as the
reference's wrapper does (``donate_argnums=(0,)``).  Each launch adds one
to the count ``cache_row_update`` in the kernels' launch-count registry
(``repro_torch.kernels``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch, refuse_grad, register_kernels
from repro_torch.kernels.cache_update import kernel as K
from repro_torch.kernels.cache_update.ref import ref_cache_row_update


def cache_row_update(cache: torch.Tensor, row: torch.Tensor,
                     index) -> torch.Tensor:
    """cache (B,S,KV,hd) <- row (B,KV,hd) at per-row positions ``index``
    ((B,) int32, or a scalar for every row), in place; rows whose index is
    outside [0, S) write nothing.  Returns ``cache``."""
    if cache.device.type == "cpu":
        return ref_cache_row_update(cache, row, index)
    if cache.device.type != "cuda":
        raise ValueError(f"cache_row_update: unsupported device "
                         f"{cache.device}")
    refuse_grad("cache_row_update", cache, row)
    out = K.launch_cache_row_update(cache, row, index)
    count_launch("cache_row_update")
    return out


register_kernels("cache_row_update")
