"""Plain PyTorch version of the cache-row-update kernel: the reference's
``ref_cache_row_update`` (``cache.at[b, index].set(row)``) written in
place, as the reference's donation gives.

The wrapper in ``ops.py`` runs it for CPU tensors; the tests hold it
against the reference package, and the card's checks hold the kernel
against it bit for bit.
"""
from __future__ import annotations

import torch


def index_vector(index, batch: int, device) -> torch.Tensor:
    """``index`` as a (batch,) tensor: a scalar is broadcast to every row,
    as the reference's ``ops.py`` does."""
    idx = torch.as_tensor(index, device=device)
    if idx.dim() == 0:
        idx = idx.expand(batch)
    return idx


def ref_cache_row_update(cache, row, index):
    """cache (B,S,KV,hd) <- row (B,KV,hd), cast to the cache's dtype, at
    [b, index[b]] IN PLACE; ``index`` (B,) int32 or a scalar.  Rows whose
    index is outside [0, S) write nothing.  Returns ``cache``."""
    B, S = cache.shape[:2]
    idx = index_vector(index, B, cache.device).to(torch.long)
    ok = (idx >= 0) & (idx < S)
    b = torch.arange(B, device=cache.device)[ok]
    cache[b, idx[ok]] = row[ok].to(cache.dtype)
    return cache
