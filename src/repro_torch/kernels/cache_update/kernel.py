"""Launcher of the Hopper cache-row-update kernel
(``csrc/cache_update.cu``).

Checks device, dtype, shapes and strides, launches on the current stream
through the C entry point and raises if the entry returns a CUDA error.
The cache is written in place through its strides (a layer slice of a
stacked cache is a view); nothing is allocated but the (B,) int32 index
when the caller gives another form.  The library is built on first use
(``kernels/build.py``).  Runs on the card only; the CPU path is the
plain version in ``ref.py``, chosen by the wrapper in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.cache_update.ref import index_vector

LIBRARY = "cache_update"
SOURCES = ("cache_update.cu",)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}   # the instances' fp32 flag

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    if not getattr(lib, "_typed", False):
        lib.rt_cache_row_update.argtypes = [
            _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _I, _I, _P]
        lib.rt_cache_row_update.restype = _I
        lib._typed = True
    return lib


def launch_cache_row_update(cache, row, index) -> torch.Tensor:
    """cache (B,S,KV,hd) <- row (B,KV,hd) at index (B,) or a scalar, in
    place on the card; returns ``cache``."""
    for t in (cache, row):
        if not t.is_cuda:
            raise ValueError("cache_row_update: the kernel takes CUDA "
                             "tensors")
        if t.dtype not in DTYPES:
            raise ValueError(f"cache_row_update: the kernel takes bfloat16 "
                             f"or float32 tensors, got {t.dtype}")
    if cache.dim() != 4 or row.dim() != 3:
        raise ValueError(f"cache_row_update: expected cache (B,S,KV,hd) and "
                         f"row (B,KV,hd), got {tuple(cache.shape)} and "
                         f"{tuple(row.shape)}")
    B, S, KV, hd = cache.shape
    if tuple(row.shape) != (B, KV, hd):
        raise ValueError(f"cache_row_update: row {tuple(row.shape)} does "
                         f"not match cache {tuple(cache.shape)}")
    if cache.stride(3) != 1:
        raise ValueError("cache_row_update: the cache's head axis must be "
                         "contiguous (it is written in place)")
    if row.stride(2) != 1:
        row = row.contiguous()
    idx = index_vector(index, B, cache.device)
    if idx.shape != (B,):
        raise ValueError(f"cache_row_update: index {tuple(idx.shape)} for "
                         f"{B} rows")
    idx = idx.to(torch.int32).contiguous()
    cs, rs = cache.stride(), row.stride()
    err = library().rt_cache_row_update(
        cache.data_ptr(), row.data_ptr(), idx.data_ptr(), B, S, KV, hd,
        cs[0], cs[1], cs[2], rs[0], rs[1], DTYPES[cache.dtype],
        DTYPES[row.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cache_row_update: CUDA error {err}")
    return cache
