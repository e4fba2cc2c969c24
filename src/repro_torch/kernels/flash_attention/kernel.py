"""Launcher of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

Checks device, dtype, shapes and strides, allocates the output, launches
on the current stream through the C entry point and raises if the entry
returns a CUDA error.  The library is built on first use
(``kernels/build.py``).  Runs on the card only; the CPU path is the plain
version in ``ref.py``, chosen by the wrapper in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

LIBRARY = "flash_attention"
SOURCES = ("flash_attention.cu",)
HEAD_DIMS = (16, 32, 64, 128, 160)   # the kernel's template instantiations
# the instances: dtype -> C entry point, and the kernel behind it (its
# launch-count route): bf16 the warp-specialised wgmma kernel, fp32 split
# TF32 on mma.sync (three tf32 products an fp32 product)
ENTRIES = {torch.bfloat16: "rt_flash_attention",
           torch.float32: "rt_flash_attention_f32"}
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    if not getattr(lib, "_typed", False):
        for name in ENTRIES.values():
            fn = getattr(lib, name)
            fn.argtypes = [
                _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                ctypes.c_float, _P]
            fn.restype = _I
        lib._typed = True
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its strides (head
    axis contiguous, every stride and the start 16-byte aligned: TMA's
    condition for the bf16 kernel's tensor maps, the 16-byte cp.async
    copies' for the fp32 one), else a contiguous copy."""
    per_vec = 16 // t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and not any(s % per_vec for s in t.stride()[:3])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def launch_flash_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) bf16 or fp32 CUDA tensors (one
    dtype) in the model's layout -> o (B,Sq,H,hd)."""
    for t in (q, k, v):
        if not t.is_cuda:
            raise ValueError("flash_attention: the kernel takes CUDA "
                             "tensors")
        if t.dtype not in ENTRIES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: the kernel takes bfloat16 "
                             f"or float32 inputs of one dtype, got "
                             f"{[x.dtype for x in (q, k, v)]}")
        if t.dim() != 4:
            raise ValueError("flash_attention: expected (B, S, heads, hd)")
    B, Sq, H, hd = q.shape
    Bk, Sk, KV, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or hdk != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads over {KV} "
                         f"kv heads")
    if Sq < 1 or Sk < 1:
        raise ValueError("flash_attention: empty sequence")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    err = getattr(library(), ENTRIES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, Sk, H, KV, hd, int(causal), *strides,
        float(hd ** -0.5), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err}")
    return o
