"""Launcher of the Hopper linear-attention kernel
(``csrc/linear_attention.cu``).

Checks device, dtypes, shapes and strides, allocates the outputs and the
fp32 scratch (each 64-row tile's state and normalizer per kv head),
launches on the current stream through the C entry point and raises if
the entry returns a CUDA error.  The library is built on first use
(``kernels/build.py``).  Runs on the card only; the CPU path is the plain
version in ``ref.py``, chosen by the wrapper in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import load_library

LIBRARY = "linear_attention"
SOURCES = ("linear_attention.cu",)
MAX_CHUNK = 256
MAX_HEAD_DIM = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    if not getattr(lib, "_typed", False):
        lib.rt_linear_attention.argtypes = ([_P] * 9 + [_I] * 7 + [_L] * 9
                                            + [_P])
        lib.rt_linear_attention.restype = _I
        lib._typed = True
    return lib


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last axis is contiguous, else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def launch_linear_attention(q, k, v, *, chunk: int,
                            valid_len: Optional[torch.Tensor] = None):
    """q (B,S,H,hd), k/v (B,S,KV,hd) bf16 or fp32 (one dtype), CUDA
    tensors in the model's layout; ``valid_len`` (B,) integer or None ->
    (out (B,S,H,hd) in q's dtype, state (B,H,hd,hd) fp32, z (B,H,hd)
    fp32)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"linear_attention: the kernel takes CUDA "
                             f"tensors ({name})")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("linear_attention: expected q (B,S,H,hd), k/v "
                         "(B,S,KV,hd)")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if (tuple(k.shape) != tuple(v.shape)
            or tuple(k.shape) != (B, S, KV, hd)):
        raise ValueError(f"linear_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"linear_attention: q/k/v must share bfloat16 or "
                         f"float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if KV < 1 or H % KV:
        raise ValueError(f"linear_attention: {H} query heads over {KV} kv "
                         f"heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"linear_attention: head dim {hd} not in "
                         f"1..{MAX_HEAD_DIM}")
    L = min(chunk, S)
    if not 1 <= L <= MAX_CHUNK or S % L:
        raise ValueError(f"linear_attention: sequence {S} is not a "
                         f"multiple of the chunk {L} (at most {MAX_CHUNK})")
    vl = None
    if valid_len is not None:
        if tuple(valid_len.shape) != (B,) or valid_len.is_floating_point():
            raise ValueError(f"linear_attention: valid_len must be (B,) "
                             f"integers, got {tuple(valid_len.shape)} "
                             f"{valid_len.dtype}")
        vl = valid_len.to(device=q.device, dtype=torch.int32).contiguous()
    q, k, v = _rows(q), _rows(k), _rows(v)
    nt = S // L * -(-L // 64)               # 64-row tiles of the chunks
    dev = q.device
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    z = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    states = torch.empty((B, KV, nt, hd, hd), dtype=torch.float32,
                         device=dev)
    zs = torch.empty((B, KV, nt, hd), dtype=torch.float32, device=dev)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = library().rt_linear_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if vl is None else vl.data_ptr(), out.data_ptr(),
        state.data_ptr(), z.data_ptr(), states.data_ptr(), zs.data_ptr(),
        B, S, H, KV, hd, L, int(q.dtype == torch.bfloat16), *strides,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_attention: CUDA error {err}")
    return out, state, z
