"""Launcher of the Hopper SSD chunked-scan kernel (``csrc/ssd.cu``).

Checks device, dtypes, shapes and strides, allocates the outputs and the
fp32 scratch (each chunk's state, each chunk's decay), launches on the
current stream through the C entry point and raises if the entry returns
a CUDA error.  The library is built on first use (``kernels/build.py``).
Runs on the card only; the CPU path is the plain version in ``ref.py``,
chosen by the wrapper in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

LIBRARY = "ssd"
SOURCES = ("ssd.cu",)
MAX_CHUNK = 256
MAX_STATE = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    if not getattr(lib, "_typed", False):
        lib.rt_ssd.argtypes = [_P] * 9 + [_I] * 8 + [_L] * 12 + [_P]
        lib.rt_ssd.restype = _I
        lib._typed = True
    return lib


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last axis is contiguous, else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def launch_ssd(x, dt, A, Bm, Cm, *, chunk: int):
    """x (B,S,H,P), Bm/Cm (B,S,G,N) bf16 or fp32 (one dtype), dt (B,S,H)
    and A (H,) fp32, all CUDA tensors in the model's layout -> (y
    (B,S,H,P) in x's dtype, h_final (B,H,P,N) fp32)."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_cuda:
            raise ValueError(f"ssd: the kernel takes CUDA tensors ({name})")
    if x.dim() != 4 or Bm.dim() != 4 or Cm.dim() != 4 or dt.dim() != 3:
        raise ValueError("ssd: expected x (B,S,H,P), dt (B,S,H), "
                         "Bm/Cm (B,S,G,N)")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(Bm.shape) != tuple(Cm.shape) or tuple(Bm.shape[:2]) != (B, S)
            or tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)):
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)} disagree")
    if x.dtype not in (torch.bfloat16, torch.float32) or not (
            Bm.dtype == Cm.dtype == x.dtype):
        raise ValueError(f"ssd: x/Bm/Cm must share bfloat16 or float32, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd: dt and A must be float32, got {dt.dtype}, "
                         f"{A.dtype}")
    if G < 1 or H % G:
        raise ValueError(f"ssd: {H} heads over {G} groups")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd: state size {N} not in 1..{MAX_STATE}")
    L = min(chunk, S)
    if not 1 <= L <= MAX_CHUNK or S % L:
        raise ValueError(f"ssd: sequence {S} is not a multiple of the "
                         f"chunk {L} (at most {MAX_CHUNK})")
    x, Bm, Cm = _rows(x), _rows(Bm), _rows(Cm)
    A = A.contiguous()
    nc = S // L
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    states = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=dev)
    decay = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    strides = [s for t in (x, dt, Bm, Cm) for s in t.stride()[:3]]
    err = library().rt_ssd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), states.data_ptr(),
        decay.data_ptr(), B, S, H, P, G, N, L,
        int(x.dtype == torch.bfloat16), *strides,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd: CUDA error {err}")
    return y, h
