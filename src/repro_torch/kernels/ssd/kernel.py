"""Launchers of the Hopper SSD chunked-scan kernels (``csrc/ssd.cu``):
the forward and its backward.

Each checks device, dtypes, shapes and strides, allocates the outputs and
the fp32 scratch, launches on the current stream through its C entry
point and raises if the entry returns a CUDA error.  The forward's scratch
holds each chunk's state (the state before the chunk, once the scan has
run), each chunk's decay and each chunk's C.B^T per group; with
``want_states`` it returns the states for the backward to save.
:func:`route` names the forward kernels a call runs, from the inputs'
dtype: ``mma`` (bf16: tensor-core products, the fp32 operand split into
three bf16 terms) or ``simt`` (fp32: FFMA); :func:`bwd_route` the
backward's, ``bwd_bf16`` (tensor-core products, each fp32 operand split
into three bf16 terms) or ``bwd_f32`` (split TF32 on the tensor cores).
:func:`bwd_slice` sets how many of a group's heads one block of the
backward's keys and rows kernels sums dB and dC over.
The library is built on first use (``kernels/build.py``).  Runs on the
card only; the CPU path is the plain versions in ``ref.py``, chosen by the
wrapper in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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
        lib.rt_ssd.argtypes = [_P] * 10 + [_I] * 8 + [_L] * 12 + [_P]
        lib.rt_ssd.restype = _I
        lib.rt_ssd_backward.argtypes = [_P] * 20 + [_I] * 9 + [_L] * 12 + [_P]
        lib.rt_ssd_backward.restype = _I
        lib._typed = True
    return lib


def route(dtype: torch.dtype) -> str:
    """The kernels a call with x/B/C of ``dtype`` runs: ``mma`` for bf16,
    ``simt`` for fp32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def bwd_route(dtype: torch.dtype) -> str:
    """The backward kernels' launch-count route for x/B/C of ``dtype``."""
    return "bwd_bf16" if dtype == torch.bfloat16 else "bwd_f32"


# the blocks a backward's keys (or rows) kernel should have at least: 132
# SMs hold two each, and row tiles of one chunk differ up to 4x in work
BWD_BLOCKS = 512


def bwd_slice(B: int, S: int, H: int, G: int, chunk: int) -> int:
    """Heads a slice of the backward: the most of a group's H / G heads,
    dividing it, whose (batch, group, slice, chunk, 64-row tile) grid has
    at least BWD_BLOCKS blocks (else one head a slice).  A block sums dB
    and dC over its slice's heads in registers; the slices' shares are
    then added in order."""
    L = min(chunk, S)
    tiles = B * G * (S // L) * -(-L // 64)
    rep = H // G
    return next((hs for hs in range(rep, 0, -1)
                 if rep % hs == 0 and tiles * (rep // hs) >= BWD_BLOCKS), 1)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last axis is contiguous, else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _check(x, dt, A, Bm, Cm, chunk: int):
    """(B, S, H, P, G, N, L) of a call the kernels take; raises otherwise."""
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
    return B, S, H, P, G, N, L


def _strides(x, dt, Bm, Cm):
    return [s for t in (x, dt, Bm, Cm) for s in t.stride()[:3]]


def launch_ssd(x, dt, A, Bm, Cm, *, chunk: int, want_states: bool = False):
    """x (B,S,H,P), Bm/Cm (B,S,G,N) bf16 or fp32 (one dtype), dt (B,S,H)
    and A (H,) fp32, all CUDA tensors in the model's layout -> (y
    (B,S,H,P) in x's dtype, h_final (B,H,P,N) fp32), and with
    ``want_states`` the state before each chunk (B,H,S/L,P,N) fp32, the
    scratch the scan leaves it in (the same launch either way)."""
    B, S, H, P, G, N, L = _check(x, dt, A, Bm, Cm, chunk)
    x, Bm, Cm = _rows(x), _rows(Bm), _rows(Cm)
    A = A.contiguous()
    nc = S // L
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    states = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=dev)
    decay = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    cb = torch.empty((B, G, nc, L, L), dtype=torch.float32, device=dev)
    err = library().rt_ssd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), states.data_ptr(),
        decay.data_ptr(), cb.data_ptr(), B, S, H, P, G, N, L,
        int(x.dtype == torch.bfloat16), *_strides(x, dt, Bm, Cm),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd: CUDA error {err}")
    return (y, h, states) if want_states else (y, h)


def launch_ssd_backward(x, dt, A, Bm, Cm, states, dy, dh=None, *,
                        chunk: int,
                        heads_a_slice: Optional[int] = None):
    """The backward of ``launch_ssd`` on the same inputs: ``states`` the
    forward's (``want_states``), dy (B,S,H,P) the gradient of y, dh
    (B,H,P,N) that of h_final or None (zero); ``heads_a_slice`` (a
    divisor of H / G) in place of ``bwd_slice``'s.  Returns (dx in x's
    dtype, ddt fp32, dA fp32, dB and dC in B's dtype)."""
    B, S, H, P, G, N, L = _check(x, dt, A, Bm, Cm, chunk)
    nc = S // L
    if (not states.is_cuda or states.dtype != torch.float32
            or tuple(states.shape) != (B, H, nc, P, N)):
        raise ValueError(f"ssd backward: states {tuple(states.shape)} "
                         f"{states.dtype}, want {(B, H, nc, P, N)} fp32")
    if not dy.is_cuda or tuple(dy.shape) != (B, S, H, P):
        raise ValueError(f"ssd backward: dy {tuple(dy.shape)}, want "
                         f"{(B, S, H, P)} on the card")
    if dh is not None and (not dh.is_cuda
                           or tuple(dh.shape) != (B, H, P, N)):
        raise ValueError(f"ssd backward: dh {tuple(dh.shape)}, want "
                         f"{(B, H, P, N)} on the card")
    hs = heads_a_slice or bwd_slice(B, S, H, G, chunk)
    if hs < 1 or (H // G) % hs:
        raise ValueError(f"ssd backward: {hs} heads a slice of {H // G}")
    nsl = H // G // hs
    x, Bm, Cm = _rows(x), _rows(Bm), _rows(Cm)
    A, states = A.contiguous(), states.contiguous()
    dy = dy.to(x.dtype).contiguous()
    if dh is not None:
        # the scan reads dh in 16-byte vectors
        dh = dh.to(torch.float32).clone(memory_format=torch.contiguous_format)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), **f32)
    dA = torch.empty((H,), **f32)
    dB = torch.empty((B, S, G, N), dtype=Bm.dtype, device=dev)
    dC = torch.empty((B, S, G, N), dtype=Cm.dtype, device=dev)
    dstate = torch.empty((B, H, nc, P, N), **f32)
    decay = torch.empty((B, H, nc), **f32)
    cb = torch.empty((B, G, nc, L, L), **f32)
    # each head slice's share of dB and dC, added in order by the sums kernel
    dbp, dcp = ((torch.empty((nsl, B, S, G, N), **f32) for _ in range(2))
                if nsl > 1 else (None, None))
    vec = torch.empty((5, B, H, S), dtype=torch.float64, device=dev)
    da_part = torch.empty((B, H, nc), **f32)
    err = library().rt_ssd_backward(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), states.data_ptr(), dy.data_ptr(),
        None if dh is None else dh.data_ptr(), dstate.data_ptr(),
        decay.data_ptr(), cb.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        None if dbp is None else dbp.data_ptr(),
        None if dcp is None else dcp.data_ptr(), vec.data_ptr(),
        da_part.data_ptr(), B, S, H, P, G, N, L,
        int(x.dtype == torch.bfloat16), hs, *_strides(x, dt, Bm, Cm),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd backward: CUDA error {err}")
    return dx, ddt, dA, dB, dC
