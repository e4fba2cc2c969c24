"""Launchers of the Hopper fused-decode kernels (``csrc/fused_decode.cu``).

Each launcher takes CUDA tensors, checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches
on the current stream through the C entry point, and raises if the entry
returns a CUDA error.  The library is built on first use
(``kernels/build.py``).  These run on the card only; the CPU path is the
plain version in ``ref.py``, chosen by the wrappers in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels.build import load_library

LIBRARY = "fused_decode"
SOURCES = ("fused_decode.cu",)
MAX_ROWS = 8          # cohort rows per launch (kMaxRows)
ACTS = {"silu": 0, "gelu": 1, "relu": 2, "squared_relu": 3}
# the GEMV kernels' instances: activation dtype -> the entries' fp32 flag
DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    if not getattr(lib, "_typed", False):
        lib.rt_fused_qkv.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _I, _I, _P]
        lib.rt_fused_mlp.argtypes = [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                     _P, _P, _P, _I, _P, _I, _I, _P]
        lib.rt_kv_row_scatter.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                          _I, _I, _P]
        for fn in (lib.rt_fused_qkv, lib.rt_fused_mlp, lib.rt_kv_row_scatter):
            fn.restype = _I
        lib._typed = True
    return lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr_array(ptrs: Sequence[int]):
    return (ctypes.c_void_p * len(ptrs))(*[p or None for p in ptrs])


def _int_array(vals: Sequence[int]):
    return (ctypes.c_int * len(vals))(*vals)


def k_chunk_for(K: int, tiles: int) -> int:
    """K rows per block: the largest of 128/64/32 that still gives the
    grid ~2 blocks per SM (132 SMs), so enough loads are in flight."""
    for c in (128, 64):
        if tiles * -(-K // c) >= 264:
            return min(c, K)
    return min(32, K)


class _Weight:
    """One GEMM weight as the kernel reads it: a (K, n) matrix whose last
    logical axes are flattened, packed (int32 codes + fp32 scales) or
    dense (the activations' dtype)."""

    def __init__(self, w, K: int, dtype: torch.dtype, name: str):
        if isinstance(w, QTensor):
            if w.padded or w.shape[-1] % w.spec.group_size:
                raise ValueError(f"{name}: padded packed weight "
                                 f"{w.shape} is not supported")
            if w.dtype != dtype:
                raise ValueError(f"{name}: weight dtype {w.dtype} != "
                                 f"activation dtype {dtype}")
            if w.shape[0] != K:
                raise ValueError(f"{name}: K {w.shape[0]} != {K}")
            self.n = 1
            for s in w.shape[1:]:
                self.n *= s
            codes, scales = w.codes, w.scales
            _require_cuda(codes, scales)
            if codes.dtype != torch.int32 or scales.dtype != torch.float32:
                raise ValueError(f"{name}: codes must be int32 and scales "
                                 f"float32")
            self.bits, self.group = w.spec.bits, w.spec.group_size
            self.keep = (codes.contiguous(), scales.contiguous())
            self.ptrs = (self.keep[0].data_ptr(), self.keep[1].data_ptr())
        else:
            _require_cuda(w)
            if w.dtype != dtype or w.shape[0] != K:
                raise ValueError(f"{name}: dense weight {tuple(w.shape)} "
                                 f"{w.dtype} does not match K={K}, {dtype}")
            self.n = w[0].numel()
            if (self.n * w.element_size()) % 16:
                raise ValueError(f"{name}: dense rows must be 16-byte "
                                 f"multiples")
            self.bits, self.group = 0, 1
            self.keep = (w.contiguous(),)
            self.ptrs = (self.keep[0].data_ptr(), 0)


def _tiles(w: _Weight, elem_bytes: int) -> int:
    """Grid columns of one weight: 8 units (words or 16-byte vectors) per
    block."""
    per_unit = 32 // w.bits if w.bits else 16 // elem_bytes
    return -(-(w.n // per_unit) // 8)


def _activation_dtype(h: torch.Tensor, what: str) -> torch.dtype:
    """The GEMV kernels' instances: bf16 or fp32 activations (and dense
    weights of the same dtype)."""
    if h.dtype not in DTYPES:
        raise ValueError(f"{what}: the kernel takes bfloat16 or float32 "
                         f"activations, got {h.dtype}")
    return h.dtype


def _require_cuda(*ts):
    for t in ts:
        if not t.is_cuda:
            raise ValueError("the fused-decode kernels take CUDA tensors")


def _rows(h: torch.Tensor) -> List[Tuple[int, int]]:
    bc = h.shape[0]
    return [(r, min(bc, r + MAX_ROWS)) for r in range(0, bc, MAX_ROWS)]


def launch_fused_qkv(h, wq, wk, wv, bq=None, bk=None, bv=None):
    """h (bc,1,D) -> q (bc,1,H,hd), k, v (bc,1,KV,hd) on the card.
    Returns (outputs, launches)."""
    dtype = _activation_dtype(h, "fused_qkv")
    _require_cuda(h)
    bc, _, D = h.shape
    ws = [_Weight(w, D, dtype, nm) for w, nm in
          ((wq, "wq"), (wk, "wk"), (wv, "wv"))]
    biases = (bq, bk, bv)
    if any(b is None for b in biases) and not all(b is None for b in biases):
        raise ValueError("fused_qkv: give all three biases or none")
    bias_t = [None if b is None else b.to(dtype).contiguous()
              for b in biases]
    tail = [tuple((wq, wk, wv)[i].shape[1:]) for i in range(3)]
    outs = [torch.empty((bc, 1) + tail[i], dtype=dtype, device=h.device)
            for i in range(3)]
    x = h.reshape(bc, D).contiguous()
    n_total = sum(w.n for w in ws)
    tiles = sum(_tiles(w, h.element_size()) for w in ws)
    kc = k_chunk_for(D, tiles)
    ks = -(-D // kc)
    lib = library()
    launches = 0
    for r0, r1 in _rows(h):
        rows = r1 - r0
        partial = torch.empty((ks, rows, n_total), dtype=torch.float32,
                              device=h.device)
        err = lib.rt_fused_qkv(
            x[r0:r1].data_ptr(), rows, D, 3,
            _ptr_array([w.ptrs[0] for w in ws]),
            _ptr_array([w.ptrs[1] for w in ws]),
            _int_array([w.n for w in ws]), _int_array([w.bits for w in ws]),
            _int_array([w.group for w in ws]),
            _ptr_array([0 if b is None else b.data_ptr() for b in bias_t]),
            _ptr_array([o[r0:r1].data_ptr() for o in outs]),
            partial.data_ptr(), kc, DTYPES[dtype], _stream())
        _check(err, "fused_qkv")
        launches += 1
    return tuple(outs), launches


def launch_fused_mlp(h, w_up, w_down, w_gate, act: str, gated: bool):
    """h (bc,1,D) -> (bc,1,D) on the card; ``act`` is the activation
    applied to the gate (gated) or to up.  Returns (out, launches)."""
    dtype = _activation_dtype(h, "fused_mlp")
    if act not in ACTS:
        raise ValueError(f"fused_mlp: unsupported activation {act!r}")
    _require_cuda(h)
    bc, _, D = h.shape
    up = _Weight(w_up, D, dtype, "w_up")
    F = up.n
    gate = _Weight(w_gate, D, dtype, "w_gate") if gated else None
    if gate is not None and gate.n != F:
        raise ValueError("fused_mlp: w_gate and w_up differ in width")
    down = _Weight(w_down, F, dtype, "w_down")
    if down.n != D:
        raise ValueError(f"fused_mlp: w_down gives {down.n} outputs, "
                         f"expected {D}")
    ws = [up, gate if gate is not None else up, down]
    x = h.reshape(bc, D).contiguous()
    out = torch.empty((bc, 1, D), dtype=dtype, device=h.device)
    n1 = F * (2 if gated else 1)
    tiles1 = (2 if gated else 1) * _tiles(up, h.element_size())
    tiles2 = _tiles(down, h.element_size())
    kc1, kc2 = k_chunk_for(D, tiles1), k_chunk_for(F, tiles2)
    lib = library()
    launches = 0
    for r0, r1 in _rows(h):
        rows = r1 - r0
        mid = torch.empty((rows, F), dtype=dtype, device=h.device)
        p1 = torch.empty((-(-D // kc1), rows, n1), dtype=torch.float32,
                         device=h.device)
        p2 = torch.empty((-(-F // kc2), rows, D), dtype=torch.float32,
                         device=h.device)
        err = lib.rt_fused_mlp(
            x[r0:r1].data_ptr(), rows, D, F, int(gated),
            ACTS[act], _ptr_array([w.ptrs[0] for w in ws]),
            _ptr_array([w.ptrs[1] for w in ws]),
            _int_array([w.bits for w in ws]),
            _int_array([w.group for w in ws]), mid.data_ptr(),
            out[r0:r1].data_ptr(), p1.data_ptr(), kc1, p2.data_ptr(), kc2,
            DTYPES[dtype], _stream())
        _check(err, "fused_mlp")
        launches += 1
    return out, launches


def launch_kv_row_scatter(blk, off, k_rows, v_rows, k_pool, v_pool):
    """In place: pool[g, blk[b], off[b]] = rows[g, b] on the card; rows
    with a sentinel block id (n_blocks) write nothing."""
    _require_cuda(blk, off, k_rows, v_rows, k_pool, v_pool)
    L, n_blocks, bs = k_pool.shape[:3]
    bc = k_rows.shape[1]
    for t in (k_pool, v_pool):
        if not t.is_contiguous():
            raise ValueError("kv_scatter: pools must be contiguous")
    if v_pool.shape != k_pool.shape:
        raise ValueError("kv_scatter: k/v pools differ in shape")
    if k_rows.dtype != k_pool.dtype or v_rows.dtype != v_pool.dtype:
        raise ValueError("kv_scatter: rows and pools differ in dtype")
    row_shape = tuple(k_pool.shape[3:])
    for r in (k_rows, v_rows):
        if tuple(r.shape) != (L, bc) + row_shape:
            raise ValueError(f"kv_scatter: rows {tuple(r.shape)} do not "
                             f"match pool {tuple(k_pool.shape)}")
    row_bytes = k_pool[0, 0, 0].numel() * k_pool.element_size()
    if row_bytes % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("kv_scatter: rows must be 16-byte multiples and "
                         "pools 16-byte aligned")
    blk = blk.to(torch.int32).contiguous()
    off = off.to(torch.int32).contiguous()
    k_rows, v_rows = k_rows.contiguous(), v_rows.contiguous()
    err = library().rt_kv_row_scatter(
        blk.data_ptr(), off.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), L, bc, n_blocks, bs,
        row_bytes, _stream())
    _check(err, "kv_row_scatter")
    return k_pool, v_pool
