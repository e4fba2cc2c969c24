"""Launcher of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

Checks device, dtype, shapes and strides, allocates the output (and, on
request, the rows' log-sum-exp), launches on the current stream through
the C entry point and raises if the entry returns a CUDA error; the
backward (``launch_flash_attention_backward``) likewise, with its fp32
scratch of per-query-head dK and dV.  ``bwd_grid`` and ``bwd_geometry``
mirror the backward kernels' blocks (for the tests and the card's
geometry line), ``bwd_occupancy`` reads their residency on the card.  The library is built on first use
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
# the backward's entry points and routes, both on the tensor cores: bf16
# mma.sync m16n8k16 (dS in two bf16 terms), fp32 split TF32 on mma.sync
# m16n8k8; dK/dV a block per (batch, query head, key block), summed over
# each kv head's query heads in a fixed order
BWD_ENTRIES = {torch.bfloat16: "rt_flash_attention_bwd",
               torch.float32: "rt_flash_attention_bwd_f32"}
BWD_ROUTES = {torch.bfloat16: "bwd_bf16", torch.float32: "bwd_f32"}
BWD_TILE = 64           # rows (queries or keys) of a backward tile (kBT)

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
                ctypes.c_float, _P, _P]
            fn.restype = _I
        for name in BWD_ENTRIES.values():
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 11 + [_I] * 7 + [ctypes.c_float, _P]
            fn.restype = _I
        lib.rt_flash_attention_bwd_occupancy.argtypes = [_I, _I, _P]
        lib.rt_flash_attention_bwd_occupancy.restype = _I
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


def _check(q, k, v):
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
    return B, Sq, Sk, H, KV, hd


def launch_flash_attention(q, k, v, *, causal: bool, want_lse: bool = False):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) bf16 or fp32 CUDA tensors (one
    dtype) in the model's layout -> o (B,Sq,H,hd); with ``want_lse``
    (o, lse): lse (B,H,Sq) fp32, each row's log-sum-exp of its scaled,
    masked scores (o is the same bits either way)."""
    B, Sq, Sk, H, KV, hd = _check(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    err = getattr(library(), ENTRIES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, Sk, H, KV, hd, int(causal), *strides,
        float(hd ** -0.5), None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err}")
    return (o, lse) if want_lse else o


def launch_flash_attention_backward(q, k, v, o, lse, do, *, causal: bool):
    """The gradient of ``launch_flash_attention``: q, o, do (B,Sq,H,hd),
    k, v (B,Sk,KV,hd) of one dtype, lse (B,H,Sq) fp32 as the forward
    returned it -> (dq, dk, dv) in the inputs' dtype and shapes.  Every
    operand is read contiguous and 16-byte aligned (copied first if not).
    With H > KV each query head's dK and dV go to an fp32 scratch (2, B,
    Sk, H, hd) that the last kernel sums over each kv head's heads."""
    B, Sq, Sk, H, KV, hd = _check(q, k, v)
    for name, t, shape in (("o", o, q.shape), ("do", do, q.shape)):
        if (not t.is_cuda or t.dtype != q.dtype
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"CUDA {q.dtype} tensor of shape "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if (not lse.is_cuda or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"flash_attention backward: lse must be a CUDA "
                         f"float32 tensor of shape {(B, H, Sq)}")
    q, k, v, o, do, lse = (_dense(t) for t in (q, k, v, o, do, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # D: fp32 for the bf16 route, double for the fp32 route (whose dP - D
    # is taken in double)
    dsum = torch.empty((B, H, Sq), dtype=(
        torch.float64 if q.dtype == torch.float32 else torch.float32),
        device=q.device)
    part = (torch.empty((2, B, Sk, H, hd), dtype=torch.float32,
                        device=q.device) if H > KV else None)
    err = getattr(library(), BWD_ENTRIES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dsum.data_ptr(),
        None if part is None else part.data_ptr(), B, Sq, Sk, H, KV, hd,
        int(causal), float(hd ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward: CUDA error {err}")
    return dq, dk, dv


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the backward's
    cp.async copies), copied if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bwd_occupancy(dtype, hd: int) -> dict:
    """The backward kernels' residency on this card at ``hd`` (CUDA
    occupancy API): blocks an SM of the dK/dV and dQ kernels, registers
    and local (spilled) bytes a thread, dynamic shared memory a block."""
    out = (ctypes.c_int * 7)()
    err = library().rt_flash_attention_bwd_occupancy(
        int(dtype == torch.float32), hd, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"flash_attention backward occupancy: CUDA "
                           f"error {err}")
    return {"dkdv_blocks_an_sm": out[0], "dq_blocks_an_sm": out[1],
            "dkdv_regs": out[2], "dkdv_local_bytes": out[3],
            "dq_regs": out[4], "dq_local_bytes": out[5],
            "smem_bytes": out[6]}


def bwd_grid(B: int, Sq: int, Sk: int, H: int, causal: bool):
    """The backward kernels' blocks in issue order (blockIdx.x, the
    (batch, head), fastest), each the list of (b * H + h, key block, row
    block) tile pairs it walks, as the kernels map blockIdx: dK/dV a
    block per (batch, query head, key block), key blocks ascending, each
    walking the row blocks from the one holding its first key (causal) to
    the last; dQ a block per (batch, head, row block), row blocks
    descending, each walking the key blocks up to its diagonal (causal).
    Returns (dkdv, dq)."""
    T = BWD_TILE
    nq, nk = -(-Sq // T), -(-Sk // T)
    dkdv = [[(bh, kb, rb) for rb in range(kb if causal else 0, nq)]
            for kb in range(nk) for bh in range(B * H)]
    dq = []
    for y in range(nq):
        rb = nq - 1 - y
        last = min(nk, (min(rb * T + T, Sq) - 1) // T + 1) if causal else nk
        dq += [[(bh, kb, rb) for kb in range(last)] for bh in range(B * H)]
    return dkdv, dq


def bwd_geometry(B: int, Sq: int, Sk: int, H: int, causal: bool,
                 resident=None, sms: int = 132) -> dict:
    """Each backward grid's blocks, tile pairs, longest block and mean
    (``bwd_grid``); with ``resident`` ({"dkdv": blocks an SM, "dq": ...})
    also the tile pairs a resident block slot gets on average (pairs /
    (sms x resident)) and whether the longest block walks at most half of
    that (``balanced``)."""
    out = {}
    for name, blocks in zip(("dkdv", "dq"), bwd_grid(B, Sq, Sk, H, causal)):
        n = [len(b) for b in blocks]
        rec = {"blocks": len(n), "tile_pairs": sum(n), "longest": max(n),
               "mean": sum(n) / len(n)}
        if resident is not None:
            slot = rec["tile_pairs"] / (sms * resident[name])
            rec.update(resident_blocks_an_sm=resident[name],
                       pairs_a_slot=slot,
                       balanced=rec["longest"] <= slot / 2)
        out[name] = rec
    return out
