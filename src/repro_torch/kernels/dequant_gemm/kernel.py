"""Launcher of the Hopper packed-weight GEMMs (``csrc/dequant_gemm.cu``).

Checks device, dtypes, shapes, contiguity and alignment, allocates the
output, picks the kernel by shape before the launch (:func:`route`: the
warp-specialised wgmma kernel for every bf16 call its rule admits, the
bf16 tile kernel for the rest, the split-TF32 tile kernel for every fp32
call, in the split of K that :func:`tf32x3_plan` picks),
launches on the current stream through that kernel's C entry point and
raises if the entry returns a CUDA error.  :func:`launch_expert_matmul`
runs the MoE's expert contractions: E products of the "kn" layout in one
launch of the same kernels, the expert from the grid.  It never copies an operand:
a strided one raises, and the caller makes it contiguous.  The library
is built on first use (``kernels/build.py``).  Runs on the card only;
the CPU path is the plain version in ``ref.py``, chosen by the wrapper
in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels.build import load_library

LIBRARY = "dequant_gemm"
SOURCES = ("dequant_gemm.cu",)
TILE_N = 128                   # output columns per block of the bf16 tile kernel
SMS = 132                      # streaming multiprocessors of an H100
TF32_BM, TF32_BN = 128, 64     # output tile of the split-TF32 kernel
TF32_BK = 32                   # K a step of the split-TF32 kernel
NK, KN = 0, 1                  # layouts of the packed operand
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
ACT_IDS = {None: 0, "relu": 1, "silu": 2, "gelu": 3, "squared_relu": 4}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    if not getattr(lib, "_typed", False):
        lib.rt_dequant_gemm.argtypes = [_P] * 5 + [_I] * 15 + [_P]
        lib.rt_dequant_gemm.restype = _I
        lib.rt_dequant_gemm_tf32.argtypes = [_P] * 6 + [_I] * 16 + [_P]
        lib.rt_dequant_gemm_tf32.restype = _I
        lib.rt_dequant_gemm_wgmma.argtypes = [_P] * 5 + [_I] * 10 + [_P]
        lib.rt_dequant_gemm_wgmma.restype = _I
        lib._typed = True
    return lib


def route(dtype: torch.dtype, K: int, N: int, group: int, layout: int,
          n2: int, n2p: int, ldw: int, aligned: bool) -> str:
    """The kernel a call takes, decided from its shape before launch:
    "tf32x3" (the split-TF32 tile kernel) for every fp32 call; for bf16,
    "wgmma" (the warp-specialised kernel) with K % 8 == 0 (TMA's row
    stride), a group of 16, 32, 64 or a multiple of 128, x and the codes
    16-byte aligned (``aligned``) with 16-byte code rows (``ldw`` % 4 ==
    0), and in the "kn" layout unpadded segments (n2p == n2) with N % 64 ==
    0; "tile" (the bf16 tile kernel) otherwise.  The same rule as
    ``rt_dequant_gemm_wgmma`` in the source."""
    if dtype == torch.float32:
        return "tf32x3"
    if (aligned and K % 8 == 0
            and group >= 16 and (128 % group == 0 or group % 128 == 0)
            and ldw % 4 == 0
            and (layout == NK or (n2 == n2p and N % 64 == 0))):
        return "wgmma"
    return "tile"


def tf32x3_plan(M: int, N: int, K: int, experts: int = 1) -> int:
    """The splits of K of an fp32 call, from its shape alone: as many as
    eight parts while the 128 x 64 blocks (of all ``experts`` products)
    stay within two an SM (each a whole wave of the card, two resident on
    each SM), each part at least two K steps.
    ``scripts/tf32x3_plan_sweep.py`` times every split: on an H100 this
    rule is within 7 % of the fastest at each served fp32 shape
    (PERF.md)."""
    tiles = -(-M // TF32_BM) * -(-N // TF32_BN) * experts
    steps = -(-K // TF32_BK)
    return max(1, min(8, 2 * SMS // tiles, steps // 2))


@functools.lru_cache(maxsize=None)
def kn_spans(N: int, n2: int, n2p: int, pw: int, group: int,
             tile_n: int = TILE_N) -> Tuple[int, int]:
    """The most packed words and scale columns of one row that any
    ``tile_n``-column tile of the "kn" layout reads (output n reads word
    (n // n2) * (n2p // pw) + (n % n2) // pw, scale (n // n2) * (n2p //
    group) + (n % n2) // group): the kernel stages that many a row."""
    def word(n):
        return (n // n2) * (n2p // pw) + (n % n2) // pw

    def scale(n):
        return (n // n2) * (n2p // group) + (n % n2) // group
    span_w = span_s = 1
    for n0 in range(0, N, tile_n):
        last = min(n0 + tile_n, N) - 1
        span_w = max(span_w, word(last) - word(n0) + 1)
        span_s = max(span_s, scale(last) - scale(n0) + 1)
    return span_w, span_s


def _check_operands(x: torch.Tensor, qt: QTensor,
                    bias: Optional[torch.Tensor], act: Optional[str]):
    if not (x.is_cuda and qt.codes.is_cuda and qt.scales.is_cuda):
        raise ValueError("dequant_gemm: the kernel takes CUDA tensors")
    if x.dtype not in DTYPES:
        raise ValueError(f"dequant_gemm: the kernel takes bfloat16 or "
                         f"float32 activations, got {x.dtype}")
    if qt.dtype != x.dtype:
        raise ValueError(f"dequant_gemm: weight dtype {qt.dtype} differs "
                         f"from the activations' {x.dtype}")
    if qt.codes.dtype != torch.int32 or qt.scales.dtype != torch.float32:
        raise ValueError("dequant_gemm: codes must be int32, scales fp32")
    pw, g = qt.spec.per_word, qt.spec.group_size
    if g % pw:
        raise ValueError(f"dequant_gemm: group {g} is no multiple of the "
                         f"{pw} codes of a word")
    for name, t in (("x", x), ("codes", qt.codes), ("scales", qt.scales)):
        if not t.is_contiguous():
            raise ValueError(f"dequant_gemm: {name} is not contiguous")
    if act not in ACT_IDS:
        raise ValueError(f"dequant_gemm: activation {act!r} not in "
                         f"{tuple(ACT_IDS)}")
    if bias is not None and not (bias.is_cuda and bias.dtype == torch.float32
                                 and bias.is_contiguous()):
        raise ValueError("dequant_gemm: bias must be a contiguous fp32 "
                         "CUDA tensor")


def _launch(x2, qt, bias, act, N, layout, ldw, lds, n2, n2p
            ) -> Tuple[torch.Tensor, str]:
    """x2 (M, K), or (E, M, K) with a packed operand of E blocks -> y
    (M, N) or (E, M, N)."""
    E = x2.shape[0] if x2.dim() == 3 else 1
    M, K = x2.shape[-2:]
    if M < 1 or N < 1 or K < 1 or E < 1:
        raise ValueError(f"dequant_gemm: empty product ({M}, {K}) x "
                         f"({K}, {N}) over {E} experts")
    y = torch.empty(x2.shape[:-1] + (N,), dtype=x2.dtype, device=x2.device)
    aligned = x2.data_ptr() % 16 == 0 and qt.codes.data_ptr() % 16 == 0
    kernel = route(x2.dtype, K, N, qt.spec.group_size, layout, n2, n2p, ldw,
                   aligned)
    stream = torch.cuda.current_stream().cuda_stream
    bias_ptr = None if bias is None else bias.data_ptr()
    bits, group = qt.spec.bits, qt.spec.group_size
    if kernel == "wgmma":
        err = library().rt_dequant_gemm_wgmma(
            x2.data_ptr(), qt.codes.data_ptr(), qt.scales.data_ptr(),
            bias_ptr, y.data_ptr(), M, N, K, bits, group, layout, ldw, lds,
            ACT_IDS[act], E, stream)
        if err != 0:
            raise RuntimeError(f"dequant_gemm: CUDA error {err}")
        return y, kernel
    x_vec = int(x2.data_ptr() % 16 == 0 and (K * x2.element_size()) % 16
                == 0)
    if kernel == "tf32x3":
        splits = tf32x3_plan(M, N, K, E)
        span_w, span_s = (kn_spans(N, n2, n2p, qt.spec.per_word, group,
                                   TF32_BN)
                          if layout == KN else (1, 1))
        partial = (torch.empty((E, splits, M, N), dtype=torch.float32,
                               device=x2.device) if splits > 1 else None)
        err = library().rt_dequant_gemm_tf32(
            x2.data_ptr(), qt.codes.data_ptr(), qt.scales.data_ptr(),
            bias_ptr, y.data_ptr(),
            None if partial is None else partial.data_ptr(), M, N, K, bits,
            group, layout, ldw, lds, n2, n2p, span_w, span_s, ACT_IDS[act],
            x_vec, splits, E, stream)
    else:
        span_w, span_s = (kn_spans(N, n2, n2p, qt.spec.per_word, group)
                          if layout == KN else (1, 1))
        err = library().rt_dequant_gemm(
            x2.data_ptr(), qt.codes.data_ptr(), qt.scales.data_ptr(),
            bias_ptr, y.data_ptr(), M, N, K, bits, group, layout, ldw, lds,
            n2, n2p, span_w, span_s, ACT_IDS[act], x_vec, E, stream)
    if err != 0:
        raise RuntimeError(f"dequant_gemm: CUDA error {err}")
    return y, kernel


def launch_dequant_gemm(x2: torch.Tensor, qt: QTensor,
                        bias: Optional[torch.Tensor] = None,
                        act: Optional[str] = None
                        ) -> Tuple[torch.Tensor, str]:
    """The "nk" layout: x2 (M, K) @ dequantize(qt (N, K))ᵀ, then bias
    (N,) fp32 and ``act`` -> ((M, N) in x2's dtype, the kernel's route)."""
    _check_operands(x2, qt, bias, act)
    if x2.dim() != 2 or len(qt.shape) != 2 or qt.codes.dim() != 2:
        raise ValueError("dequant_gemm: expected x (M, K) and a 2-D packed "
                         "weight (N, K)")
    N, K = qt.shape
    if x2.shape[1] != K or qt.codes.shape[0] != N:
        raise ValueError(f"dequant_gemm: x {tuple(x2.shape)} against "
                         f"weight {tuple(qt.shape)}")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"dequant_gemm: bias {tuple(bias.shape)} for N "
                         f"{N}")
    return _launch(x2, qt, bias, act, N, NK, qt.codes.shape[1],
                   qt.scales.shape[1], 1, 1)


def launch_packed_matmul(x2: torch.Tensor, qt: QTensor, n_k: int
                         ) -> Tuple[torch.Tensor, str]:
    """The "kn" layout: x2 (M, K) @ dequantize(qt) with qt's first
    ``n_k`` logical axes the K axes and the rest (N2,) or (N1, N2), each
    N2 segment packed at its padded length -> ((M, N1 * N2) in x2's
    dtype, the kernel's route)."""
    _check_operands(x2, qt, None, None)
    shape = tuple(qt.shape)
    if x2.dim() != 2 or len(shape) - n_k not in (1, 2):
        raise ValueError(f"dequant_gemm: weight {shape} with {n_k} "
                         f"contracted axes is not (K.., [N1,] N2)")
    K = 1
    for d in shape[:n_k]:
        K *= d
    N1 = shape[n_k] if len(shape) - n_k == 2 else 1
    n2 = shape[-1]
    pw, g = qt.spec.per_word, qt.spec.group_size
    n2p = qt.codes.shape[-1] * pw
    if (x2.shape[1] != K or qt.codes.numel() != K * N1 * n2p // pw
            or qt.scales.numel() != K * N1 * n2p // g):
        raise ValueError(f"dequant_gemm: x {tuple(x2.shape)} against "
                         f"weight {shape}")
    return _launch(x2, qt, None, None, N1 * n2, KN, N1 * n2p // pw,
                   N1 * n2p // g, n2, n2p)


def launch_expert_matmul(x3: torch.Tensor, qt: QTensor
                         ) -> Tuple[torch.Tensor, str]:
    """The MoE's expert contractions: x3 (E, M, K) against a stacked
    packed weight qt (E, K, N), each expert's (K, N) packed along N (the
    "kn" layout) -> ((E, M, N) in x3's dtype, the kernel's route), all E
    products in one launch."""
    _check_operands(x3, qt, None, None)
    shape = tuple(qt.shape)
    if x3.dim() != 3 or len(shape) != 3 or qt.codes.dim() != 3:
        raise ValueError(f"dequant_gemm: expected x (E, M, K) against an "
                         f"expert weight (E, K, N), got {tuple(x3.shape)} "
                         f"and {shape}")
    E, K, N = shape
    pw, g = qt.spec.per_word, qt.spec.group_size
    n2p = qt.codes.shape[-1] * pw
    if (x3.shape[0] != E or x3.shape[2] != K
            or tuple(qt.codes.shape[:2]) != (E, K)
            or qt.scales.numel() != E * K * n2p // g):
        raise ValueError(f"dequant_gemm: x {tuple(x3.shape)} against "
                         f"expert weight {shape}")
    return _launch(x3, qt, None, None, N, KN, n2p // pw, n2p // g, N, n2p)
