"""Public wrappers of the packed-weight GEMM.

Both dispatch on the device of their activations alone: CPU tensors run
the plain versions (``ref.py``); CUDA tensors launch the Hopper kernel
(``kernel.py``) or raise — there is no fallback.  Each launch adds one
to the count ``dequant_gemm`` in the kernels' launch-count registry
(``repro_torch.kernels``) and one to its kernel's,
``dequant_gemm/wgmma`` (bf16, warp-specialised), ``dequant_gemm/tile``
(bf16 calls outside the wgmma kernel's rule) or ``dequant_gemm/tf32x3``
(every fp32 call: split TF32 on the tensor cores; a split of K adds a
second device kernel that sums the splits in order); ``kernel.route``
decides from the call's shape before the launch.

- ``dequant_gemm(x, qt, bias, act)``: the reference's function, x (...,
  K) @ dequantize(qt (N, K))ᵀ with the bias + activation epilogue ("nk",
  packed along K).
- ``quant_einsum(spec, x, w)``: the model's projections.  A dense ``w``
  goes to ``torch.einsum``; a packed one, in one of the model's
  contractions (``ref.MODEL_SPECS``), goes to the kernel in the model's
  layout ("kn", packed along the output axis), and the plain version is
  ``dequantize`` + ``torch.einsum``, the model's arithmetic before the
  kernel, bit for bit.  The MoE's expert contractions
  (``ref.EXPERT_SPECS``: x (G, E, C, K) against a stacked expert weight
  (E, K, N)) go to the kernel as one launch over all E experts, x laid
  out expert-major (E, G * C, K); each such launch also counts under
  ``dequant_gemm/experts``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels import count_launch, refuse_grad, register_kernels
from repro_torch.kernels.dequant_gemm import kernel as K
from repro_torch.kernels.dequant_gemm.ref import (EXPERT_SPECS,
                                                  MODEL_SPECS,
                                                  ref_dequant_gemm,
                                                  ref_quant_einsum)


def _on_card(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def dequant_gemm(x: torch.Tensor, qt: QTensor,
                 bias: Optional[torch.Tensor] = None,
                 act: Optional[str] = None) -> torch.Tensor:
    """x (..., K) @ dequantize(qt (N, K))ᵀ -> (..., N) in ``x.dtype``, fp32
    accumulation, then ``bias`` and ``act`` (None, relu, silu, gelu,
    squared_relu) in fp32."""
    if not _on_card(x, "dequant_gemm"):
        return ref_dequant_gemm(x, qt, bias, act)
    refuse_grad("dequant_gemm", x, qt, bias)
    lead = x.shape[:-1]
    b = None if bias is None else bias.to(torch.float32)   # exact widening
    y, kernel = K.launch_dequant_gemm(x.reshape(-1, x.shape[-1]), qt, b, act)
    count_launch("dequant_gemm")
    count_launch(f"dequant_gemm/{kernel}")
    return y.reshape(*lead, qt.shape[0])


def quant_einsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """``torch.einsum(spec, x, w)`` for a dense ``w``; for a packed one,
    x (..., contracted) against the weight (contracted, [N1,] N2) through
    the kernel on the card or ``dequantize`` + einsum on the CPU."""
    if not isinstance(w, QTensor):
        return torch.einsum(spec, x, w)
    if spec not in MODEL_SPECS and spec not in EXPERT_SPECS:
        raise ValueError(f"quant_einsum: no packed-weight path for {spec!r} "
                         f"(model contractions: {tuple(MODEL_SPECS)}, "
                         f"expert contractions: {EXPERT_SPECS})")
    if not _on_card(x, "quant_einsum"):
        return ref_quant_einsum(spec, x, w)
    refuse_grad("dequant_gemm", x, w)
    if spec in EXPERT_SPECS:
        G, E, C, Kd = x.shape
        # expert-major rows: each expert's G groups of C rows contiguous
        xe = x.transpose(0, 1).reshape(E, G * C, Kd).contiguous()
        y, kernel = K.launch_expert_matmul(xe, w)
        count_launch("dequant_gemm")
        count_launch(f"dequant_gemm/{kernel}")
        count_launch("dequant_gemm/experts")
        return y.reshape(E, G, C, y.shape[-1]).transpose(0, 1)
    n_k = MODEL_SPECS[spec]
    lead = x.shape[:-n_k]
    # one row per output position; reshapes of a strided operand copy here
    x2 = x.contiguous().reshape(-1, x.shape[-n_k:].numel())
    y, kernel = K.launch_packed_matmul(x2, w, n_k)
    count_launch("dequant_gemm")
    count_launch(f"dequant_gemm/{kernel}")
    return y.reshape(*lead, *w.shape[n_k:])


register_kernels("dequant_gemm", "dequant_gemm/wgmma", "dequant_gemm/tile",
                 "dequant_gemm/tf32x3", "dequant_gemm/experts")
