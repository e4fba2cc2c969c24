"""Plain PyTorch versions of the packed-weight (W2/W4/W8, A16) GEMM.

Two layouts of the packed operand (``core/quantize.py`` packs along a
tensor's last axis):

- "nk", the reference kernel's own: ``qt`` (N, K) packed along K, y =
  x Wᵀ.  :func:`ref_dequant_gemm` is the reference's
  ``kernels/dequant_gemm/ref.py::ref_dequant_gemm``: products in fp32,
  then the bias and the activation in fp32, one rounding to ``x.dtype``.
- "kn", the model's: every served projection weight is stored input
  first and packed along its output axis (``wq`` (d, H, hd), ``wo`` (H,
  hd, d), ``w_up`` (d, d_ff), ``in_proj`` (d, 2 d_inner + 2GN + H), ...).
  :func:`ref_quant_einsum` is exactly the model's arithmetic before the
  kernel existed: ``dequantize(w)``, then ``torch.einsum`` in
  ``x.dtype``.

The wrappers in ``ops.py`` run these for CPU tensors; the tests hold them
against the reference package, and the card's checks hold the kernel
against them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.models.common import activation

ACTS = (None, "relu", "silu", "gelu", "squared_relu")

# the model's contractions against a packed weight: spec -> how many
# trailing axes of x (and leading axes of the weight) are contracted
MODEL_SPECS = {"bsd,dhk->bshk": 1, "bshk,hkd->bsd": 2, "bsd,df->bsf": 1,
               "bsf,fd->bsd": 1, "bsd,de->bse": 1, "bse,ed->bsd": 1}


def epilogue(acc: torch.Tensor, bias: Optional[torch.Tensor],
             act: Optional[str], dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``acc`` + bias (in fp32), the activation in fp32 (``gelu`` is
    the tanh form, as ``jax.nn.gelu``), one rounding to ``dtype``."""
    if act not in ACTS:
        raise ValueError(f"dequant_gemm: activation {act!r} not in {ACTS}")
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    if act is not None:
        acc = activation(act)(acc)
    return acc.to(dtype)


def ref_dequant_gemm(x: torch.Tensor, qt: QTensor,
                     bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> torch.Tensor:
    """x (..., K) @ dequantize(qt (N, K))ᵀ -> (..., N) in ``x.dtype``:
    fp32 accumulation, optional bias + activation (the kernel's
    epilogue)."""
    w = dequantize(qt)                                  # (N, K) qt.dtype
    acc = torch.einsum("...k,nk->...n", x.to(torch.float32),
                       w.to(torch.float32))
    return epilogue(acc, bias, act, x.dtype)


def ref_quant_einsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """``torch.einsum(spec, x, w)`` with a packed ``w`` dequantized first
    (its own dtype): the model's composed arithmetic, bit for bit."""
    if isinstance(w, QTensor):
        w = dequantize(w)
    return torch.einsum(spec, x, w)
