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
against them.  :func:`emulate_dequant_gemm_tf32x3` repeats the arithmetic
of the kernel's fp32 route (split TF32 products, K steps of 32 summed
apart, splits of K added in order), for the tests to hold it against the
reference.
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
# the MoE's expert contractions: x (G, E, C, K) against a stacked expert
# weight (E, K, N) -> (G, E, C, N), the expert axis batched
EXPERT_SPECS = ("gecd,edf->gecf", "gecf,efd->gecd")


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
    (its own dtype): the model's composed arithmetic, bit for bit.  A
    stacked expert leaf (``EXPERT_SPECS``) is dequantized one expert at a
    time into one dense buffer, the same values without the whole leaf's
    int32 and fp32 temporaries (13 GB a pass at 16 x 8192 x 24576)."""
    if isinstance(w, QTensor):
        if spec in EXPERT_SPECS:
            dense = torch.empty(w.shape, dtype=w.dtype, device=w.device)
            for e in range(w.shape[0]):
                dense[e] = dequantize(w.layer(e))
            w = dense
        else:
            w = dequantize(w)
    return torch.einsum(spec, x, w)


def emulate_dequant_gemm_tf32x3(x: torch.Tensor, qt: QTensor,
                                bias: Optional[torch.Tensor] = None,
                                act: Optional[str] = None, *,
                                n_k: Optional[int] = None,
                                experts: bool = False) -> torch.Tensor:
    """The fp32 kernel's route (``dequant_gemm/tf32x3``) in plain PyTorch:
    x and the weight (``dequantize``'s fp32 values) each split into tf32
    terms hi + lo (``flash_attention.ref.split_tf32``); each K step of
    ``kernel.TF32_BK`` as the three products lo.hi + hi.lo + hi.hi summed
    in a fresh fp32 sum, the steps added to the split's running sum in
    order; the splits of K that ``kernel.tf32x3_plan`` picks from the
    call's M, N, K added in order, split 0 first; then ``epilogue``.
    ``n_k`` None: the "nk" layout, x (..., K) against qt (N, K) -> (...,
    N); else the model's "kn" layout, qt's first ``n_k`` axes contracted
    against x's last ``n_k`` -> (..., *qt.shape[n_k:]).  ``experts``:
    an expert contraction, x (G, E, C, K) against qt (E, K, N) -> (G, E,
    C, N), each expert's G * C rows one product of the launch over all E
    (the split of K planned from all E products' tiles)."""
    from repro_torch.kernels.dequant_gemm.kernel import tf32x3_plan
    w = dequantize(qt).to(torch.float32)
    if experts:
        G, E, C, K = x.shape
        N = qt.shape[-1]
        xe = x.to(torch.float32).transpose(0, 1).reshape(E, G * C, K)
        splits = tf32x3_plan(G * C, N, K, E)
        ys = [_tf32x3_sums(xe[e], w[e], splits) for e in range(E)]
        y = epilogue(torch.stack(ys), bias, act, x.dtype)
        return y.reshape(E, G, C, N).transpose(0, 1)
    if n_k is None:
        K, wk, lead, tail = qt.shape[1], w.t(), x.shape[:-1], (qt.shape[0],)
    else:
        K = w.shape[:n_k].numel()
        wk, lead, tail = w.reshape(K, -1), x.shape[:-n_k], qt.shape[n_k:]
    x2 = x.to(torch.float32).reshape(-1, K)
    total = _tf32x3_sums(x2, wk, tf32x3_plan(x2.shape[0], wk.shape[1], K))
    return epilogue(total, bias, act, x.dtype).reshape(*lead, *tail)


def _tf32x3_sums(x2: torch.Tensor, wk: torch.Tensor,
                 splits: int) -> torch.Tensor:
    """x2 (M, K) fp32 @ wk (K, N) fp32 as the split-TF32 route sums it,
    before the epilogue: each K step of ``kernel.TF32_BK`` as three tf32
    products in a fresh fp32 sum, the steps added in order within each of
    ``splits`` parts, the parts added in order."""
    from repro_torch.kernels.dequant_gemm.kernel import TF32_BK
    from repro_torch.kernels.flash_attention.ref import split_tf32
    M, K = x2.shape
    N = wk.shape[1]
    steps = -(-K // TF32_BK)
    per = -(-steps // splits)
    (xh, xl), (wh, wl) = split_tf32(x2), split_tf32(wk)
    total = None
    for z in range(splits):
        acc = torch.zeros((M, N), dtype=torch.float32, device=x2.device)
        for s in range(z * per, min(steps, (z + 1) * per)):
            k = slice(s * TF32_BK, (s + 1) * TF32_BK)
            acc = acc + (xl[:, k] @ wh[k] + xh[:, k] @ wl[k]
                         + xh[:, k] @ wh[k])
        total = acc if total is None else total + acc
    return total
