"""Public wrapper of the flash-attention kernel (model GQA layout).

``flash_attention`` dispatches on the device of its tensors alone: CPU
tensors run the plain version (``ref.ref_attention``, which autograd
differentiates); CUDA tensors launch the Hopper kernels (``kernel.py``)
or raise — there is no fallback.  Where grad is enabled and q, k or v
requires it, the call goes through ``FlashAttention``, an autograd
Function: its forward kernel also writes the rows' log-sum-exp (the
output is the same bits either way) and saves q, k, v, o and lse; its
backward runs the backward kernel on them.  Otherwise (serving) the
forward kernel runs alone, without the lse.  Each forward launch
adds one to the count ``flash_attention`` in the kernels' launch-count
registry (``repro_torch.kernels``) and one to its kernel's,
``flash_attention/wgmma`` (bf16) or ``flash_attention/tf32x3`` (fp32:
split TF32 on the tensor cores); each backward launch one to
``flash_attention/bwd`` and one to ``flash_attention/bwd_bf16`` or
``flash_attention/bwd_f32``.  The backward runs its products on the
tensor cores too (bf16 mma.sync with dS in two bf16 terms, fp32 split
TF32), over a dK/dV grid of one block per (batch, query head, key block)
whose fp32 partials a last kernel sums per kv head in a fixed order:
no atomics, so two launches give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch, register_kernels
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import ref_attention


def _count_forward(dtype):
    count_launch("flash_attention")
    count_launch(f"flash_attention/{K.ROUTES[dtype]}")


class FlashAttention(torch.autograd.Function):
    """The kernel pair as one differentiable function of q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = K.launch_flash_attention(q, k, v, causal=causal,
                                          want_lse=True)
        _count_forward(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = K.launch_flash_attention_backward(
            q, k, v, o, lse, do.to(o.dtype), causal=ctx.causal)
        count_launch("flash_attention/bwd")
        count_launch(f"flash_attention/{K.BWD_ROUTES[q.dtype]}")
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,Sq,H,hd); k, v (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    o = K.launch_flash_attention(q, k, v, causal=causal)
    _count_forward(q.dtype)
    return o


register_kernels("flash_attention", "flash_attention/bwd",
                 *(f"flash_attention/{r}" for r in K.ROUTES.values()),
                 *(f"flash_attention/{r}" for r in K.BWD_ROUTES.values()))
