"""Public wrapper of the SSD chunked-scan kernels (model layout).

``ssd`` dispatches on the device of its tensors alone: CPU tensors run
the plain versions (``ref.py``); CUDA tensors launch the Hopper kernels
(``kernel.py``) or raise — there is no fallback.  Where grad is enabled
and an input requires it, the call goes through ``SSD``, an autograd
Function: on the card its forward kernel also hands over the state before
each chunk (the same launch, the same bits of y and h_final), which it
saves, and its backward runs the backward kernel on them; on the CPU its
forward is ``ref_ssd_chunked`` and its backward ``ref_ssd_backward``.
Otherwise (serving) the forward runs alone.

Each forward launch adds one to the count ``ssd`` in the kernels'
launch-count registry (``repro_torch.kernels``) and one to ``ssd/mma``
(bf16 inputs) or ``ssd/simt`` (fp32; ``kernel.route``); one launch runs
four device kernels (C.B^T per group, chunk states, the scan over chunks,
the outputs).  Each backward launch adds one to ``ssd/bwd`` and one to
``ssd/bwd_bf16`` or ``ssd/bwd_f32`` (``kernel.bwd_route``); it runs seven
device kernels (``csrc/ssd.cu``).  The gradient of h_final may be None
(training discards h_final): the backward then starts from a zero state
gradient.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import count_launch, register_kernels
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd.ref import ref_ssd_backward, ref_ssd_chunked


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    return True


def _count_forward(dtype):
    count_launch("ssd")
    count_launch(f"ssd/{K.route(dtype)}")


class SSD(torch.autograd.Function):
    """The forward and backward kernels as one differentiable function of
    x, dt, A, Bm and Cm (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.set_materialize_grads(False)
        if _on_card(x):
            y, h, states = K.launch_ssd(x, dt, A, Bm, Cm, chunk=chunk,
                                        want_states=True)
            _count_forward(x.dtype)
        else:
            (y, h), states = ref_ssd_chunked(x, dt, A, Bm, Cm,
                                             chunk=chunk), None
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if _on_card(x):
            grads = K.launch_ssd_backward(x, dt, A, Bm, Cm, states, dy, dh,
                                          chunk=ctx.chunk)
            count_launch("ssd/bwd")
            count_launch(f"ssd/{K.bwd_route(x.dtype)}")
        else:
            grads = ref_ssd_backward(x, dt, A, Bm, Cm, dy, dh,
                                     chunk=ctx.chunk)
        return (*grads, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x (B,S,H,P), dt (B,S,H) post-softplus, A (H,)
    negative, Bm/Cm (B,S,G,N).  From a zero state; returns (y (B,S,H,P)
    in x's dtype, h_final (B,H,P,N) fp32)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return SSD.apply(x, dt, A, Bm, Cm, chunk)
    if not _on_card(x):
        return ref_ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    out = K.launch_ssd(x, dt, A, Bm, Cm, chunk=chunk)
    _count_forward(x.dtype)
    return out


register_kernels("ssd", "ssd/mma", "ssd/simt", "ssd/bwd", "ssd/bwd_bf16",
                 "ssd/bwd_f32")
