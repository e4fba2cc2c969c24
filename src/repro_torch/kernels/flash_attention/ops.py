"""Public wrapper of the flash-attention kernel (model GQA layout).

``flash_attention`` dispatches on the device of its tensors alone: CPU
tensors run the plain version (``ref.ref_attention``); CUDA tensors
launch the Hopper kernel (``kernel.py``) or raise — there is no
fallback.  Each launch adds one to the count ``flash_attention`` in the
kernels' launch-count registry (``repro_torch.kernels``) and one to its
kernel's, ``flash_attention/wgmma`` (bf16) or ``flash_attention/tf32x3``
(fp32: split TF32 on the tensor cores).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch, register_kernels
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import ref_attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,Sq,H,hd); k, v (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    o = K.launch_flash_attention(q, k, v, causal=causal)
    count_launch("flash_attention")
    count_launch(f"flash_attention/{K.ROUTES[q.dtype]}")
    return o


register_kernels("flash_attention",
                 *(f"flash_attention/{r}" for r in K.ROUTES.values()))
