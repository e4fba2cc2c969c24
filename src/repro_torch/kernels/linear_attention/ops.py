"""Public wrapper of the linear-attention kernel (model layout).

``linear_attention`` dispatches on the device of its tensors alone: CPU
tensors run the plain chunked form (``ref.ref_linear_attention_chunked``);
CUDA tensors launch the Hopper kernel (``kernel.py``) or raise — there is
no fallback.  Each launch adds one to the count ``linear_attention`` in
the kernels' launch-count registry (``repro_torch.kernels``); one launch
runs three device kernels: the 64-row-tile states per kv head, the scan
over the tiles, and the outputs (one block per kv group, row tile and
pair of 16-row slabs, serving every query head of the group), every
product in split TF32 on the tensor cores (``ref.
emulate_linear_attention_tf32x3`` repeats their arithmetic).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import count_launch, refuse_grad, register_kernels
from repro_torch.kernels.linear_attention import kernel as K
from repro_torch.kernels.linear_attention.ref import \
    ref_linear_attention_chunked


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     chunk: int = 256,
                     valid_len: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Model layout: q (B,S,H,hd), k/v (B,S,KV,hd), not expanded;
    ``valid_len`` (B,) or None.  From a zero state; returns (out
    (B,S,H,hd) in q's dtype, zero at and past each row's valid_len;
    state (B,H,hd,hd) fp32; z (B,H,hd) fp32)."""
    if q.device.type == "cpu":
        return ref_linear_attention_chunked(q, k, v, chunk=chunk,
                                            valid_len=valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"linear_attention: unsupported device {q.device}")
    refuse_grad("linear_attention", q, k, v)
    out = K.launch_linear_attention(q, k, v, chunk=chunk,
                                    valid_len=valid_len)
    count_launch("linear_attention")
    return out


register_kernels("linear_attention")
