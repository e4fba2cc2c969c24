"""Public wrapper of the SSD chunked-scan kernel (model layout).

``ssd`` dispatches on the device of its tensors alone: CPU tensors run
the plain chunked form (``ref.ref_ssd_chunked``); CUDA tensors launch
the Hopper kernel (``kernel.py``) or raise — there is no fallback.  Each
launch adds one to the count ``ssd`` in the kernels' launch-count
registry (``repro_torch.kernels``) and one to ``ssd/mma`` (bf16 inputs)
or ``ssd/simt`` (fp32; ``kernel.route``); one launch runs four device
kernels (C.B^T per group, chunk states, the scan over chunks, the
outputs).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import count_launch, refuse_grad, register_kernels
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd.ref import ref_ssd_chunked


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x (B,S,H,P), dt (B,S,H) post-softplus, A (H,)
    negative, Bm/Cm (B,S,G,N).  From a zero state; returns (y (B,S,H,P)
    in x's dtype, h_final (B,H,P,N) fp32)."""
    if x.device.type == "cpu":
        return ref_ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    refuse_grad("ssd", x, dt, A, Bm, Cm)
    out = K.launch_ssd(x, dt, A, Bm, Cm, chunk=chunk)
    count_launch("ssd")
    count_launch(f"ssd/{K.route(x.dtype)}")
    return out


register_kernels("ssd", "ssd/mma", "ssd/simt")
