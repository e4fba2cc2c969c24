"""Streaming linear attention (phi = elu + 1): a Hopper kernel with its
plain version and wrapper."""
from repro_torch.kernels.linear_attention.ops import linear_attention
from repro_torch.kernels.linear_attention.ref import (
    ref_linear_attention, ref_linear_attention_chunked)

__all__ = ["linear_attention", "ref_linear_attention",
           "ref_linear_attention_chunked"]
