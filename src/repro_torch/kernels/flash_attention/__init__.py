"""Flash attention: a Hopper kernel (online softmax, GQA by kv row) and
its backward, with their plain versions and the wrapper."""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (ref_attention,
                                                     ref_attention_backward,
                                                     ref_attention_lse)

__all__ = ["flash_attention", "ref_attention", "ref_attention_backward",
           "ref_attention_lse"]
