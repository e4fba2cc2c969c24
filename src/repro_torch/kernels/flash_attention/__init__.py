"""Flash attention: a Hopper kernel (online softmax, GQA by kv row) with
its plain version and wrapper."""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import ref_attention

__all__ = ["flash_attention", "ref_attention"]
