"""Fused low-bit cohort decode: three Hopper kernels (fused QKV, fused
MLP, paged KV-row scatter) with their plain versions and wrappers."""
from repro_torch.kernels.fused_decode.ops import (cohort_step, fused_mlp,
                                                  fused_qkv, fused_supported,
                                                  kv_scatter)
from repro_torch.kernels.fused_decode.ref import (gather_context,
                                                  ref_cohort_step,
                                                  ref_fused_mlp,
                                                  ref_fused_qkv,
                                                  ref_kv_scatter)

__all__ = ["cohort_step", "fused_mlp", "fused_qkv", "fused_supported",
           "kv_scatter",
           "gather_context", "ref_cohort_step", "ref_fused_mlp",
           "ref_fused_qkv", "ref_kv_scatter"]
