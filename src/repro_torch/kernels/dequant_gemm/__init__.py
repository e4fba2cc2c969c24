"""Packed-weight (W2/W4/W8, A16) GEMM: a Hopper kernel that unpacks the
weight tile by tile in shared memory, with its plain versions and
wrappers."""
from repro_torch.kernels.dequant_gemm.ops import dequant_gemm, quant_einsum
from repro_torch.kernels.dequant_gemm.ref import (ref_dequant_gemm,
                                                  ref_quant_einsum)

__all__ = ["dequant_gemm", "quant_einsum", "ref_dequant_gemm",
           "ref_quant_einsum"]
