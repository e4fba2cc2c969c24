"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``),
each beside its plain PyTorch version.

Every kernel wrapper counts its calls into the compiled libraries in one
registry, so a run can show that it went through the kernels: reset the
counts just before the run with :func:`reset_launch_counts` and read them
just after with :func:`launch_counts`.  The counts, one per wrapper:
``fused_qkv``, ``fused_mlp``, ``kv_scatter`` (``fused_decode``),
``flash_attention``, ``ssd``, ``linear_attention``, ``dequant_gemm`` and
``cache_row_update`` (``cache_update``), each registered when its
``ops`` module is imported.  A wrapper with more than one kernel behind
it also counts each launch under ``<wrapper>/<route>``:
``flash_attention/wgmma`` (bf16) and ``flash_attention/tf32x3`` (fp32,
split TF32 on mma.sync);
``dequant_gemm/wgmma`` (the warp-specialised bf16 kernel) and
``dequant_gemm/tile`` (fp32, and bf16 calls outside the wgmma kernel's
rule, ``dequant_gemm.kernel.route``); ``ssd/mma`` (bf16, tensor-core
products) and ``ssd/simt`` (fp32, FFMA); ``fused_mlp/gemv`` (the split-K
GEMV of both MLP stages, one a call) and ``fused_qkv/gemv`` (the same
GEMV, one a device kernel: one a distinct bit width of wq, wk, wv).
"""
from typing import Dict

_LAUNCHES: Dict[str, int] = {}


def register_kernels(*names: str) -> None:
    """Give each wrapper ``name`` a count (0) in the registry."""
    for name in names:
        _LAUNCHES.setdefault(name, 0)


def count_launch(name: str, n: int = 1) -> None:
    _LAUNCHES[name] += n


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
