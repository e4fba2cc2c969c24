#!/usr/bin/env python3
"""How the packed-weight GEMM's bf16 output compares with its plain
version (``dequantize`` + ``torch.einsum``) at long K, on the card.

    python3 scripts/long_k_gemm_plain.py

At Jamba-1.5-Large's widths the down projections contract K = 24576.
For each shape this prints, for the kernel (``quant_einsum``) against
four evaluations of the same product, max |err| over max |evaluation|
and the number of outputs that differ:

* ``plain``: ``ref_quant_einsum`` as PyTorch runs it by default (cuBLAS
  may reduce split-K partial sums in bf16);
* ``plain_fp32_reduction``: the same with
  ``allow_bf16_reduced_precision_reduction = False``;
* ``fp32_gemm``: the bf16 operands multiplied in fp32 (TF32 off), the
  result rounded to bf16 once;
* ``float64``: the product in float64, rounded to bf16 once (the
  correctly rounded result);

and each of them against the float64 product before rounding (max
|err| over max).  The card's name and power limit come first; each
shape's record is one JSON line.
"""
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

# (name, einsum, x shape, weight shape): Jamba's dense down projection at
# a 128- and a 2048-row prefill, its up projection, and the experts' down
# at a 1 x 1024 prefill (4 groups, capacity 40)
SHAPES = (
    ("dense down, 128 rows", "bsf,fd->bsd", (1, 128, 24576), (24576, 8192)),
    ("dense down, 2048 rows", "bsf,fd->bsd", (1, 2048, 24576),
     (24576, 8192)),
    ("dense up, 128 rows", "bsd,df->bsf", (1, 128, 8192), (8192, 24576)),
    ("experts down, 4 x 16 x 40 rows", "gecf,efd->gecd", (4, 16, 40, 24576),
     (16, 24576, 8192)),
)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("long_k_gemm_plain: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.quantize import (QuantPolicy, dequantize,
                                           quantize_stacked)
    from repro_torch.kernels.dequant_gemm import (quant_einsum,
                                                  ref_quant_einsum)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    policy = QuantPolicy("q4-g32", ((".", "q4f16-g32"),))
    for name, spec, xs, ws in SHAPES:
        x = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
        qt = quantize_stacked("w", ws, torch.bfloat16, (
            (torch.randn(ws[-2:], generator=gen, device=dev)
             * ws[-2] ** -0.5).to(torch.bfloat16)
            for _ in range(math.prod(ws[:-2]))), policy)
        dense = (torch.stack([dequantize(qt.layer(i))
                              for i in range(ws[0])])
                 if len(ws) == 3 else dequantize(qt))
        with torch.no_grad():
            got = quant_einsum(spec, x, qt)
            evals = {"plain": ref_quant_einsum(spec, x, qt)}
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = False
            evals["plain_fp32_reduction"] = torch.einsum(spec, x, dense)
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = True
            evals["fp32_gemm"] = torch.einsum(
                spec, x.float(), dense.float()).to(torch.bfloat16)
            exact = torch.einsum(spec, x.double(), dense.double())
            evals["float64"] = exact.to(torch.bfloat16)
        torch.cuda.synchronize()
        m64 = exact.abs().max().item()
        rec = {"shape": name, "einsum": spec, "x": list(xs),
               "w": list(ws), "max_abs_float64": m64,
               "kernel_vs_float64_err_over_max":
                   (got.double() - exact).abs().max().item() / m64}
        for key, ev in evals.items():
            m = ev.float().abs().max().item()
            rec[key] = {
                "kernel_err_over_max": (got.float() - ev.float()).abs()
                .max().item() / m,
                "outputs_differing": int((got != ev).sum().item()),
                "vs_float64_err_over_max": (ev.double() - exact).abs()
                .max().item() / m64}
        print(json.dumps(rec))
        del x, qt, dense, got, evals, exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
