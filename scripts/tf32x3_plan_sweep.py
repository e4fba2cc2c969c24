#!/usr/bin/env python3
"""Sweep the split-TF32 packed-weight GEMM's plans on one NVIDIA GPU.

    python3 scripts/tf32x3_plan_sweep.py

The fp32 route of ``kernels/dequant_gemm`` (``dequant_gemm/tf32x3``) runs
128 x 64 output tiles and may split K; ``kernel.tf32x3_plan`` picks the
number of splits from the call's (M, N, K).  This script times every
split of 1, 2, 3, 4, 6 and 8 that keeps each split at least two K steps
(put in place of ``tf32x3_plan``, as ``fused_qkv_plan_sweep.py`` sweeps
its plans) at the served fp32 projection shapes, q4 g32 in the model's
"kn" layout: LLaVA-OneVision-0.5B's five at 1024 rows (the fp32 serve's
prefill) and Mamba-2-1.3B's two at 2048 rows.  Each plan's time is the
device time per call from the profiler (``chip_smoke.timed``: both
device kernels of a split call; host overhead, which CUDA events around
a loop of small calls would measure, excluded), with its output held
against the plain version (``dequantize`` + ``torch.matmul`` in full
fp32) within 1e-5 of the largest magnitude.  Prints one JSON line: per
shape every split's ms, the fastest split and the rule's.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = (  # (model, projection, M, K, weight shape)
    ("llava-onevision-0.5b", "q", 1024, 896, (896, 14, 64)),
    ("llava-onevision-0.5b", "k / v", 1024, 896, (896, 2, 64)),
    ("llava-onevision-0.5b", "o", 1024, 896, (896, 896)),
    ("llava-onevision-0.5b", "up / gate", 1024, 896, (896, 4864)),
    ("llava-onevision-0.5b", "down", 1024, 4864, (4864, 896)),
    ("mamba2-1.3b", "in_proj", 2048, 2048, (2048, 8512)),
    ("mamba2-1.3b", "out_proj", 2048, 4096, (4096, 2048)))
SPLITS = (1, 2, 3, 4, 6, 8)


def main() -> int:
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("tf32x3_plan_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.core.quantize import QuantSpec, dequantize, quantize
    from repro_torch.kernels.dequant_gemm import kernel as DK
    rule_of = DK.tf32x3_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for model, proj, M, K, wshape in SHAPES:
        x = torch.randn((M, K), generator=gen, device="cuda")
        w = quantize(torch.randn(wshape, generator=gen, device="cuda")
                     * K ** -0.5, QuantSpec(4, group_size=32))
        dense = dequantize(w).reshape(K, -1)
        want = torch.matmul(x, dense)
        N = want.shape[1]
        steps = -(-K // DK.TF32_BK)
        plans = {}
        try:
            for splits in SPLITS:
                if steps < 2 * splits:
                    continue
                DK.tf32x3_plan = lambda M, N, K, s=splits: s

                def call():
                    return DK.launch_packed_matmul(x, w, 1)[0]
                got = call()
                err = ((got - want).abs().max()
                       / want.abs().max()).item()
                if err > 1e-5:
                    raise RuntimeError(f"{model} {proj} splits {splits}: "
                                       f"err {err}")
                plans[splits] = cs.dev_or_call(cs.timed(
                    lambda i: call(), 1, iters=20))
        finally:
            DK.tf32x3_plan = rule_of
        rule = rule_of(M, N, K)
        best = min(plans, key=plans.get)
        rows.append({"model": model, "proj": proj, "M": M, "K": K, "N": N,
                     "ms_by_splits": plans, "fastest": [best, plans[best]],
                     "rule": [rule, plans.get(rule)]})
        del x, w, dense, want
        torch.cuda.empty_cache()
    print(json.dumps({"tf32x3_plan_sweep": rows,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
