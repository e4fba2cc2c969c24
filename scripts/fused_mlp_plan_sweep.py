#!/usr/bin/env python3
"""Sweep the fused-MLP GEMV's launch plan on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/fused_mlp_plan_sweep.py

The fused MLP (``repro_torch.kernels.fused_decode.fused_mlp``) runs one
split-K GEMV kernel a stage; ``kernels/fused_decode/kernel.py::gemv_plan``
chooses its CTAs along K (for a target of CTAs an SM), the least K rows a
thread walks, and the cluster size along K (``_cluster``).  This script
rebinds those three knobs (``CTAS_AN_SM``, ``MIN_ROWS_A_THREAD`` and
``MAX_CLUSTER``, the largest cluster ``_cluster`` may pick) over a grid
and prints, for LLaVA-OneVision-0.5B's and Qwen2-VL-7B's MLP widths at
cohort 4 (q4 group 32, bf16, random weights from a seed, rotated over
weight sets so each call reads device memory), the profiler's device ms
per call, the error against the plain version, and the two stages'
plans, one JSON line per point, the shipped plan first.
"""
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

# weight sets rotated per width: LLaVA's 8.2 MB a set would sit in L2
ROTATE = {(896, 4864): 16, (3584, 18944): 3}
GRID = {"CTAS_AN_SM": (2, 3, 4), "MAX_CLUSTER": (2, 4, 8),
        "MIN_ROWS_A_THREAD": (8, 32)}


def device_ms(fn, iters=30):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fused_mlp_plan_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.core.quantize import QuantSpec, quantize
    from repro_torch.kernels.fused_decode import fused_mlp, ref_fused_mlp
    from repro_torch.kernels.fused_decode import kernel as K
    gen = torch.Generator(device="cuda").manual_seed(0)
    shipped = tuple(getattr(K, k) for k in GRID)
    points = [shipped] + [p for p in itertools.product(*GRID.values())
                          if p != shipped]
    for (D, F), n_rot in ROTATE.items():
        spec = QuantSpec(4, group_size=32)
        sets = [[quantize((torch.randn(a, b, generator=gen, device="cuda")
                           / a ** 0.5).to(torch.bfloat16), spec)
                 for a, b in ((D, F), (F, D), (D, F))] for _ in range(n_rot)]
        h = torch.randn((4, 1, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        want = ref_fused_mlp(h, *sets[0], act="swiglu").float()
        for point in points:
            for name, value in zip(GRID, point):
                setattr(K, name, value)
            calls = iter(range(10 ** 9))

            def call():
                return fused_mlp(h, *sets[next(calls) % n_rot], act="swiglu")
            got = fused_mlp(h, *sets[0], act="swiglu").float()
            plans = K.mlp_plans(D, F, True, (4, 4), 2, 4)
            print(json.dumps({
                "D": D, "F": F, "bc": 4, "shipped": point == shipped,
                **dict(zip(GRID, point)), "device_ms": device_ms(call),
                "err_over_max": ((got - want).abs().max()
                                 / want.abs().max()).item(),
                "plans": [list(p.args()) + [p.tiles] for p in plans]}),
                flush=True)
        for name, value in zip(GRID, shipped):
            setattr(K, name, value)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
