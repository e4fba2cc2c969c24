#!/usr/bin/env python3
"""Sweep the fused QKV's split-K GEMV plan on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/fused_qkv_plan_sweep.py

The fused QKV (``repro_torch.kernels.fused_decode.fused_qkv``) runs one
split-K GEMV launch over q | k | v side by side;
``kernels/fused_decode/kernel.py::qkv_plan`` chooses its vector columns a
CTA (slots), its CTAs along K and their cluster size.  This script
replaces ``qkv_plan`` (and ``QKV_SLOTS``, which pads each weight to
whole tiles) by each point of a grid (slots 8, 16 or 32; K
split; cluster size 4 or 8 where it divides the split, or the whole split
where it fits one cluster) and prints, for LLaVA-OneVision-0.5B's
and Qwen2-VL-7B's QKV widths at cohort 4 (q4 group 32 with biases, bf16
and fp32, random weights from a seed, rotated over as many weight sets as
``chip_smoke.py`` times them over: 24 and 8), the profiler's device ms per
call, the error against the plain version, and the plan, one JSON line
per point, the shipped plan first; then the fastest point of each width
and dtype.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

# (D, H, KV, hd) and the weight sets rotated, as chip_smoke.py times them
WIDTHS = {"llava-onevision-0.5b": ((896, 14, 2, 64), 24),
          "qwen2-vl-7b": ((3584, 28, 4, 128), 8)}
SPLITS = (1, 2, 4, 7, 8, 14, 16, 24, 28, 32, 48, 56)


def device_ms(fn, iters=48):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(4):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def points(K):
    """(slots, k_split, cluster) of the grid for K rows."""
    from repro_torch.kernels.fused_decode import kernel as FK
    for slots in (8, 16, 32):
        for ks in SPLITS:
            if -(-K // ks) > FK.MAX_K_CHUNK or K // ks < 8:
                continue
            for ck in sorted({c for c in (4, 8, ks)
                              if c <= FK.MAX_CLUSTER and ks % c == 0}):
                yield slots, ks, ck


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fused_qkv_plan_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.core.quantize import QuantSpec, quantize
    from repro_torch.kernels.fused_decode import fused_qkv, ref_fused_qkv
    from repro_torch.kernels.fused_decode import kernel as FK
    shipped = FK.qkv_plan, FK.QKV_SLOTS
    gen = torch.Generator(device="cuda").manual_seed(0)
    spec = QuantSpec(4, group_size=32)
    best = []
    for arch, ((D, H, KV, hd), n_rot) in WIDTHS.items():
        for dtype in (torch.bfloat16, torch.float32):
            sets = [[quantize((torch.randn((D, n, hd), generator=gen,
                                           device="cuda") / D ** 0.5
                               ).to(dtype), spec) for n in (H, KV, KV)]
                    + [(torch.randn((n, hd), generator=gen, device="cuda")
                        * 0.1).to(dtype) for n in (H, KV, KV)]
                    for _ in range(n_rot)]
            h = torch.randn((4, 1, D), generator=gen, device="cuda").to(dtype)
            want = [w.float() for w in ref_fused_qkv(h, *sets[0])]
            rows = []
            for point in [None] + list(points(D)):
                if point is None:
                    FK.qkv_plan, FK.QKV_SLOTS = shipped
                else:
                    def plan(K, n, bits, eb, bc, point=point):
                        return FK._plan(K, n, 1, bits, eb, bc, *point)
                    FK.qkv_plan, FK.QKV_SLOTS = plan, point[0]
                FK.qkv_plans.cache_clear()
                calls = iter(range(10 ** 9))

                def call():
                    return fused_qkv(h, *sets[next(calls) % n_rot])
                got = fused_qkv(h, *sets[0])
                err = max(((g.float() - w).abs().max() / w.abs().max()).item()
                          for g, w in zip(got, want))
                (p,) = FK.qkv_plans(D, tuple((n * hd, 4) for n in (H, KV, KV)),
                                    h.element_size(), 4)
                row = {"arch": arch, "dtype": str(dtype).replace("torch.", ""),
                       "bc": 4, "shipped": point is None,
                       "device_ms": device_ms(call), "err_over_max": err,
                       "plan": {"slots": p.slots, "tiles": p.tiles,
                                "k_split": p.k_split, "cluster": p.cluster,
                                "clusters": p.clusters, "k_chunk": p.k_chunk}}
                rows.append(row)
                print(json.dumps(row), flush=True)
            best.append(min(rows[1:], key=lambda r: r["device_ms"]))
            del sets
    FK.qkv_plan, FK.QKV_SLOTS = shipped
    FK.qkv_plans.cache_clear()
    print(json.dumps({"fastest": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
