#!/usr/bin/env python3
"""Sweep the SSD backward's head slices on one NVIDIA GPU.

    python3 scripts/ssd_bwd_slice_sweep.py

The backward's keys and rows kernels (``csrc/ssd.cu``) give each block a
slice of a B/C group's heads, over which it sums dB and dC in registers;
the slices' shares are then added in order.  ``kernel.bwd_slice`` picks
the heads a slice from the call's shape.  This script times every
divisor of the heads a group (put in place of ``bwd_slice`` through
``launch_ssd_backward(heads_a_slice=)``) at Mamba-2-1.3B's training
shape and at Jamba's Mamba-2 widths, bf16 and fp32, dh None as training
gives it: the device ms a call from the profiler (``chip_smoke.timed``,
all seven device kernels) and each device kernel's ms a launch, each
slice's gradients held against the rule's (every row within
``chip_smoke.SSD_BWD_TOL`` of its largest).  Prints one JSON line: per
shape and dtype every slice's ms, the fastest and the rule's, beside the
card's name and power limit.
"""
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = ((4, 2048, 64, 64, 1, 128, 256),       # Mamba-2-1.3B training
          (2, 1024, 128, 128, 1, 128, 256))     # Jamba's Mamba-2


def main() -> int:
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("ssd_bwd_slice_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.ssd import kernel as SK
    sm = cs.Smoke()
    rows = []
    for shape in SHAPES:
        B, S, H, P, G, N, chunk = shape
        rep = H // G
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            args = tuple(t.to(dtype) if t.dtype == torch.bfloat16 else t
                         for t in sm.ssd_inputs(B, S, H, P, G, N))
            dy = sm.randn(B, S, H, P, dtype=dtype)
            _, _, states = SK.launch_ssd(*args, chunk=chunk, want_states=True)
            rule = SK.bwd_slice(B, S, H, G, chunk)
            base = SK.launch_ssd_backward(*args, states, dy, None, chunk=chunk)
            ms, kernels = {}, {}
            for hs in (d for d in range(1, rep + 1) if rep % d == 0):
                def call(i, hs=hs):
                    return SK.launch_ssd_backward(*args, states, dy, None,
                                                  chunk=chunk,
                                                  heads_a_slice=hs)
                got = call(0)
                for part, g, w in zip(cs.SSD_GRADS, got, base):
                    r = ((g.float() - w.float()).abs().amax(-1)
                         / w.float().abs().amax(-1)).nan_to_num(nan=0.0)
                    if r.max().item() > cs.SSD_BWD_TOL[name]:
                        raise RuntimeError(f"{shape} {name} slice {hs}: "
                                           f"{part} {r.max().item()}")
                del got
                ms[hs] = cs.dev_or_call(cs.timed(
                    call, 1, iters=10, kernels=cs.SSD_BWD_DEVICE_KERNELS))

                def ten(hs=hs):
                    for _ in range(10):
                        call(0, hs)
                    torch.cuda.synchronize()
                kernels[hs] = {re.search(r"ssd_\w+", n).group(0): us / c / 1e3
                               for n, us, c in cs.device_time(ten)[1]
                               if c and re.search(r"ssd_\w+", n)}
            best = min(ms, key=ms.get)
            rows.append({"shape": dict(zip(("B", "S", "H", "P", "G", "N",
                                            "chunk"), shape)),
                         "dtype": name, "ms_by_heads_a_slice": ms,
                         "kernel_ms_a_launch": kernels,
                         "fastest": [best, ms[best]], "rule": [rule, ms[rule]]})
            del args, dy, states, base
            torch.cuda.empty_cache()
    print(json.dumps({"ssd_bwd_slice_sweep": rows, "card": cs.card_label()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
