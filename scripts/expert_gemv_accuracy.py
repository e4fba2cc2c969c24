#!/usr/bin/env python3
"""The routed experts' GEMV's arithmetic against float64, on the CPU.

    PYTHONPATH=src python3 scripts/expert_gemv_accuracy.py [--draws 4]

The kernel (``csrc/expert_gemv.cu``) folds each group's scale into x
(fl(x * s) * code fused into an fp32 sum) where the reference rounds each
weight code * s to the activations' dtype.  ``ref.emulate_fused_mlp_
experts`` repeats the kernel's arithmetic and order; this script holds it
and the plain version (``ref_fused_mlp_experts``, the reference's
arithmetic) against float64 of the reference's dequantized weights: for
bf16 and fp32, q4 g32, q4 g16, q8 g64 and dense experts, at widths E 8,
top-2, D 512, F 768, 6 rows (one choosing an expert twice, one a
sentinel), over ``--draws`` random draws.  Each line: the largest over
draws of each valid row's max error over its max |float64| for the
emulation and the plain version, their ratio, and the emulation against
the plain version.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
LABELS = {"q4g32": (4, 32), "q4g16": (4, 16), "q8g64": (8, 64),
          "dense": None}
E, K_TOP, D, F, BC = 8, 2, 512, 768, 6


def draw(seed, label, dtype):
    import torch
    from repro_torch.core import quantize as TQ
    rng = np.random.default_rng(seed)
    ws = []
    for K, N in ((D, F), (D, F), (F, D)):
        w = torch.from_numpy((rng.standard_normal((E, K, N)) / np.sqrt(K))
                             .astype(np.float32)).to(dtype)
        if LABELS[label] is not None:
            bits, g = LABELS[label]
            w = TQ.quantize(w, TQ.QuantSpec(bits, group_size=g))
        ws.append(w)
    idx = np.stack([rng.permutation(E)[:K_TOP] for _ in range(BC)])
    idx[0, 1] = idx[0, 0]
    gates = rng.random((BC, K_TOP)) + 0.1
    gates = (gates / gates.sum(1, keepdims=True)).astype(np.float32)
    valid = np.ones(BC, bool)
    valid[3] = False
    h = torch.from_numpy(rng.standard_normal((BC, D)).astype(np.float32)
                         ).to(dtype)
    return h, ws, idx, gates, valid


def f64(h, ws, idx, gates, valid):
    import torch
    from repro_torch.core import quantize as TQ
    up, gate, down = (TQ.dequantize(w).double() if isinstance(w, TQ.QTensor)
                      else w.double() for w in ws)
    out = torch.zeros(h.shape, dtype=torch.float64)
    for r in range(h.shape[0]):
        if valid[r]:
            for j, e in enumerate(idx[r]):
                g = h[r].double() @ gate[e]
                mid = g * torch.sigmoid(g) * (h[r].double() @ up[e])
                out[r] += float(gates[r, j]) * (mid @ down[e])
    return out


def row_err(got, want, valid):
    g, w = got[valid].double(), want[valid].double()
    return float(((g - w).abs().amax(1) / w.abs().amax(1)).max())


def main() -> int:
    import torch
    from repro_torch.kernels.fused_decode import expert as EK
    from repro_torch.kernels.fused_decode import ref as FR
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=4)
    args = ap.parse_args()
    for dtype in (torch.bfloat16, torch.float32):
        for label, spec in LABELS.items():
            bits, group = spec if spec else (0, 0)
            plans = EK.expert_plans(BC, K_TOP, E, D, F, True, (bits, bits),
                                    torch.finfo(dtype).bits // 8,
                                    (group, group))
            emu_e = plain_e = diff = 0.0
            for seed in range(args.draws):
                h, ws, idx, gates, valid = draw(seed, label, dtype)
                a = (torch.from_numpy(idx), torch.from_numpy(gates),
                     torch.from_numpy(valid))
                want = f64(h, ws, idx, gates, valid)
                plain = FR.ref_fused_mlp_experts(h, ws[0], ws[2], ws[1], *a,
                                                 act="swiglu")
                emu = FR.emulate_fused_mlp_experts(
                    h, ws[0], ws[2], ws[1], *a, act="swiglu", plans=plans)
                emu_e = max(emu_e, row_err(emu, want, valid))
                plain_e = max(plain_e, row_err(plain, want, valid))
                diff = max(diff, row_err(emu, plain, valid))
            print(json.dumps({
                "dtype": str(dtype).split(".")[-1], "weights": label,
                "plans": [p.args() for p in plans],
                "emulation_vs_f64": emu_e, "plain_vs_f64": plain_e,
                "ratio": emu_e / plain_e, "emulation_vs_plain": diff}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
