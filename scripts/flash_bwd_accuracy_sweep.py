#!/usr/bin/env python3
"""The flash backward kernel's accuracy on many random draws, on the card.

    python3 scripts/flash_bwd_accuracy_sweep.py [--seeds N] [--dtype float32]

``chip_smoke.py`` holds the backward kernel on fixed inputs: every dq /
dk / dv row within 2e-2 of the row's largest magnitude against its plain
version (``ref_attention_backward``) in bf16, within 1e-4 against the
float64 backward in fp32 (a causal dq's row 0 against the gradient's
largest), and against the float64 backward no worse than 2x the plain
version.  This script runs these measures over many draws (N seeds a case, 2 for the largest
cases) at chip_smoke's phase-2 shapes and the card tests' extra cases,
and prints for each case the worst row (gradient, position, head, and
the kernel's and the plain version's own error against float64 at that
row) and the worst float64 ratio, then the counts of draws past each
gate.  A few-key causal dq row cancels dP - D and shows how close any
fp32 computation comes to the row gate there.  Each draw is also held
by the row gate against the float64 backward instead of the plain
version (each row's error over that row's largest float64 magnitude, a
causal dq's row 0 over the gradient's): ``rows_past_gate`` counts the
draws past the gate as measured against the plain version,
``rows_past_gate_vs_float64`` those past it as measured against float64
(the gate ``chip_smoke.py`` and the card tests hold fp32 rows to), and
``plain_rows_past_gate_vs_float64`` the draws where the plain version
itself is past it, on the same draws.  Builds the library from the
checkout; needs one GPU; prints JSON lines.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ROW_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
CASES = ((4, 2048, 2048, 14, 2, 64, True), (1, 2048, 2048, 28, 4, 128, True),
         (1, 777, 777, 14, 2, 64, True), (1, 300, 1000, 28, 4, 128, False),
         (2, 128, 128, 4, 2, 32, True), (2, 128, 128, 4, 2, 32, False),
         (1, 256, 256, 8, 8, 64, True), (1, 256, 256, 8, 8, 64, False),
         (2, 256, 256, 6, 2, 32, True), (2, 256, 256, 6, 2, 32, False),
         (1, 128, 128, 32, 4, 16, True), (1, 128, 128, 32, 4, 16, False),
         (1, 1024, 1024, 28, 4, 128, True), (1, 200, 77, 8, 2, 160, True),
         (1, 2, 2, 4, 1, 64, True), (1, 1024, 1024, 28, 4, 160, True),
         (1, 300, 777, 28, 4, 160, False))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_accuracy_sweep: no CUDA device visible",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import ref_attention_backward
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--dtype", choices=("bfloat16", "float32", "both"),
                    default="both")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("bfloat16", "float32") if args.dtype == "both" else (args.dtype,)
    for name in names:
        dtype = getattr(torch, name)
        totals = {"draws": 0, "rows_past_gate": 0,
                  "rows_past_gate_vs_float64": 0,
                  "plain_rows_past_gate_vs_float64": 0,
                  "float64_past_2x": 0}
        for case in CASES:
            B, Sq, Sk, H, KV, hd, causal = case
            seeds = 2 if B * H * Sq * Sk > 5e7 else args.seeds
            worst_row, worst_f64, worst_r64, worst_p64 = None, 0.0, 0.0, 0.0
            for seed in range(seeds):
                g = torch.Generator(device="cuda").manual_seed(1000 + seed)
                q, k, v, do = (torch.randn(s, generator=g, device="cuda")
                               .to(dtype) for s in (
                                   (B, Sq, H, hd), (B, Sk, KV, hd),
                                   (B, Sk, KV, hd), (B, Sq, H, hd)))
                o, lse = FK.launch_flash_attention(q, k, v, causal=causal,
                                                   want_lse=True)
                got = FK.launch_flash_attention_backward(q, k, v, o, lse, do,
                                                         causal=causal)
                want = ref_attention_backward(q, k, v, o, lse, do,
                                              causal=causal)
                exact = ref_attention_backward(*(t.double() for t in (
                    q, k, v, o, lse, do)), causal=causal)
                draw_row, draw_f64, draw_r64, draw_p64 = 0.0, 0.0, 0.0, 0.0
                for i, (a, w, x) in enumerate(zip(got, want, exact)):
                    a, w = a.double(), w.double()
                    row = w.abs().amax(-1)
                    den = row.clone()
                    if i == 0 and causal:
                        den[:, 0] = row.max()
                    row64 = x.abs().amax(-1)
                    den64 = row64.clone()
                    if i == 0 and causal:
                        den64[:, 0] = row64.max()
                    k64 = (a - x).abs().amax(-1)
                    r64 = (k64 / den64).nan_to_num(nan=0.0, posinf=1e9)
                    draw_r64 = max(draw_r64, r64.max().item())
                    p64 = ((w - x).abs().amax(-1) / den64).nan_to_num(
                        nan=0.0, posinf=1e9)
                    draw_p64 = max(draw_p64, p64.max().item())
                    r = ((a - w).abs().amax(-1) / den).nan_to_num(
                        nan=0.0, posinf=1e9)
                    at = int(r.argmax())
                    rec = {"ratio": r.max().item(),
                           "grad": ("dq", "dk", "dv")[i],
                           "position": at // r.shape[2] % r.shape[1],
                           "head": at % r.shape[2],
                           "kernel_vs_float64": ((a - x).abs().amax(-1)
                                                 .flatten()[at]
                                                 / den.flatten()[at]).item(),
                           "plain_vs_float64": ((w - x).abs().amax(-1)
                                                .flatten()[at]
                                                / den.flatten()[at]).item()}
                    if worst_row is None or rec["ratio"] > worst_row["ratio"]:
                        worst_row = rec
                    draw_row = max(draw_row, rec["ratio"])
                    d = x.abs().max()
                    p_err = ((w - x).abs().max() / d).item()
                    k_err = ((a - x).abs().max() / d).item()
                    draw_f64 = max(draw_f64, k_err / p_err if p_err else 0.0)
                worst_f64 = max(worst_f64, draw_f64)
                worst_r64 = max(worst_r64, draw_r64)
                worst_p64 = max(worst_p64, draw_p64)
                totals["draws"] += 1
                totals["rows_past_gate"] += draw_row > ROW_TOL[name]
                totals["rows_past_gate_vs_float64"] += draw_r64 > ROW_TOL[
                    name]
                totals["plain_rows_past_gate_vs_float64"] += draw_p64 > \
                    ROW_TOL[name]
                totals["float64_past_2x"] += draw_f64 > 2.0
                del q, k, v, do, o, lse, got, want, exact
                torch.cuda.empty_cache()
            print(json.dumps({"dtype": name, "case": list(case),
                              "draws": seeds, "worst_row": worst_row,
                              "worst_row_vs_float64": worst_r64,
                              "plain_worst_row_vs_float64": worst_p64,
                              "worst_float64_ratio": worst_f64}), flush=True)
        print(json.dumps({"dtype": name, "totals": totals,
                          "row_gate": ROW_TOL[name], "float64_gate": 2.0,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
