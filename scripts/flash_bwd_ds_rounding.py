#!/usr/bin/env python3
"""Why the bf16 flash backward keeps dS in two bf16 terms (CPU only).

    PYTHONPATH=src python3 scripts/flash_bwd_ds_rounding.py [--seeds N]

The bf16 backward kernel feeds dS to the tensor cores for dQ = dS K and
dK = dSᵀ Q.  Rounded once to bf16, dS is the one value the kernel would
round where the plain version (``ref_attention_backward``) keeps fp32.
This script repeats the kernel's arithmetic in plain PyTorch both ways,
dS rounded once and dS = hi + lo (``ref.emulate_flash_bwd``), on bf16
inputs at several shapes and seeds, and prints for dq and dk the worst
ratio of each version's error against the float64 backward to the plain
version's (max |err| over the largest |exact|): the card checks hold the
kernel to at most 2.0.  Prints one JSON line.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    emulate_flash_bwd, ref_attention_backward, ref_attention_lse)

SHAPES = ((1, 1024, 14, 2, 64, True), (1, 777, 14, 2, 64, True),
          (1, 1024, 28, 4, 128, True), (2, 256, 6, 2, 32, True),
          (2, 256, 6, 2, 32, False), (1, 256, 8, 8, 64, True),
          (1, 128, 32, 4, 16, True), (1, 128, 32, 4, 16, False),
          (2, 128, 4, 2, 32, False))


def rounded_once(q, k, v, o, lse, do, causal):
    """(dq, dk) with dS rounded once to bf16, the rest as the kernel."""
    B, S, H, hd = q.shape
    _, _, KV, _ = k.shape
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, hd)
    dog = do.float().reshape(B, S, KV, G, hd)
    dsum = (dog.double() * o.double().reshape(B, S, KV, G, hd)).sum(-1)
    s = torch.einsum("bikgh,bjkh->bkgij", qg, k.float())
    p = torch.exp2(s * (hd ** -0.5 * 1.4426950408889634)
                   - (lse.reshape(B, KV, G, S) * 1.4426950408889634)[..., None])
    if causal:
        keep = torch.arange(S)[:, None] >= torch.arange(S)[None]
        p = torch.where(keep, p, torch.zeros(()))
    dp = torch.einsum("bikgh,bjkh->bkgij", dog, v.float())
    ds = (p * (dp - dsum.float().permute(0, 2, 3, 1)[..., None])
          ).to(torch.bfloat16).float()
    dq = torch.einsum("bkgij,bjkh->bikgh", ds, k.float()) * hd ** -0.5
    dk = torch.einsum("bkgij,bikgh->bjkh", ds, qg) * hd ** -0.5
    return dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    worst = {m: {"dq": 0.0, "dk": 0.0} for m in ("rounded_once", "split")}
    for B, S, H, KV, hd, causal in SHAPES:
        for seed in range(args.seeds):
            g = torch.Generator().manual_seed(1000 * seed + S + hd)
            q, k, v, do = (torch.randn(shape, generator=g).to(torch.bfloat16)
                           for shape in ((B, S, H, hd), (B, S, KV, hd),
                                         (B, S, KV, hd), (B, S, H, hd)))
            o, lse = ref_attention_lse(q, k, v, causal=causal)
            plain = ref_attention_backward(q, k, v, o, lse, do, causal=causal)
            exact = ref_attention_backward(*(t.double() for t in (
                q, k, v, o, lse, do)), causal=causal)
            split = emulate_flash_bwd(q, k, v, o, lse, do, causal=causal)
            once = rounded_once(q, k, v, o, lse, do, causal)
            for i, part in enumerate(("dq", "dk")):
                x = exact[i]
                den = x.abs().max()
                p_err = ((plain[i].double() - x).abs().max() / den).item()
                for name, got in (("rounded_once", once), ("split", split)):
                    k_err = ((got[i].double() - x).abs().max() / den).item()
                    worst[name][part] = max(worst[name][part], k_err / p_err)
    print(json.dumps({"worst_ratio_to_plain_vs_float64": worst,
                      "shapes": [list(s) for s in SHAPES],
                      "seeds": args.seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
