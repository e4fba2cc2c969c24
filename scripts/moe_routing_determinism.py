#!/usr/bin/env python3
"""Which of the MoE's library ops give a row another result when the call
has more rows, on the card.

    python3 scripts/moe_routing_determinism.py

A prompt prefilled in two buckets (its pads masked) routes in the same
groups of 256 tokens, so its rows meet the same arithmetic only if every
op computes a row alike whatever the call's row count.  At DeepSeek-
MoE-16B's widths (D 2048, E 64, capacity 30) this runs each op of
``models/moe.apply_moe`` that is a library call on the groups of a
512-token bucket and of a 1024-token bucket whose first two groups are
the same, and prints, for each op, whether those two groups' outputs are
bit-equal: the router's logits as an fp32 GEMM (``gsd,de->gse``, the
reference's arithmetic) and as the port computes them
(``moe.router_logits``: a float64 product rounded to fp32), the bf16
dispatch (``gsd,gsec->gecd``) and the bf16 combine (``gecd,gsec->gsd``).
The card's name and power limit come first.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("moe_routing_determinism: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.models.moe import router_logits
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    D, E, C, gs = 2048, 64, 30, 256

    def rn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)
    x4 = rn(4, gs, D, dtype=torch.bfloat16)
    router = rn(D, E, scale=D ** -0.5)
    # a one-hot dispatch of capacity C and a combine with random gates
    slot = torch.randint(0, E * C, (4, gs), generator=gen, device=dev)
    disp = torch.zeros((4, gs, E * C), device=dev)
    disp.scatter_(2, slot[..., None], 1.0)
    disp = disp.reshape(4, gs, E, C)
    comb = disp * torch.rand((4, gs, 1, 1), generator=gen, device=dev)
    ye = rn(4, E, C, D, dtype=torch.bfloat16)
    ops = {
        "router gsd,de->gse fp32": lambda g: torch.einsum(
            "gsd,de->gse", x4[:g].float(), router),
        "router moe.router_logits (float64, rounded to fp32)":
            lambda g: router_logits(x4[:g], router),
        "dispatch gsd,gsec->gecd bf16": lambda g: torch.einsum(
            "gsd,gsec->gecd", x4[:g], disp[:g].to(torch.bfloat16)),
        "combine gecd,gsec->gsd bf16": lambda g: torch.einsum(
            "gecd,gsec->gsd", ye[:g], comb[:g].to(torch.bfloat16)),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    out = {}
    with torch.no_grad():
        for name, fn in ops.items():
            two, four = fn(2), fn(4)[:2]
            torch.cuda.synchronize()
            diff = (two.float() - four.float()).abs()
            out[name] = {"bit_equal": bool(torch.equal(two, four)),
                         "elements_differing": int((diff > 0).sum()),
                         "max_abs_diff": diff.max().item(),
                         "elements": two.numel()}
    print(json.dumps({"moe_ops_two_vs_four_groups": out,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
