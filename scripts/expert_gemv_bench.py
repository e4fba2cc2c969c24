#!/usr/bin/env python3
"""What only this script does for the routed experts' GEMV
(``fused_mlp/experts``) on one NVIDIA GPU: count its inner loops'
instructions, and sweep its launch plans.  ``chip_smoke.py`` times the
kernel itself (its ``time_expert_gemv``: cohorts 1, 4 and 8 over
rotating routings, each device kernel's time).

    PYTHONPATH=src python3 scripts/expert_gemv_bench.py \
        [--sweep deepseek-moe-16b:4,...] [--no-sass]

``cuobjdump -sass`` of the built library: for each instance of the two
kernels, the loops of its body (a backward branch and its target), each
loop's instructions by opcode, and instructions a weight (the loop's
instructions over its FADDs, one a q4/q8 weight).  ``--sweep arch:bc``
times each stage's plan swept over CTA widths and K splits in place of
``expert_plans``' rule (the other stage at the rule's), at that MoE
config's widths (``chip_smoke.EXPERT_GEMV``), bf16, q4 g32 experts with
random weights from a seed, through ``chip_smoke``'s own helpers: its
weights and routings, and its ms a call as a CUDA graph of
``EXPERT_ROTATIONS`` calls over rotating routings replays them
(``replayed_ms``).  One JSON line per case; the card's name and power
limit first.
"""
import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def sass_loops(lib_path):
    """Each expert kernel instance's innermost loops that multiply (a
    backward branch and its target, holding no other loop; 16 FFMAs or
    more), by opcode, and instructions a weight: the loop's instructions
    over its FADDs (one a q4/q8 weight; none in a dense loop)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        if "expert_up_kernel" not in name and "expert_down_kernel" not in name:
            continue
        ins = []
        for line in block.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)([^;]*);", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
        spans = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") \
                else None
            if t and int(t.group(1), 16) < addr:
                spans.append((int(t.group(1), 16), addr))
        inner = [sp for sp in spans
                 if not any(o != sp and sp[0] <= o[0] and o[1] <= sp[1]
                            for o in spans)]
        loops = []
        for lo, hi in inner:
            ops = collections.Counter(o.split(".")[0] for a, o, _ in ins
                                      if lo <= a <= hi)
            n = sum(ops.values())
            if ops["FFMA"] >= 16:
                loops.append({"instructions": n, "FFMA": ops["FFMA"],
                              "FADD": ops["FADD"], "LOP3": ops["LOP3"],
                              "LDS": ops["LDS"], "LDGSTS": ops["LDGSTS"],
                              "per_weight": n / ops["FADD"] if ops["FADD"]
                              else None,
                              "ffma_per_weight": ops["FFMA"] / ops["FADD"]
                              if ops["FADD"] else None})
        out[name[:160]] = sorted(loops, key=lambda l: l["FFMA"])
    return out


def sweep(cs, sm, arch, bc):
    """Each stage's plan swept with the other at ``expert_plans``': every
    CTA width of 8, 16 and 32 vector columns and each K split from the
    fewest (EXPERT_MAX_KC rows a CTA) up, put in place of the rule;
    one JSON line a plan with its graph-replayed ms a call."""
    import dataclasses
    import torch
    from repro_torch.kernels.fused_decode import expert as EK
    from repro_torch.kernels.fused_decode import ops
    E, k, D, F = cs.EXPERT_GEMV[arch]
    up, gate, down = cs.expert_weights(sm, E, D, F, torch.bfloat16)
    routes = [cs.expert_routes(sm, bc, k, E)
              for _ in range(cs.EXPERT_ROTATIONS)]
    h = sm.randn(bc, D)

    def call(i):
        return ops.fused_mlp_experts(h, up, down, gate, *routes[i],
                                     act="swiglu")
    rule = EK.expert_plans
    base = rule(bc, k, E, D, F, True, (4, 4), 2, (32, 32))
    for stage, (K, N, nseg) in enumerate(((D, F, 2), (F, D, 1))):
        least = -(-K // EK.EXPERT_MAX_KC)
        for ts in (32, 16, 8):
            for ks in sorted({least, least + 1, 2 * least, 3 * least,
                              4 * least, 6 * least, 8 * least, 12 * least,
                              16 * least}):
                kc = -(-K // ks)
                if kc < EK.EXPERT_THREADS // ts:
                    continue
                p = dataclasses.replace(
                    base[stage], ts=ts, nsub=EK.EXPERT_THREADS // ts,
                    tiles=-(-(N // base[stage].vec) // (ts // nseg)),
                    k_chunk=kc, k_split=ks,
                    smem=EK._smem(base[stage].vec, ts, kc, 1))
                plans = tuple(p if i == stage else base[i] for i in (0, 1))
                EK.expert_plans = lambda *a, **kw: plans
                try:
                    with torch.no_grad():
                        ms = cs.replayed_ms(call, cs.EXPERT_ROTATIONS)
                finally:
                    EK.expert_plans = rule
                print(json.dumps({"sweep": arch, "bc": bc, "stage": stage,
                                  "ts": ts, "ks": ks, "kc": kc,
                                  "blocks": p.blocks, "graph_ms": ms,
                                  "rule": p.args() == base[stage].args()}),
                      flush=True)
    del up, gate, down
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("expert_gemv_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-sass", action="store_true")
    ap.add_argument("--sweep", default="",
                    help="arch:bc,... whose plans to sweep")
    args = ap.parse_args()
    from repro_torch.kernels.build import _out_dir
    from repro_torch.kernels.fused_decode import expert as EK
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip()}))
    EK.library()
    sm = cs.Smoke()
    for case in (c for c in args.sweep.split(",") if c):
        arch, bc = case.split(":")
        sweep(cs, sm, arch, int(bc))
    if not args.no_sass:
        lib = str(_out_dir(EK.LIBRARY, EK.SOURCES) / f"lib{EK.LIBRARY}.so")
        for name, loops in sass_loops(lib).items():
            print(json.dumps({"sass": name, "loops": loops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
