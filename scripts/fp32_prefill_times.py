#!/usr/bin/env python3
"""Device times of the fp32 prefill layers of the port on one NVIDIA GPU.

    python3 scripts/fp32_prefill_times.py [--src DIR] [--label NAME]

Prints one JSON line with:

- ``gemm``: the packed-weight GEMM at LLaVA-OneVision-0.5B's five served
  projection shapes (q, k/v, o, up/gate, down at 1024 rows), q4 g32, in
  fp32, beside ``dequantize`` + fp32 ``torch.matmul`` and ``matmul`` on
  the dense weight (``chip_smoke.time_gemm_shapes``);
- ``linear_attention``: the linear-attention kernel at
  ``chip_smoke.LA_SHAPE`` in bf16 and fp32, with the device ms of each of
  its device kernels (``chip_smoke.time_linear``);
- ``prefill``: one 1 x 1024 prefill call (a 729-token image and 16 text
  tokens) of LLaVA-OneVision-0.5B in fp32 with flash prefill and of the
  same config with linear attention in fp32, at full width and depth
  with random weights (seed 0), wall and device ms with the GEMM's,
  flash's and linear attention's device ms (``chip_smoke.prefill_breakdown``).

``--src`` is the package tree timed (default: this checkout's ``src``), so
that one call can time two trees in turn (a parent unpacked with ``git
archive`` and this one) on the same card.  Exits 2 without a GPU.
"""
import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prefill_group(sm, cfg):
    """A full-width engine of ``cfg`` and the inputs of its 1 x 1024
    prefill call for one 745-token request."""
    import chip_smoke as cs
    import torch
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    with torch.no_grad():
        params = quantize_tree(init_params(cfg, device=sm.dev, seed=0),
                               PROFILES["nanomind-serve"])
    eng = ServingEngine(
        cfg, params, n_slots=cs.N_SLOTS, max_len=cs.MAX_LEN[cfg.name],
        block_size=cs.BLOCK_SIZE, device=sm.dev)
    del params
    groups, prefill = [], eng._prefill

    def recording(tokens, vision, last_idx):
        out = prefill(tokens, vision, last_idx)
        groups.append((tokens.clone(), None if vision is None
                       else vision.clone(), last_idx.clone()))
        return out
    eng._prefill = recording
    req = cs.requests(cfg, [(729, 1, None)], seed=0)[0]
    req.max_new_tokens = 2
    eng.submit(req)
    with eng:
        eng.run()
    eng._prefill = prefill
    return eng, groups[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs         # puts this checkout's src/ on the path
    sys.path.insert(0, os.path.abspath(a.src))   # ... behind the tree timed
    import torch
    if not torch.cuda.is_available():
        print("fp32_prefill_times: no CUDA device visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.dequant_gemm import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.fused_decode import kernel as K
    from repro_torch.kernels.linear_attention import kernel as LK
    libs = (K, FK, LK, DK)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all({m.LIBRARY: m.SOURCES for m in libs})
    for m in libs:
        m.library()

    sm = cs.Smoke()
    llava = get_config("llava-onevision-0.5b")
    out = {"label": a.label, "package": os.path.dirname(repro_torch.__file__),
           "device": torch.cuda.get_device_name(0)}
    out["gemm"] = cs.time_gemm_shapes(sm, (llava,), torch.float32)
    la = {}
    for dtype in (torch.bfloat16, torch.float32):
        t_k, t_p, byt, fl, phases = cs.time_linear(sm, dtype)
        la[str(dtype).replace("torch.", "")] = {
            "ms": cs.dev_or_call(t_k), "event_ms": t_k[1],
            "device_kernels_per_call": t_k[2], "phases_ms": phases,
            "plain_ms": cs.dev_or_call(t_p), "bytes": byt, "flops": fl}
    out["linear_attention"] = dict(la, shape=list(cs.LA_SHAPE))
    cs.free()
    out["prefill"] = {}
    for name, cfg, kernels in (
            ("llava_fp32_flash", dataclasses.replace(
                llava, dtype="float32", attn_q_chunk=0),
             ("dequant_gemm", "flash_attention")),
            ("llava_linear_fp32", dataclasses.replace(
                llava, dtype="float32", attn_impl="linear",
                subquadratic=True), ("dequant_gemm", "la_"))):
        eng, group = prefill_group(sm, cfg)
        out["prefill"][name] = cs.prefill_breakdown(eng, group, kernels)
        del eng, group
        cs.free()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
