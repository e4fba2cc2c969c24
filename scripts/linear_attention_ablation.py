#!/usr/bin/env python3
"""Where the linear-attention kernel's time goes, on one NVIDIA GPU.

    python3 scripts/linear_attention_ablation.py

Builds versions of ``src/repro_torch/csrc/linear_attention.cu`` with nvcc
(the build flags of ``repro_torch.kernels.build``) into
``build/ablation_la/``, each leaving one part out:

- ``kernel``: the source as it is;
- ``no_products``: the state and output kernels issue no mma (the
  fragment loads, the splits and phi(q) stay);
- ``no_q_loads``: every lane reads one q element for all its fragments
  (the q traffic goes; phi and the splits stay);
- ``no_staging_loads``: the staging reads no k, v or S_before from
  device memory (constants instead; the phi, the splits and the shared
  stores stay);
- ``staging_only``: the output kernel returns once its block has staged
  phi(k), v and S_before;
- ``no_phi_q``: phi is not applied to q (the loads and splits stay);
- ``no_inter``: no phi(q) S_before products.

Each runs through ``linear_attention`` at ``chip_smoke.LA_SHAPE`` (B 2, S
1024, H 14, KV 2, hd 64, chunk 256) in bf16 and fp32, in turns (each
version twice, in order and then in reverse), timed by the profiler per
device kernel (``chip_smoke.device_time``).  The ablated versions compute
nothing useful: only their times are read.  Prints the card's name and
power limit, then one JSON line of milliseconds per call by device
kernel.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

PRODUCT = "mma_tf32(d, "
Q_LOAD = "qg[(long long)i_"
K_LOAD = "to_f32(__ldg(kg + j * k_ss + e))"
V_LOAD = "to_f32(__ldg(vg + j * v_ss + e))"
S_LOAD = "__ldg(sg + (long long)j * hd + e)"
STAGED = ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
          "  const int n_warps = blockDim.x >> 5, pair = blockIdx.z;\n")
PHI_Q = "p.hd ? phi(x["
INTER = "    if (before) {\n"


def variants(src):
    for needle, n in ((PRODUCT, 12), (Q_LOAD, 4), (K_LOAD, 1), (V_LOAD, 1),
                      (S_LOAD, 1), (STAGED, 1), (PHI_Q, 4), (INTER, 1)):
        if src.count(needle) != n:
            raise SystemExit(f"ablation: {needle!r} found "
                             f"{src.count(needle)} times, expected {n}")
    return {"kernel": src,
            "no_products": src.replace(PRODUCT, "if (false) " + PRODUCT),
            "no_q_loads": src.replace(Q_LOAD, "qg[0 * (long long)i_"),
            "no_staging_loads": src.replace(K_LOAD, "0.5f").replace(
                V_LOAD, "0.75f").replace(S_LOAD, "0.25f"),
            "staging_only": src.replace(STAGED, "  return;\n" + STAGED),
            "no_phi_q": src.replace(PHI_Q, "p.hd ? (x["),
            "no_inter": src.replace(INTER, "    if (false) {\n")}


def build(srcs):
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, nvcc_path
    out_dir = os.path.join(ROOT, "build", "ablation_la")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, text in srcs.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise SystemExit(f"ablation: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.rt_linear_attention.argtypes = ([ctypes.c_void_p] * 9
                                            + [ctypes.c_int] * 7
                                            + [ctypes.c_longlong] * 9
                                            + [ctypes.c_void_p])
        lib.rt_linear_attention.restype = ctypes.c_int
        lib._typed = True
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablation: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.linear_attention import kernel as LK
    from repro_torch.kernels.linear_attention import linear_attention
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "linear_attention.cu")) as f:
        libs = build(variants(f.read()))
    sm = cs.Smoke()
    B, S, H, KV, hd, chunk = cs.LA_SHAPE
    iters = 20
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = sm.la_inputs(B, S, H, KV, hd, dtype)
        rec = times[str(dtype).replace("torch.", "")] = {v: [] for v in libs}
        for v in list(libs) + list(libs)[::-1]:
            LK.library = lambda lib=libs[v]: lib

            def loop():
                for _ in range(iters):
                    linear_attention(*args, chunk=chunk)
                torch.cuda.synchronize()
            loop()
            _, rows, _ = cs.device_time(loop)
            rec[v].append({ph: sum(us for k, us, _ in rows if ph in k)
                           / iters / 1e3 for ph in cs.LA_PHASES})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ms_per_call_by_kernel": times,
                      "shape": list(cs.LA_SHAPE),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
