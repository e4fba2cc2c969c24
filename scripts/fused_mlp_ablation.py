#!/usr/bin/env python3
"""Split the fused-MLP GEMV's time on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/fused_mlp_ablation.py

Builds ``csrc/fused_decode.cu`` three ways with ``nvcc`` into
``build/ablation/`` and runs each through the port's own wrapper
(``fused_mlp``, the same plan and scratch) at LLaVA-OneVision-0.5B's and
Qwen2-VL-7B's MLP widths, q4 group 32, bf16 and fp32, cohorts 1 and 4,
random weights from a seed rotated over weight sets so each call reads
device memory:

- ``as_is``: the kernel as committed;
- ``no_fma``: each thread's dequantize-and-multiply body replaced by one
  cheap use of the loaded words (the loads, the ring, the reductions and
  the epilogues stay): what the data movement and the structure cost;
- ``one_row``: the weights dequantized and summed for one cohort row,
  without the per-row FMAs: what the unpack costs.

Prints one JSON line per case with each stage's mean device microseconds
per launch (profiler events, stage 1 then stage 2 alternating).  The
variants' outputs are wrong by design; only their times are read.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
WIDTHS = {(896, 4864): 16, (3584, 18944): 3}   # (D, F): weight sets rotated


def variants(src: str):
    body = src.index("      if constexpr (BITS == 0) {\n"
                     "        const T* e = reinterpret_cast<const T*>(&v);")
    end = src.index("    hopper::cp_async_wait<0>();         // the ring is "
                    "refilled next pass")
    no_fma = src[:body] + (
        "      {\n"
        "        const float q = __uint_as_float((v.x ^ v.y ^ v.z ^ v.w) & "
        "0x3f800000u) * sring[r * (NS ? NS : 1)];\n"
        "#pragma unroll\n"
        "        for (int b = 0; b < R; ++b) acc[b][b] += hv[b] * q;\n"
        "      }\n    }\n") + src[end:]
    fma = ("              acc[b][wi * PW + j] = fmaf(hv[b], w0, "
           "acc[b][wi * PW + j]);\n"
           "              acc[b][wi * PW + j + 1] = fmaf(hv[b], w1, "
           "acc[b][wi * PW + j + 1]);")
    assert fma in src
    one_row = src.replace(fma, "              if (b == 0) {\n"
                          "                acc[0][wi * PW + j] += w0;\n"
                          "                acc[0][wi * PW + j + 1] += w1;\n"
                          "              }")
    return {"as_is": src, "no_fma": no_fma, "one_row": one_row}


def build(out_dir: str):
    from repro_torch.kernels import build as B
    src = open(os.path.join(B.CSRC, "fused_decode.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "hopper.cuh"), "w") as f:
        f.write(open(os.path.join(B.CSRC, "hopper.cuh")).read())
    procs = {}
    for name, text in variants(src).items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [B.nvcc_path(), *B.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rt_fused_mlp.argtypes = [p, i, i, i, i, i] + [p] * 11 + [i, i, p]
        lib.rt_fused_mlp.restype = i
        libs[name] = lib
    return libs


def stage_us(fn, iters=20):
    """Mean device microseconds of stage 1 and of stage 2 per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e.device_time_total for e in prof.events()
          if e.device_type.name == "CUDA" and "gemv_kernel" in e.name]
    return [sum(ev[k::2]) / len(ev[k::2]) for k in (0, 1)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fused_mlp_ablation: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.core.quantize import QuantSpec, quantize
    from repro_torch.kernels.fused_decode import fused_mlp
    from repro_torch.kernels.fused_decode import kernel as K
    libs = build(os.path.join(ROOT, "build", "ablation"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (D, F), n_rot in WIDTHS.items():
        for dtype in (torch.bfloat16, torch.float32):
            spec = QuantSpec(4, group_size=32)
            sets = [[quantize((torch.randn(a, b, generator=gen, device="cuda")
                               / a ** 0.5).to(dtype), spec)
                     for a, b in ((D, F), (F, D), (D, F))]
                    for _ in range(n_rot)]
            for bc in (1, 4):
                h = torch.randn((bc, 1, D), generator=gen,
                                device="cuda").to(dtype)
                for name, lib in libs.items():
                    K.library = lambda lib=lib: lib
                    calls = iter(range(10 ** 9))

                    def call():
                        return fused_mlp(h, *sets[next(calls) % n_rot],
                                         act="swiglu")
                    s1, s2 = stage_us(call)
                    print(json.dumps({"D": D, "F": F, "dtype": str(dtype)[6:],
                                      "bc": bc, "variant": name,
                                      "stage1_us": s1, "stage2_us": s2}),
                          flush=True)
            del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
