#!/usr/bin/env python3
"""Where the packed-weight GEMM's time goes, on one NVIDIA GPU.

    python3 scripts/dequant_gemm_ablation.py [--fp32]

Builds versions of ``src/repro_torch/csrc/dequant_gemm.cu`` with nvcc
(the build flags of ``repro_torch.kernels.build``) into
``build/ablation/``, each leaving one part of the warp-specialised
kernel (``dequant_gemm_wgmma_kernel``, the one every served bf16 call
takes) out:

- ``kernel``: the source as it is;
- ``no_unpack``: the producer skips the unpack (the products read stale
  W tiles);
- ``no_staging``: no packed words (TMA) or scales (cp.async) are loaded
  (the unpack reads stale slots);
- ``no_products``: the consumers issue no wgmma.

Each runs through ``quant_einsum`` at served projection shapes (q4 g32,
bf16, Qwen2-VL-7B's and Mamba-2-1.3B's at a 2048-row prefill, LLaVA's
at 1024), timed with CUDA events, in turns (each version twice, in
order and then in reverse), beside ``torch.einsum`` on the weight
dequantized beforehand (cuBLAS).  The ablated versions compute nothing
useful: only their times are read.  Prints the card's name and power
limit, then one JSON line of milliseconds per call.

``--fp32`` ablates the tile kernel's split-TF32 shape instead
(``dequant_gemm/tf32x3``, every fp32 call; the edits reach the bf16 shape
too, which is not timed), in the plan its rule picks, at the fp32
serves' shapes (LLaVA-OneVision-0.5B's q, up/gate and down at 1024 rows,
Mamba-2-1.3B's in_proj at 2048), each time the profiler's device ms per
call (``chip_smoke.timed``):

- ``kernel``: the source as it is;
- ``no_unpack``: the W tiles are never unpacked (the products read stale
  ones);
- ``one_product``: only the hi.hi product of each split pair (a third of
  the tensor-core work, the same loads and splits);
- ``no_products``: no mma at all (the loads, the unpack and the splits'
  shared-memory reads stay).
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = (  # (name, einsum, x shape, weight shape)
    ("qwen2-vl up", "bsd,df->bsf", (1, 2048, 3584), (3584, 18944)),
    ("qwen2-vl down", "bsf,fd->bsd", (1, 2048, 18944), (18944, 3584)),
    ("qwen2-vl q", "bsd,dhk->bshk", (1, 2048, 3584), (3584, 28, 128)),
    ("mamba2 in_proj", "bsd,de->bse", (2, 1024, 2048), (2048, 8512)),
    ("llava up", "bsd,df->bsf", (1, 1024, 896), (896, 4864)))
UNPACK = ("      unpack_run<BITS, LAYOUT>(ws + st * kWTileBytes, staged + slot "
          "* S::kBytes, pt, sslot);\n")
STAGE_FIRST = "      if (s < n_steps) stage(s);\n"
STAGE_AHEAD = "      if (step + kPre - 1 < n_steps) stage(step + kPre - 1);\n"
PRODUCTS = ("      for (int kk = 0; kk < kWK / 16; ++kk) {\n"
            "        const uint64_t da0")


def variants(src):
    for needle in (UNPACK, STAGE_FIRST, STAGE_AHEAD, PRODUCTS):
        if src.count(needle) != 1:
            raise SystemExit(f"ablation: {needle.strip()!r} not found once in "
                             f"dequant_gemm.cu")
    no_words = ("if (pt == 0) hopper::mbar_arrive_expect_tx(&words[{} % kPre], "
                "0);\n")
    return {"kernel": src,
            "no_unpack": src.replace(UNPACK, ""),
            "no_staging": src.replace(
                STAGE_FIRST, "      if (s < n_steps && " + no_words.format("s")
                .replace("if (", "", 1)).replace(
                STAGE_AHEAD, "      if (step + kPre - 1 < n_steps && "
                + no_words.format("(step + kPre - 1)").replace("if (", "", 1)),
            "no_products": src.replace(
                PRODUCTS, PRODUCTS.replace("kk < kWK / 16", "kk < 0"))}


FP32_SHAPES = (  # (name, einsum, x shape, weight shape)
    ("llava q", "bsd,dhk->bshk", (1, 1024, 896), (896, 14, 64)),
    ("llava up", "bsd,df->bsf", (1, 1024, 896), (896, 4864)),
    ("llava down", "bsf,fd->bsd", (1, 1024, 4864), (4864, 896)),
    ("mamba2 in_proj", "bsd,de->bse", (2, 1024, 2048), (2048, 8512)))
TF_UNPACK_FIRST = ("  if (n_steps > 0) unpack<C, BITS, LAYOUT>(ws, ps, ss, p, map, "
                   "s0 * kBK, nw);\n")
TF_UNPACK_LOOP = ("    if (i + 1 < n_steps)                // the ALU work beside "
                  "the other warps' products\n")
TF_PRODUCTS = ("    for (int kk = 0; kk < C::kBK / 8; ++kk) {\n"
               "      // A: rows g")
TF_CROSS = ("          hopper::mma_tf32(d[mi][ni], al[mi], bh.x, bh.y);\n"
            "          hopper::mma_tf32(d[mi][ni], ah[mi], bl.x, bl.y);\n")


def variants_fp32(src):
    for needle in (TF_UNPACK_FIRST, TF_UNPACK_LOOP, TF_PRODUCTS, TF_CROSS):
        if src.count(needle) != 1:
            raise SystemExit(f"ablation: {needle.strip()!r} not found once in "
                             f"dequant_gemm.cu")
    return {"kernel": src,
            "no_unpack": src.replace(TF_UNPACK_FIRST, "").replace(
                TF_UNPACK_LOOP, "    if (false)\n"),
            "one_product": src.replace(TF_CROSS, ""),
            "no_products": src.replace(
                TF_PRODUCTS, TF_PRODUCTS.replace("kk < C::kBK / 8", "kk < 0"))}


def build(srcs):
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, nvcc_path
    out_dir = os.path.join(ROOT, "build", "ablation")
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
        lib.rt_dequant_gemm.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 15
                                        + [ctypes.c_void_p])
        lib.rt_dequant_gemm.restype = ctypes.c_int
        lib.rt_dequant_gemm_tf32.argtypes = ([ctypes.c_void_p] * 6
                                             + [ctypes.c_int] * 16
                                             + [ctypes.c_void_p])
        lib.rt_dequant_gemm_tf32.restype = ctypes.c_int
        lib.rt_dequant_gemm_wgmma.argtypes = ([ctypes.c_void_p] * 5
                                              + [ctypes.c_int] * 10
                                              + [ctypes.c_void_p])
        lib.rt_dequant_gemm_wgmma.restype = ctypes.c_int
        lib._typed = True
        libs[name] = lib
    return libs


def per_call_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablation: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.core.quantize import QuantSpec, dequantize, quantize
    from repro_torch.kernels.dequant_gemm import kernel as DK
    from repro_torch.kernels.dequant_gemm import quant_einsum
    fp32 = "--fp32" in sys.argv[1:]
    dtype = torch.float32 if fp32 else torch.bfloat16
    shapes = FP32_SHAPES if fp32 else SHAPES
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "dequant_gemm.cu")) as f:
        libs = build((variants_fp32 if fp32 else variants)(f.read()))
    if fp32:                            # the profiler's device ms a call
        sys.path.insert(0, ROOT)
        import chip_smoke

        def timing(fn):
            return chip_smoke.dev_or_call(chip_smoke.timed(
                lambda i: fn(), 1, iters=20))
    else:
        def timing(fn):
            return per_call_ms(torch, fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, spec, xs, ws in shapes:
        x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
        w = quantize((torch.randn(ws, generator=gen, device="cuda")
                      * ws[0] ** -0.5).to(dtype),
                     QuantSpec(4, group_size=32))
        cases.append((name, spec, x, w))
    times = {name: {v: [] for v in list(libs) + ["cublas_dense"]}
             for name, *_ in shapes}
    order = list(libs) + list(libs)[::-1]
    with torch.no_grad():
        for v in order:
            DK.library = lambda lib=libs[v]: lib
            for name, spec, x, w in cases:
                times[name][v].append(timing(
                    lambda: quant_einsum(spec, x, w)))
        for name, spec, x, w in cases:
            dense = dequantize(w)
            for _ in range(2):
                times[name]["cublas_dense"].append(timing(
                    lambda: torch.einsum(spec, x, dense)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ms_per_call": times,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
