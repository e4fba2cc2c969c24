#!/usr/bin/env python3
"""Measure the tensor cores' rate through warp-level mma.sync on one NVIDIA GPU.

    python3 scripts/mma_sync_rate.py

The port's fp32 kernels (the split-TF32 flash, packed-weight GEMM and
linear-attention kernels) run their products as mma.sync m16n8k8 TF32, and
the bf16 tile kernels as m16n8k16 bf16.  The card's published dense rates
(495 TFLOP/s TF32, 989 bf16) are wgmma's; this script measures what
mma.sync itself sustains, the ceiling those kernels' products can reach:
every SM runs 4 blocks of 8 warps, each warp 8 independent accumulator
chains of mma.sync in a loop (no loads, no other work), timed by CUDA events
over 5 launches after a warm-up.  The source is compiled with nvcc into
``build/mma_sync_rate/`` at run time.  Prints one JSON line: TFLOP/s by
instruction, with the card's name.  Exits 2 without a GPU.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// 8 independent chains of `iters` mma.sync each; kind 0: m16n8k8 tf32,
// kind 1: m16n8k16 bf16 (fp32 accumulate both)
template <int KIND>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
  float d[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  const uint32_t a0 = __float_as_uint(1.f + threadIdx.x * 1e-3f), a1 = a0 ^ 0x2000u;
  const uint32_t b0 = __float_as_uint(1.f - threadIdx.x * 1e-3f), b1 = b0 ^ 0x2000u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a0), "r"(a1), "r"(a0), "r"(a1), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a0), "r"(a1), "r"(a0), "r"(a1), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(void* out, int blocks, int iters, int kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) mma_loop<0><<<blocks, 256, 0, s>>>(static_cast<float*>(out), iters);
  else mma_loop<1><<<blocks, 256, 0, s>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
"""

# (instruction, kind, flop of one warp-level mma)
KINDS = (("mma.sync m16n8k8 tf32", 0, 2 * 16 * 8 * 8),
         ("mma.sync m16n8k16 bf16", 1, 2 * 16 * 8 * 16))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_sync_rate: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import ARCH_FLAGS, nvcc_path
    out_dir = os.path.join(ROOT, "build", "mma_sync_rate")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, n) for n in ("rate.cu", "librate.so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc_path(), *ARCH_FLAGS, "-O3", "-shared", "-Xcompiler",
                    "-fPIC", "-o", lib, src], check=True)
    fn = ctypes.CDLL(lib).run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, kind, flop in KINDS:
        if fn(out.data_ptr(), blocks, 16, kind, stream):
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn(out.data_ptr(), blocks, iters, kind, stream)
        stop.record()
        torch.cuda.synchronize()
        seconds = start.elapsed_time(stop) / 1e3 / 5
        mmas = blocks * 8 * 8 * iters          # warps x chains x steps
        rates[name] = mmas * flop / seconds / 1e12
    print(json.dumps({"mma_sync_tflops": rates, "sms": sms,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
