#!/usr/bin/env python3
"""Float64 readings of the split-TF32 packed-weight GEMM's card tests.

    python3 scripts/tf32x3_f64_readings.py

Runs the ``tf32x3_gemm`` tests of ``tests/test_torch_cuda_kernels.py`` on
one NVIDIA GPU with their float64 floor (``SPLIT_FLOOR``) lifted, and
records each error pair the tests compute: the kernel's and the plain
version's (``dequantize`` + fp32 ``torch.matmul``) distance from the
float64 product over its largest magnitude.  Prints one JSON line: the
pytest exit code, the number of pairs, the largest kernel reading, the
largest where the kernel reads more than 2x plain (the case the floor
decides) and every such pair.  The floor is set just above that reading.
Exits 2 without a GPU.
"""
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]


def main() -> int:
    import pytest
    import torch
    if not torch.cuda.is_available():
        print("tf32x3_f64_readings: no CUDA device visible", file=sys.stderr)
        return 2
    errs, current = [], {"id": None}

    class Record:
        def pytest_collection_finish(self, session):
            T = sys.modules["test_torch_cuda_kernels"]
            T.SPLIT_FLOOR = math.inf
            f64_err = T._f64_gemm_err

            def recording(got, x, w_kn):
                e = f64_err(got, x, w_kn)
                errs.append((current["id"], e))
                return e
            T._f64_gemm_err = recording

        def pytest_runtest_setup(self, item):
            current["id"] = item.nodeid.split("::")[-1]

    rc = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                      "-k", "tf32x3_gemm", os.path.join(
                          ROOT, "tests", "test_torch_cuda_kernels.py")],
                     plugins=[Record()])
    # each test computes the kernel's error, then the plain version's
    pairs = [(errs[i][0], errs[i][1], errs[i + 1][1])
             for i in range(0, len(errs) - 1, 2)]
    over = sorted((p for p in pairs if p[1] > 2 * p[2]),
                  key=lambda p: -p[1])
    print(json.dumps({
        "pytest_rc": int(rc), "pairs": len(pairs),
        "max_kernel": max((p[1] for p in pairs), default=None),
        "max_kernel_over_2x_plain": over[0][1] if over else None,
        "over_2x_plain": over}))
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
