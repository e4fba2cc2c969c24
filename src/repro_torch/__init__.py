"""PyTorch / CUDA port of the reference package ``repro``, for NVIDIA
Hopper.  It imports no JAX and nothing of ``repro``; its kernels are
hand-written CUDA C++ (``csrc/``), built at first use."""
