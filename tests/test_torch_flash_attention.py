"""The port's flash attention against the reference's, on the CPU.

On CPU tensors ``flash_attention`` runs its plain version (the kernel
runs only on the card; ``test_torch_cuda_kernels.py`` holds it against
this plain version there).  Here the plain version meets the reference's
``ref_attention`` (jitted) on the same numpy inputs at the reference
kernel tests' shapes, at head dim 128 with GQA 7 (Qwen2-VL's 28/4, fewer
heads), and at a cross-attention shape (Sq != Sk).  It also meets the
reference's ``flash_attention`` in interpret mode (bq = bk = 64) at one
shape per dtype, since an interpret-mode compile costs about a second:
fp32 at head dim 128 (causal, GQA 7), bf16 at the cross shape.  Tolerances are the
reference kernel tests': 1e-4 relative in fp32 (summation order only),
2e-2 in bf16 (one bf16 rounding of the probabilities at different
points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.flash_attention import ref_attention
from repro_torch import bridge
from repro_torch.kernels.flash_attention import flash_attention

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PALLAS_SHAPE = (1, 128, 14, 2, 128)     # fp32, causal
r_ref = jax.jit(ref_attention, static_argnames=("causal",))


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _inputs(B, Sq, Sk, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal(s).astype(np.float32).astype(
        jnp.dtype(dtype)))
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]
    return arrs, [bridge.array_to_tensor(np.asarray(a), device="cpu")
                  for a in arrs]


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("shape,causal", [
    ((2, 128, 4, 2, 32), True), ((1, 256, 8, 8, 64), True),
    ((2, 256, 6, 2, 32), True), ((1, 128, 32, 4, 16), True),
    ((1, 128, 14, 2, 128), True), ((1, 128, 14, 2, 128), False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference(shape, causal, dtype):
    B, S, H, KV, hd = shape
    (q, k, v), (tq, tk, tv) = _inputs(B, S, S, H, KV, hd, dtype, sum(shape))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and tuple(got.shape) == q.shape
    assert _rel_err(_f32(got), r_ref(q, k, v, causal=causal)) < TOL[dtype]
    if shape == PALLAS_SHAPE and causal and dtype == "float32":
        pallas = r_flash(q, k, v, causal=causal, bq=64, bk=64,
                         interpret=True)
        assert _rel_err(_f32(got), pallas) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cross_shape_matches_reference(dtype):
    """Sq != Sk, non-causal (the cross-attention shape)."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 64, 192, 4, 2, 32, dtype, 11)
    got = flash_attention(tq, tk, tv, causal=False)
    assert tuple(got.shape) == (1, 64, 4, 32)
    assert _rel_err(_f32(got), r_ref(q, k, v, causal=False)) < TOL[dtype]
    if dtype == "bfloat16":
        pallas = r_flash(q, k, v, causal=False, bq=64, bk=64,
                         interpret=True)
        assert _rel_err(_f32(got), pallas) < TOL[dtype]
