"""The SSD backward's plain version and the SSD autograd Function, on the
CPU.

Inputs drawn with numpy like ``tests/test_torch_ssd.py``: dt =
softplus(normal), A = -exp(0.5 normal), B and C = 0.3 normal, dy normal
and dh normal (the gradient of h_final; the training path discards
h_final, so its gradient may also be None).

- ``ref_ssd_backward`` against ``jax.vjp`` of the reference's
  ``ssd_chunked`` at G 1 and 2, several chunks, S at and under the chunk,
  with and without dh: every gradient (dx, ddt, dA, dB, dC) within 1e-5
  of its largest magnitude in fp32 and 3e-2 in bf16 (x, B, C, dy and the
  bf16 gradients rounded to bf16 after fp32 arithmetic in both packages,
  in different orders);
- against torch autograd of the port's own ``ref_ssd_chunked`` (fp32,
  1e-5; float64 inputs kept in float64, 1e-12);
- ``ssd`` under grad on CPU tensors goes through the ``SSD`` Function and
  its gradients are autograd's of ``ref_ssd_chunked``;
- the Function's card branch, its launchers swapped for the plain
  versions (the kernels run only on the card): one ``ssd`` and one
  ``ssd/bwd`` launch a call, under their routes, and the same gradients;
- ``emulate_ssd_bwd_mma``, the backward kernel's arithmetic on its two
  routes (bf16 "mma", fp32 "tf32x3"), against ``jax.vjp`` at the same
  cases and GRAD_TOL, and at every head slice of a group of four;
- ``kernel.bwd_slice``, the heads a block of the backward sums over.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as ref_ssd_chunked_jax
from repro_torch import bridge
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import (emulate_ssd_bwd_mma, ref_ssd_backward,
                                        ref_ssd_chunked)

GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(shape, dtype, seed=0):
    """numpy x, dt, A, Bm, Cm, dy, dh of ``shape`` (B, S, H, P, G, N); x,
    B, C and dy cast to ``dtype`` in numpy."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    cast = np.dtype(jnp.dtype(dtype))

    def normal(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    x = normal(B, S, H, P).astype(cast)
    dt = np.log1p(np.exp(normal(B, S, H))).astype(np.float32)
    A = (-np.exp(normal(H) * 0.5)).astype(np.float32)
    Bm = normal(B, S, G, N, scale=0.3).astype(cast)
    Cm = normal(B, S, G, N, scale=0.3).astype(cast)
    dy = normal(B, S, H, P).astype(cast)
    dh = normal(B, H, P, N)
    return x, dt, A, Bm, Cm, dy, dh


def _torch(*arrays):
    return [bridge.array_to_tensor(a, device="cpu") for a in arrays]


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    return float(np.abs(want - got).max() / np.abs(want).max())


VJP_CASES = [((2, 64, 4, 16, 1, 8), 32, True),      # two chunks, G 1
             ((1, 32, 4, 8, 2, 16), 32, True),      # S at the chunk, G 2
             ((2, 20, 2, 8, 1, 8), 32, False)]      # S under the chunk, no dh


def _vjp_case(shape, chunk, with_dh, dtype, seed):
    """(jax.vjp's gradients as numpy, the torch inputs x .. dy, dh or
    None)."""
    x, dt, A, Bm, Cm, dy, dh = _inputs(shape, dtype, seed=seed)
    _, vjp = jax.vjp(lambda *a: ref_ssd_chunked_jax(*a, chunk=chunk),
                     *map(jnp.asarray, (x, dt, A, Bm, Cm)))
    # numpy now: torch's CPU arithmetic runs after XLA's has finished
    want = [np.asarray(w) for w in vjp((
        jnp.asarray(dy), jnp.asarray(dh) if with_dh
        else jnp.zeros(dh.shape, jnp.float32)))]
    return want, _torch(x, dt, A, Bm, Cm, dy), (_torch(dh)[0] if with_dh
                                                  else None)


def _hold(want, got, args, dtype):
    for name, w, g, a in zip(NAMES, want, got, args):
        assert g.dtype == a.dtype and tuple(g.shape) == tuple(a.shape)
        assert _rel(w, g) <= GRAD_TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,chunk,with_dh", VJP_CASES)
def test_plain_backward_matches_reference_vjp(shape, chunk, with_dh, dtype):
    want, args, dh = _vjp_case(shape, chunk, with_dh, dtype, sum(shape))
    _hold(want, ref_ssd_backward(*args, dh, chunk=chunk), args, dtype)


ROUTES = [("float32", "tf32x3"), ("bfloat16", "mma")]


@pytest.mark.parametrize("dtype,route", ROUTES)
@pytest.mark.parametrize("shape,chunk,with_dh", VJP_CASES)
def test_backward_emulation_matches_reference_vjp(shape, chunk, with_dh,
                                                  dtype, route):
    """The backward kernel's arithmetic on its route (split planes, the
    products summed tile by tile, the head slices in order) within the
    plain version's GRAD_TOL of the reference's ``jax.vjp``."""
    want, args, dh = _vjp_case(shape, chunk, with_dh, dtype, sum(shape))
    _hold(want, emulate_ssd_bwd_mma(*args, dh, chunk=chunk, route=route),
          args, dtype)


@pytest.mark.parametrize("dtype,route", ROUTES)
@pytest.mark.parametrize("heads_a_slice", [1, 2, 4])
def test_backward_emulation_at_every_head_slice(heads_a_slice, dtype,
                                                route):
    """G 2 with four heads a group and three 64-position tiles a chunk
    (the last ragged): each slicing of the group's heads, its slices
    added in order, against the float64 backward within GRAD_TOL of each
    gradient's largest or, where the plain version is not (dA sums
    terms that cancel: 1.7e-5 in fp32 here), no worse than it."""
    x, dt, A, Bm, Cm, dy, dh = _inputs((1, 160, 8, 8, 2, 16), dtype,
                                       seed=heads_a_slice)
    args, dh = _torch(x, dt, A, Bm, Cm, dy), _torch(dh)[0]
    exact = ref_ssd_backward(*(t.double() for t in args), dh.double(),
                             chunk=160)
    plain = ref_ssd_backward(*args, dh, chunk=160)
    got = emulate_ssd_bwd_mma(*args, dh, chunk=160, route=route,
                              heads_a_slice=heads_a_slice)
    for name, x64, p, g in zip(NAMES, exact, plain, got):
        assert g.dtype == p.dtype and g.shape == p.shape
        err = _rel(x64.numpy(), g)
        assert err <= max(GRAD_TOL[dtype], _rel(x64.numpy(), p)), name


@pytest.mark.parametrize("case,want", [
    ((4, 2048, 64, 1, 256), 16),     # Mamba-2-1.3B training: 128 tiles
    ((2, 1024, 128, 1, 256), 8),     # Jamba's Mamba-2: 32 tiles
    ((2, 200, 8, 1, 256), 1),        # 8 tiles: one head a slice
    ((2, 512, 8, 2, 128), 1),        # 32 tiles
    ((1, 8192, 64, 1, 256), 16)])    # 128 tiles
def test_bwd_slice_fills_the_card(case, want):
    B, S, H, G, chunk = case
    hs = K.bwd_slice(*case)
    assert hs == want and (H // G) % hs == 0
    L = min(chunk, S)
    blocks = B * G * (S // L) * -(-L // 64) * (H // G // hs)
    assert blocks >= K.BWD_BLOCKS or hs == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_backward_matches_autograd_of_the_plain_forward(dtype):
    x, dt, A, Bm, Cm, dy, dh = (torch.from_numpy(a).to(dtype) for a in
                                _inputs((2, 96, 4, 8, 2, 16), "float32",
                                        seed=4))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y, h = ref_ssd_chunked(*leaves, chunk=32)
    want = torch.autograd.grad((y, h), leaves, (dy, dh))
    got = ref_ssd_backward(x, dt, A, Bm, Cm, dy, dh, chunk=32)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for name, w, g in zip(NAMES, want, got):
        assert g.dtype == dtype
        assert _rel(w.numpy(), g) <= tol, name


def _leaves(shape, dtype, seed=1):
    x, dt, A, Bm, Cm, dy, _ = _inputs(shape, dtype, seed=seed)
    return ([t.requires_grad_(True) for t in _torch(x, dt, A, Bm, Cm)],
            _torch(dy)[0])


def test_ssd_under_grad_on_cpu_is_the_function():
    """CPU tensors that require grad go through ``SSD`` (plain forward,
    ``ref_ssd_backward``), count no launch, and give autograd's gradients
    of the plain forward; only y is used (h_final's gradient is None)."""
    leaves, dy = _leaves((2, 64, 4, 8, 1, 16), "float32")
    reset_launch_counts()
    y, h = ops.ssd(*leaves, chunk=32)
    assert type(y.grad_fn).__name__ == "SSDBackward"
    got = torch.autograd.grad(y, leaves, dy)
    assert not any(launch_counts().values())
    want = torch.autograd.grad(ref_ssd_chunked(*leaves, chunk=32)[0], leaves,
                               dy)
    for name, w, g in zip(NAMES, want, got):
        assert _rel(w.numpy(), g) <= 1e-5, name
    with torch.no_grad():
        y2, _ = ops.ssd(*leaves, chunk=32)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_function_wires_forward_and_backward(monkeypatch, dtype):
    """The card branch with its launchers swapped for the plain versions:
    the forward hands its states to the backward, one launch of each is
    counted under the dtype's routes, and the gradients are
    ``ref_ssd_backward``'s."""
    saved = {}

    def forward(x, dt, A, Bm, Cm, *, chunk, want_states=False):
        assert want_states
        y, h = ref_ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
        saved["states"] = torch.full((1,), 7.0)
        return y, h, saved["states"]

    def backward(x, dt, A, Bm, Cm, states, dy, dh=None, *, chunk):
        assert states is saved["states"] and dh is None
        return ref_ssd_backward(x, dt, A, Bm, Cm, dy, dh, chunk=chunk)
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(K, "launch_ssd", forward)
    monkeypatch.setattr(K, "launch_ssd_backward", backward)
    leaves, dy = _leaves((1, 64, 4, 8, 2, 16), dtype)
    reset_launch_counts()
    y, _ = ops.ssd(*leaves, chunk=32)
    got = torch.autograd.grad(y, leaves, dy)
    counts = {n: c for n, c in launch_counts().items() if c}
    tdt = getattr(torch, dtype)
    assert counts == {"ssd": 1, f"ssd/{K.route(tdt)}": 1, "ssd/bwd": 1,
                      f"ssd/{K.bwd_route(tdt)}": 1}
    want = ref_ssd_backward(*(t.detach() for t in leaves), dy, chunk=32)
    for name, w, g in zip(NAMES, want, got):
        assert g.dtype == w.dtype and torch.equal(g, w), name
