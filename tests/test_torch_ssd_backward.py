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
  ``ssd/bwd`` launch a call, under their routes, and the same gradients.
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
from repro_torch.kernels.ssd.ref import ref_ssd_backward, ref_ssd_chunked

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,chunk,with_dh", [
    ((2, 64, 4, 16, 1, 8), 32, True),       # two chunks, G 1
    ((1, 32, 4, 8, 2, 16), 32, True),       # S at the chunk, G 2
    ((2, 20, 2, 8, 1, 8), 32, False)])      # S under the chunk, no dh
def test_plain_backward_matches_reference_vjp(shape, chunk, with_dh, dtype):
    x, dt, A, Bm, Cm, dy, dh = _inputs(shape, dtype, seed=sum(shape))
    _, vjp = jax.vjp(lambda *a: ref_ssd_chunked_jax(*a, chunk=chunk),
                     *map(jnp.asarray, (x, dt, A, Bm, Cm)))
    # numpy now: torch's CPU arithmetic runs after XLA's has finished
    want = [np.asarray(w) for w in vjp((
        jnp.asarray(dy), jnp.asarray(dh) if with_dh
        else jnp.zeros(dh.shape, jnp.float32)))]
    args = _torch(x, dt, A, Bm, Cm, dy)
    got = ref_ssd_backward(*args, _torch(dh)[0] if with_dh else None,
                           chunk=chunk)
    for name, w, g, a in zip(NAMES, want, got, args):
        assert g.dtype == a.dtype and tuple(g.shape) == tuple(a.shape)
        assert _rel(w, g) <= GRAD_TOL[dtype], name


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
