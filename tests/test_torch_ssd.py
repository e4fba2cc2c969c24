"""The port's SSD (Mamba-2 chunked scan) plain versions against the
reference's, on the CPU.

Inputs drawn with numpy like the reference kernel tests
(``tests/test_kernels.py``): dt = softplus(normal), A = -exp(0.5 normal),
B and C = 0.3 normal.  The wrapper ``kernels/ssd/ops.ssd`` on CPU tensors
(the plain chunked form) is held against the reference's sequential
oracle ``ref_ssd`` and its Pallas kernel in interpret mode at the
reference tests' three shapes and two chunks; the port's own sequential
oracle and one-token step against the reference's.

The arithmetic of the kernel's bf16 route (``emulate_ssd_mma``: the
hi/mid/lo split of ``split3``) is held against the reference the same
way.

fp32: within 1e-4 of the largest magnitude (the reference kernel tests'
bound).  bf16 inputs (x, B, C): y is rounded to bf16 after fp32
arithmetic in both packages, in different summation orders, so it may
differ by one bf16 step of its largest magnitude; the fp32 state keeps
1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32
from repro.kernels.ssd import ref_ssd, ssd as ref_kernel_ssd
from repro.models.mamba2 import ssd_decode_step as ref_decode_step
from repro_torch import bridge
from repro_torch.kernels import launch_counts
from repro_torch.kernels.ssd import ref_ssd as port_ref_ssd
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ref import emulate_ssd_mma, split3
from repro_torch.models.mamba2 import ssd_decode_step

SHAPES = [(2, 128, 4, 32, 1, 32), (1, 256, 8, 64, 2, 64),
          (2, 64, 4, 16, 4, 16)]          # (B, S, H, P, G, N)


def _inputs(shape, dtype, seed=0):
    """numpy inputs of ``shape``; x, B, C cast to ``dtype`` in numpy."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    cast = np.dtype(jnp.dtype(dtype))
    x = rng.standard_normal((B, S, H, P)).astype(np.float32).astype(cast)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32).astype(
        cast)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32).astype(
        cast)
    return x, dt, A, Bm, Cm


def _torch(*arrays):
    return [bridge.array_to_tensor(a, device="cpu") for a in arrays]


def _rel_err(want, got):
    want, got = f32(want), f32(got)
    return float(np.abs(want - got).max() / np.abs(want).max())


def _check_y(want, got, dtype):
    want, got = f32(want), f32(got)
    m = float(np.abs(want).max())
    tol = 1e-4 * m if dtype == "float32" else 2.0 ** (np.floor(np.log2(m))
                                                        - 7)
    assert float(np.abs(want - got).max()) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_ssd_matches_reference(shape, chunk, dtype):
    """The wrapper's CPU path against ``ref_ssd`` and interpret-mode
    ``ssd_pallas``; no kernel launch is counted on the CPU."""
    arrs = _inputs(shape, dtype)
    before = launch_counts()["ssd"]
    y, h = ssd(*_torch(*arrs), chunk=chunk)
    assert launch_counts()["ssd"] == before
    assert y.dtype == bridge.array_to_tensor(arrs[0], device="cpu").dtype
    assert h.dtype == torch.float32
    jarrs = [jnp.asarray(a) for a in arrs]
    for ry, rh in (ref_ssd(*jarrs),
                   ref_kernel_ssd(*jarrs, chunk=chunk, interpret=True)):
        assert tuple(y.shape) == ry.shape and tuple(h.shape) == rh.shape
        _check_y(ry, y, dtype)
        assert _rel_err(rh, h) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequential_oracle_matches_reference(dtype):
    arrs = _inputs(SHAPES[2], dtype, seed=1)
    y, h = port_ref_ssd(*_torch(*arrs))
    ry, rh = ref_ssd(*[jnp.asarray(a) for a in arrs])
    _check_y(ry, y, dtype)
    assert _rel_err(rh, h) < 1e-4


def test_state_continuation_matches_reference():
    """The chunked final state continues through the one-token step (the
    prefill -> decode boundary) as the full sequential recurrence does,
    and each step matches the reference's ``ssd_decode_step``."""
    B, S, H, P, G, N = 1, 64, 2, 16, 1, 16
    x, dt, A, Bm, Cm = _inputs((B, S + 3, H, P, G, N), "float32", seed=2)
    tx, tdt, tA, tB, tC = _torch(x, dt, A, Bm, Cm)
    _, h = ssd(tx[:, :S], tdt[:, :S], tA, tB[:, :S], tC[:, :S], chunk=32)
    ry, _ = ref_ssd(*[jnp.asarray(a) for a in (x, dt, A, Bm, Cm)])
    rh = jnp.asarray(f32(h))
    for t in range(S, S + 3):
        y, h = ssd_decode_step(h, tx[:, t], tdt[:, t], tA, tB[:, t], tC[:, t])
        ry_t, rh = ref_decode_step(rh, x[:, t], dt[:, t], A, Bm[:, t],
                                   Cm[:, t])
        assert _rel_err(ry[:, t], y) < 1e-4
        assert _rel_err(ry_t, y) < 1e-4
        assert _rel_err(rh, h) < 1e-4


def test_zero_dt_tail_leaves_the_state_unchanged():
    """dt = 0 past a position: the final state equals the state at that
    position (the engine's right-padding repair rests on this), and
    chunks that are padding throughout change nothing."""
    x, dt, A, Bm, Cm = _inputs((2, 128, 4, 16, 2, 16), "float32", seed=3)
    dt[:, 40:] = 0.0
    _, h_pad = ssd(*_torch(x, dt, A, Bm, Cm), chunk=32)
    _, h_cut = ssd(*_torch(x[:, :64], dt[:, :64], A, Bm[:, :64],
                           Cm[:, :64]), chunk=32)
    assert torch.equal(h_pad, h_cut)
    _, rh = ref_ssd(*[jnp.asarray(a[:, :40]) for a in (x, dt)],
                    jnp.asarray(A), *[jnp.asarray(a[:, :40])
                                      for a in (Bm, Cm)])
    assert _rel_err(rh, h_pad) < 1e-4


def test_ssd_refuses_a_ragged_chunk_and_unknown_devices():
    x, dt, A, Bm, Cm = _torch(*_inputs((1, 48, 2, 16, 1, 16), "float32"))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="unsupported device"):
        ssd(*(t.to("meta") for t in (x, dt, A, Bm, Cm)), chunk=16)


def _recurrence_f64(x, dt, A, Bm, Cm):
    """(y, h_final) of the sequential recurrence in float64 (numpy)."""
    B, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = np.repeat(Bm.astype(np.float64), rep, axis=2)
    Ch = np.repeat(Cm.astype(np.float64), rep, axis=2)
    dt, x = dt.astype(np.float64), x.astype(np.float64)
    a = np.exp(dt * A.astype(np.float64))
    h = np.zeros((B, H, P, Bm.shape[3]))
    ys = []
    for t in range(S):
        h = (a[:, t, :, None, None] * h + dt[:, t, :, None, None]
             * x[:, t, :, :, None] * Bh[:, t, :, None, :])
        ys.append(np.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return np.stack(ys, axis=1), h


def test_plain_ssd_state_at_mamba2_decay_rates():
    """Mamba-2's own decay rates (A = -linspace(1, 16), as ``init_mamba``
    sets them) and dt up to ~5 over 256-position chunks: the within-chunk
    log-decay sums reach thousands, where exp(cum_last - cum_j) taken as
    a difference of two prefix sums cancels.  The chunk states sum the
    exponent from the chunk's end, so h_final stays within 1e-6 of a
    float64 recurrence's largest magnitude."""
    x, dt, _, Bm, Cm = _inputs((2, 512, 16, 8, 1, 16), "float32", seed=5)
    rng = np.random.default_rng(6)
    dt = np.log1p(np.exp(rng.standard_normal(dt.shape) + 1.0)).astype(
        np.float32)
    A = (-np.linspace(1.0, 16.0, 16)).astype(np.float32)
    _, h = ssd(*_torch(x, dt, A, Bm, Cm), chunk=256)
    want = _recurrence_f64(x, dt, A, Bm, Cm)[1]
    err = float(np.abs(h.double().numpy() - want).max())
    assert err <= 1e-6 * float(np.abs(want).max()), err


def test_plain_ssd_evaluates_float64_inputs_in_float64():
    """Float64 inputs keep float64 arithmetic and outputs (the evaluation
    the card's checks hold the fp32 kernel and plain version against):
    y and h_final within 1e-12 of a float64 recurrence's largest
    magnitude, at Mamba-2's decay rates over two 256-position chunks."""
    x, dt, _, Bm, Cm = _inputs((1, 512, 8, 8, 1, 16), "float32", seed=7)
    A = (-np.linspace(1.0, 16.0, 8)).astype(np.float32)
    args = [torch.from_numpy(a.astype(np.float64)) for a in (x, dt, A, Bm,
                                                             Cm)]
    y, h = ssd(*args, chunk=256)
    assert y.dtype == h.dtype == torch.float64
    wy, wh = _recurrence_f64(x, dt, A, Bm, Cm)
    for got, want in ((y, wy), (h, wh)):
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-12 * float(np.abs(want).max()), err


# -- the kernel's bf16 ("mma") route in plain PyTorch ---------------------------

def _split_exact(v):
    hi, mid, lo = split3(v)
    total = hi.double() + mid.double() + lo.double()
    return torch.equal(total, v.double())


def _above_the_floor(v):
    """The values split3 holds exactly: 0 and |v| >= 2^-110."""
    return v[(v == 0) | (v.abs() >= 2.0 ** -110)]


@pytest.mark.parametrize("scale", [1e-30, 1e-6, 1.0, 1e6, 1e30])
def test_split3_terms_sum_to_the_value(scale):
    """hi + mid + lo equals the fp32 value exactly, signs and magnitudes
    spread over each decade around ``scale`` (and zero), at or above
    2^-110."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    v = (rng.standard_normal(20000) * scale
         * np.exp(rng.uniform(-2.3, 2.3, 20000))).astype(np.float32)
    v[:3] = 0.0
    v = _above_the_floor(torch.from_numpy(v))
    assert v.numel() > 19000
    assert _split_exact(v)
    assert all(t.dtype == torch.bfloat16 for t in split3(v))


def test_split3_exact_on_the_served_operands():
    """The three fp32 operands the route splits, at Mamba-2's decay rates
    (A = -linspace(1, 16), dt up to ~5, 256-position chunks): the intra
    weights C.B^T exp(cum_i - cum_j) dt_j (down to exp of -thousands,
    where they flush), the state weights B dt exp(sum after j) and the
    states before each chunk."""
    x, dt, _, Bm, Cm = _inputs((1, 512, 8, 16, 1, 32), "float32", seed=12)
    rng = np.random.default_rng(13)
    dt = np.log1p(np.exp(rng.standard_normal(dt.shape) + 1.0)).astype(
        np.float32)
    A = (-np.linspace(1.0, 16.0, 8)).astype(np.float32)
    tx, tdt, tA, tB, tC = _torch(x, dt, A, Bm, Cm)
    L = 256
    la = (tdt * tA).reshape(1, 2, L, 8)
    cum = torch.cumsum(la.double(), 2)
    dec = torch.exp((cum[:, :, :, None] - cum[:, :, None, :]).float())
    cb = torch.einsum("bkin,bkjn->bkij", tC.reshape(1, 2, L, 32),
                      tB.reshape(1, 2, L, 32))
    w = torch.tril(cb[..., None] * dec.clamp(max=1.0)
                   * tdt.reshape(1, 2, L, 8)[:, :, None])
    after = torch.flip(torch.cumsum(torch.flip(la, [2]), 2), [2]) - la
    bw = tB.reshape(1, 2, L, 1, 32) * (tdt.reshape(1, 2, L, 8)
                                       * torch.exp(after))[..., None]
    _, h = ssd(tx, tdt, tA, tB, tC, chunk=L)
    for v in (w, bw, h):
        assert _split_exact(_above_the_floor(v.flatten()))


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_mma_route_emulation_matches_reference(shape, chunk):
    """The bf16 route's arithmetic (C.B^T once per group, the fp32
    operand of every other product split into three bf16 terms, each
    product summed in fp32) against ``ref_ssd`` and interpret-mode
    ``ssd_pallas`` on the reference tests' grid: h within 1e-4 of its
    largest value, y within one bf16 step of its largest magnitude."""
    arrs = _inputs(shape, "bfloat16", seed=4)
    y, h = emulate_ssd_mma(*_torch(*arrs), chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jarrs = [jnp.asarray(a) for a in arrs]
    for ry, rh in (ref_ssd(*jarrs),
                   ref_kernel_ssd(*jarrs, chunk=chunk, interpret=True)):
        assert tuple(y.shape) == ry.shape and tuple(h.shape) == rh.shape
        _check_y(ry, y, "bfloat16")
        assert _rel_err(rh, h) < 1e-4
