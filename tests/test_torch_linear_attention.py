"""The port's streaming linear attention (phi = elu + 1) against the
reference's, on the CPU.

Inputs drawn with numpy like the reference kernel tests
(``tests/test_kernels.py``): q, k = 0.5 normal, v = normal.  The wrapper
``kernels/linear_attention/ops.linear_attention`` on CPU tensors (the
plain chunked form) is held against the reference's sequential oracle
``ref_linear_attention`` and its Pallas kernel in interpret mode at the
reference tests' shapes, chunks and tolerances (out, state and z within
1e-4 of the largest magnitude in fp32, 1e-2 in bf16).  Beside that: GQA
by kv-head index against the reference's ``jnp.repeat``; ``valid_len``
(padded rows drop out of the state and read zero); the prefill state
continued by the one-token decode against one long recurrence.  The
kernel's own arithmetic (``ref.emulate_linear_attention_tf32x3``: 64-row
tiles, split TF32 products of two or three terms) meets the same
references with GQA and a ragged chunk, and against a float64 evaluation
stays within 2x the plain chunked form's error in fp32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32
from repro.kernels.linear_attention import linear_attention as ref_kernel
from repro.kernels.linear_attention import ref_linear_attention
from repro.models import linear_attention as RL
from repro_torch import bridge
from repro_torch.kernels import launch_counts
from repro_torch.kernels.linear_attention import (linear_attention,
                                                  ref_linear_attention as
                                                  port_ref_sequential)
from repro_torch.models import linear_attention as TL

SHAPES = [(2, 128, 4, 32), (1, 256, 2, 64), (3, 64, 5, 16)]  # (B,S,H,hd)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _inputs(shape, dtype, kv=None, seed=0):
    """numpy q (B,S,H,hd), k/v (B,S,KV,hd) cast to ``dtype`` in numpy."""
    B, S, H, hd = shape
    KV = H if kv is None else kv
    rng = np.random.default_rng(seed)
    cast = np.dtype(jnp.dtype(dtype))

    def draw(heads, scale):
        return (rng.standard_normal((B, S, heads, hd)) * scale).astype(
            np.float32).astype(cast)
    return draw(H, 0.5), draw(KV, 0.5), draw(KV, 1.0)


def _torch(*arrays):
    return [bridge.array_to_tensor(a, device="cpu") for a in arrays]


def _rel_err(want, got):
    want, got = f32(want), f32(got)
    return float(np.abs(want - got).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_linear_attention_matches_reference(shape, chunk, dtype):
    """The wrapper's CPU path against ``ref_linear_attention`` and
    interpret-mode ``linear_attention_pallas``; no kernel launch is
    counted on the CPU."""
    arrs = _inputs(shape, dtype)
    before = launch_counts()["linear_attention"]
    out, state, z = linear_attention(*_torch(*arrs), chunk=chunk)
    assert launch_counts()["linear_attention"] == before
    assert out.dtype == _torch(arrs[0])[0].dtype
    assert state.dtype == z.dtype == torch.float32
    jarrs = [jnp.asarray(a) for a in arrs]
    for want in (ref_linear_attention(*jarrs),
                 ref_kernel(*jarrs, chunk=chunk, interpret=True)):
        for w, g in zip(want, (out, state, z)):
            assert tuple(g.shape) == w.shape
            assert _rel_err(w, g) < TOL[dtype]


@pytest.mark.parametrize("group", [2, 7])
def test_gqa_by_index_equals_the_repeat(group):
    """kv head h // G through indexing: bit for bit the port's own result
    on k/v repeated to every query head (same fp32 arithmetic), and the
    reference's ``linear_attn_prefill`` over ``jnp.repeat`` within 1e-4.
    The state and normalizer come back per query head."""
    B, S, KV, hd = 2, 64, 2, 16
    q, k, v = _inputs((B, S, KV * group, hd), "float32", kv=KV, seed=1)
    tq, tk, tv = _torch(q, k, v)
    got = linear_attention(tq, tk, tv, chunk=32)
    rep = linear_attention(tq, torch.repeat_interleave(tk, group, dim=2),
                           torch.repeat_interleave(tv, group, dim=2),
                           chunk=32)
    for g, r in zip(got, rep):
        assert torch.equal(g, r)
    want = RL.linear_attn_prefill(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), group, axis=2),
        jnp.repeat(jnp.asarray(v), group, axis=2), chunk=32)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and _rel_err(w, g) < 1e-4


@pytest.mark.parametrize("S,chunk,lens", [(128, 256, (100, 37)),
                                          (512, 256, (300, 512)),
                                          (127, 256, (64, 1))])
def test_valid_len_drops_the_padding(S, chunk, lens):
    """Rows at or past valid_len (filled with noise, not zeros) add
    nothing: each row's (state, z) equals the unpadded prompt's within
    1e-6 of its largest magnitude, its output rows before valid_len
    within 1e-6, and its padded output rows are exactly zero.  The
    unpadded prompt runs in chunks of its largest divisor up to 256."""
    q, k, v = _torch(*_inputs((len(lens), S, 4, 16), "float32", kv=2,
                              seed=2))
    out, state, z = linear_attention(q, k, v, chunk=chunk,
                                     valid_len=torch.tensor(lens))
    for b, n in enumerate(lens):
        unpadded_chunk = max(c for c in range(1, 257) if n % c == 0)
        wo, ws, wz = linear_attention(q[b:b + 1, :n], k[b:b + 1, :n],
                                      v[b:b + 1, :n], chunk=unpadded_chunk)
        for w, g in ((ws, state[b:b + 1]), (wz, z[b:b + 1]),
                     (wo, out[b:b + 1, :n])):
            assert float((w - g).abs().max()) <= 1e-6 * float(
                w.abs().max())
        assert not out[b, n:].any()


def test_stream_continuation():
    """The prefill's final state continued by the one-token decode (the
    prefill -> decode boundary) equals one long recurrence, and each step
    matches the reference's ``linear_attn_decode`` from the same state
    (after ``tests/test_kernels.py``'s continuation test)."""
    B, S, H, KV, hd = 1, 128, 4, 2, 32
    q, k, v = _inputs((B, S + 4, H, hd), "float32", kv=KV, seed=3)
    G = H // KV
    ke, ve = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    tq, tk, tv = _torch(q, k, v)
    _, state, z = linear_attention(tq[:, :S], tk[:, :S], tv[:, :S],
                                   chunk=32)
    full, _, _ = ref_linear_attention(*(jnp.asarray(a)
                                        for a in (q, ke, ve)))
    rstate, rz = jnp.asarray(f32(state)), jnp.asarray(f32(z))
    tke, tve = _torch(ke, ve)
    for t in range(S, S + 4):
        o, state, z = TL.linear_attn_decode(
            tq[:, t:t + 1], tke[:, t:t + 1], tve[:, t:t + 1], state, z)
        ro, rstate, rz = RL.linear_attn_decode(
            *(jnp.asarray(a[:, t:t + 1]) for a in (q, ke, ve)), rstate, rz)
        assert _rel_err(full[:, t], o[:, 0]) < 1e-4
        assert _rel_err(ro, o) < 1e-4
        assert _rel_err(rstate, state) < 1e-4 and _rel_err(rz, z) < 1e-4


def test_sequential_oracle_matches_reference():
    arrs = _inputs((2, 48, 3, 16), "float32", seed=4)
    got = port_ref_sequential(*_torch(*arrs))
    want = ref_linear_attention(*(jnp.asarray(a) for a in arrs))
    for w, g in zip(want, got):
        assert _rel_err(w, g) < 1e-4


def test_linear_attention_refuses_what_it_does_not_take():
    q, k, v = _torch(*_inputs((1, 48, 4, 16), "float32", kv=2))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        linear_attention(q, k, v, chunk=32)
    with pytest.raises(ValueError, match="query heads"):
        linear_attention(q[:, :, :3], k, v, chunk=16)
    with pytest.raises(ValueError, match="unsupported device"):
        linear_attention(*(t.to("meta") for t in (q, k, v)), chunk=16)


def _f64_linear(q, k, v, valid_len=None):
    """Causal linear attention in float64 by its quadratic form, k/v
    expanded to q's heads; rows at or past ``valid_len`` drop out."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]

    def phi(x):
        x = np.asarray(x, np.float64)
        return np.where(x > 0, x + 1.0, np.exp(x))
    qf = phi(q)
    kf = np.repeat(phi(k), G, axis=2)
    vf = np.repeat(np.asarray(v, np.float64), G, axis=2)
    if valid_len is not None:
        keep = (np.arange(S)[None] < np.asarray(valid_len)[:, None])
        qf, kf, vf = (t * keep[..., None, None] for t in (qf, kf, vf))
    s = np.tril(np.einsum("bihd,bjhd->bhij", qf, kf))
    den = np.maximum(s.sum(-1), 1e-6)
    return np.einsum("bhij,bjhd->bihd", s, vf) / np.moveaxis(
        den, 1, 2)[..., None]


def _rows_f64_err(got, want):
    """Worst row (b, i, h): max |err| over the row's largest |want|."""
    err = np.abs(f32(got).astype(np.float64) - want).max(-1)
    m = np.abs(want).max(-1)
    return float((err[m > 0] / m[m > 0]).max())


# (B, S, H, KV, hd, chunk): GQA 2, 7 and 1, a ragged 127-row chunk (tiles
# of 64 and 63 rows), chunks that cut tiles, hd below and at 64
EMU_SHAPES = [(2, 128, 4, 2, 32, 64), (1, 256, 7, 1, 16, 256),
              (2, 127, 4, 4, 16, 127), (1, 192, 6, 2, 64, 96)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_tf32x3_emulation_matches_reference(shape, dtype):
    """The kernel's arithmetic against ``ref_linear_attention`` and
    interpret-mode ``linear_attention_pallas`` (k/v repeated to every
    query head) at the reference tests' tolerances; in fp32 its output
    against float64 within 2x the plain chunked form's error."""
    from repro_torch.kernels.linear_attention.ref import (
        emulate_linear_attention_tf32x3)
    B, S, H, KV, hd, chunk = shape
    q, k, v = _inputs((B, S, H, hd), dtype, kv=KV, seed=S + hd)
    G = H // KV
    tq, tk, tv = _torch(q, k, v)
    got = emulate_linear_attention_tf32x3(tq, tk, tv, chunk=chunk)
    assert got[0].dtype == tq.dtype
    ke, ve = (jnp.repeat(jnp.asarray(a), G, axis=2) for a in (k, v))
    jq = jnp.asarray(q)
    for want in (ref_linear_attention(jq, ke, ve),
                 ref_kernel(jq, ke, ve, chunk=chunk, interpret=True)):
        for w, g in zip(want, got):
            assert tuple(g.shape) == w.shape
            assert _rel_err(w, g) < TOL[dtype]
    if dtype == "float32":
        f64 = _f64_linear(q, k, v)
        plain = linear_attention(tq, tk, tv, chunk=chunk)[0]
        assert _rows_f64_err(got[0], f64) <= 2 * _rows_f64_err(plain, f64)


def test_tf32x3_emulation_drops_the_padding():
    """valid_len: the emulation's state and z equal the plain chunked
    form's within 1e-6 of their largest magnitude, rows before valid_len
    within 1e-5 of their row's largest value, padded rows exactly zero."""
    from repro_torch.kernels.linear_attention.ref import (
        emulate_linear_attention_tf32x3)
    q, k, v = _torch(*_inputs((2, 200, 4, 16), "float32", kv=2, seed=5))
    vl = torch.tensor([130, 200])
    got = emulate_linear_attention_tf32x3(q, k, v, chunk=100, valid_len=vl)
    want = linear_attention(q, k, v, chunk=100, valid_len=vl)
    for w, g in zip(want[1:], got[1:]):
        assert float((w - g).abs().max()) <= 1e-6 * float(w.abs().max())
    assert _rows_f64_err(got[0][0, :130], f32(want[0][0, :130])) < 1e-5
    assert not got[0][0, 130:].any()
