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

The kernel's fp32 route (split TF32 on the tensor cores) is held here
through its plain emulation: ``split_tf32`` gives two tf32 terms that
sum to x within 2^-22 relative, and ``emulate_flash_f32`` (the three
split products a product, tiles of 64 keys) meets the reference's
interpret-mode flash within 1e-4 on the reference kernel tests' grid and
at head dim 160.
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
from repro_torch.kernels.flash_attention.ref import (emulate_flash_f32,
                                                     split_tf32)

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


def test_split_tf32_reconstructs_and_keeps_ten_mantissa_bits():
    """hi + lo is x within 2^-22 |x| over twelve decades and at the
    edges (zero, powers of two, ties at bit 12, the largest float); hi and
    lo keep 10 explicit mantissa bits (their 13 low bits zero); hi is x
    rounded to nearest, ties away from zero."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(200_000)
         * np.exp(rng.uniform(-14.0, 14.0, 200_000))).astype(np.float32)
    ties = (np.float32(1.0) + np.float32(2.0 ** -11) * np.arange(1, 9,
            dtype=np.float32)).astype(np.float32)
    edges = np.array([0.0, 1.0, -1.0, 2.0 ** -126, 3.4e38, -3.4e38],
                     np.float32)
    x = np.concatenate([x, ties, -ties, edges])
    t = torch.from_numpy(x)
    hi, lo = split_tf32(t)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - t.double()).abs()
    assert (err <= 2.0 ** -22 * t.double().abs()).all()
    # rounding to nearest, ties away: |x - hi| <= half a tf32 step, ties up
    step = torch.ldexp(torch.ones_like(t.double()),
                       torch.frexp(t.double())[1] - 11)
    assert ((t.double() - hi.double()).abs() <= step / 2).all()
    tie_hi = split_tf32(torch.from_numpy(ties))[0].double()
    assert (tie_hi.abs() >= torch.from_numpy(ties).double().abs()).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 4, 2, 32), (1, 256, 8, 8, 64),
                                   (2, 256, 6, 2, 32), (1, 128, 32, 4, 16),
                                   (1, 192, 14, 2, 160)])
def test_split_tf32_flash_emulation_matches_reference(shape, causal):
    """The fp32 route's arithmetic (``emulate_flash_f32``) against the
    reference's flash in interpret mode (bq = bk = 64, fp32) and its
    ``ref_attention``, within the reference's fp32 bound 1e-4: the
    reference kernel tests' grid, causal and not, and head dim 160 over
    three 64-key tiles."""
    B, S, H, KV, hd = shape
    (q, k, v), (tq, tk, tv) = _inputs(B, S, S, H, KV, hd, "float32",
                                      sum(shape) + causal)
    got = emulate_flash_f32(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    pallas = r_flash(q, k, v, causal=causal, bq=64, bk=64, interpret=True)
    assert _rel_err(_f32(got), pallas) < TOL["float32"]
    assert _rel_err(_f32(got), r_ref(q, k, v, causal=causal)) < \
        TOL["float32"]


# -- the backward's plain version ---------------------------------------------
# ``ref_attention_backward`` (the formula the backward kernel computes, from
# the forward's o and lse) against ``jax.grad`` of the reference's
# ``dense_attention`` (what the reference's training step differentiates
# off the TPU), on the same numpy inputs and cotangent: fp32 within 1e-5 of
# each gradient's largest magnitude (summation order, and D = rowsum(dO * O)
# where autograd sums dP * P); bf16 within 3e-2 (the reference rounds the
# cotangents of P, q and k to bf16 mid-way, the plain version keeps fp32 to
# the end).  The lse against the reference's scores' logsumexp within 1e-6.

@pytest.mark.parametrize("shape,causal", [
    ((2, 128, 128, 4, 2, 32), True), ((1, 96, 96, 8, 8, 64), False),
    ((1, 64, 192, 6, 2, 16), False), ((1, 192, 64, 6, 3, 32), True),
    ((1, 100, 100, 14, 2, 160), True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_backward_plain_matches_reference_grad(shape, causal,
                                                         dtype):
    from repro.models.attention import dense_attention
    from repro_torch.kernels.flash_attention import (ref_attention_backward,
                                                     ref_attention_lse)
    B, Sq, Sk, H, KV, hd = shape
    (q, k, v), (tq, tk, tv) = _inputs(B, Sq, Sk, H, KV, hd, dtype,
                                      sum(shape) + causal)
    rng = np.random.default_rng(sum(shape))
    do = jnp.asarray(rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
                     .astype(jnp.dtype(dtype)))
    tdo = bridge.array_to_tensor(np.asarray(do), device="cpu")
    _, vjp = jax.vjp(lambda a, b, c: dense_attention(a, b, c, causal=causal),
                     q, k, v)
    want = vjp(do)
    o, lse = ref_attention_lse(tq, tk, tv, causal=causal)
    got = ref_attention_backward(tq, tk, tv, o, lse, tdo, causal=causal)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and tuple(g.shape) == tuple(t.shape)
        assert _rel_err(_f32(g), w) < tol
    qg = np.asarray(q, np.float32).reshape(B, Sq, KV, H // KV, hd)
    s = np.einsum("bikgh,bjkh->bkgij", qg, np.asarray(k, np.float32)
                  ) * hd ** -0.5
    if causal:
        s = np.where(np.arange(Sq)[:, None] >= np.arange(Sk)[None], s, -1e30)
    want_lse = np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1)
                          ).reshape(B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6, atol=1e-6)


# -- the backward kernel's arithmetic ------------------------------------------
# ``emulate_flash_bwd`` repeats what the card's backward kernel computes (64-
# row tiles, bf16 products with dS in two bf16 terms, or split TF32 in fp32,
# each kv head's query-head partials added in order).  On the plain test's
# grid it meets ``jax.vjp`` of the reference's ``dense_attention``: in fp32
# every row of dq, dk and dv within 1e-4 of that row's largest magnitude (a
# causal dq's row 0, zero in exact arithmetic, against the gradient's
# largest); in bf16 within 3e-2 of each gradient's largest, as the plain
# version (the reference rounds cotangents to bf16 mid-way, and a causal
# dq's few-key rows take D from the bf16 output: the plain version's own
# rows reach 4.5e-2 of themselves there), and every row within 2e-2 of the
# plain version's.  Against the float64 backward it is no worse than twice
# the plain version's error (the card checks' gate).
BWD_SHAPES = [((2, 128, 128, 4, 2, 32), True), ((1, 96, 96, 8, 8, 64), False),
              ((1, 64, 192, 6, 2, 16), False), ((1, 192, 64, 6, 3, 32), True),
              ((1, 100, 100, 14, 2, 160), True)]
BWD_ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _bwd_case(shape, causal, dtype):
    from repro_torch.kernels.flash_attention import ref_attention_lse
    B, Sq, Sk, H, KV, hd = shape
    (q, k, v), (tq, tk, tv) = _inputs(B, Sq, Sk, H, KV, hd, dtype,
                                      sum(shape) + causal)
    rng = np.random.default_rng(sum(shape))
    do = jnp.asarray(rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
                     .astype(jnp.dtype(dtype)))
    tdo = bridge.array_to_tensor(np.asarray(do), device="cpu")
    o, lse = ref_attention_lse(tq, tk, tv, causal=causal)
    return (q, k, v, do), (tq, tk, tv, o, lse, tdo)


def _row_ratio(got, want, causal_dq):
    """max over rows of |got - want| / the row's largest |want| (a causal
    dq's row 0 against the gradient's largest)."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    row = np.abs(w).max(-1)
    den = row.copy()
    if causal_dq:
        den[:, 0] = row.max()
    return float(np.nan_to_num(np.abs(g - w).max(-1) / den, nan=0.0).max())


@pytest.mark.parametrize("shape,causal", BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_emulation_matches_reference_grad(shape, causal, dtype):
    from repro.models.attention import dense_attention
    from repro_torch.kernels.flash_attention import ref_attention_backward
    from repro_torch.kernels.flash_attention.ref import emulate_flash_bwd
    (q, k, v, do), args = _bwd_case(shape, causal, dtype)
    _, vjp = jax.vjp(lambda a, b, c: dense_attention(a, b, c, causal=causal),
                     q, k, v)
    got = emulate_flash_bwd(*args, causal=causal)
    plain = ref_attention_backward(*args, causal=causal)
    for i, (g, w, pl, t) in enumerate(zip(got, vjp(do), plain, args[:3])):
        assert g.dtype == t.dtype and tuple(g.shape) == tuple(t.shape)
        if dtype == "float32":
            assert _row_ratio(_f32(g), w, causal and i == 0) <= \
                BWD_ROW_TOL[dtype]
        else:
            assert _rel_err(_f32(g), w) < 3e-2
            assert _row_ratio(_f32(g), _f32(pl), causal and i == 0) <= \
                BWD_ROW_TOL[dtype]


@pytest.mark.parametrize("shape,causal", BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_emulation_vs_float64_within_twice_plain(shape, causal,
                                                           dtype):
    from repro_torch.kernels.flash_attention import ref_attention_backward
    from repro_torch.kernels.flash_attention.ref import emulate_flash_bwd
    _, args = _bwd_case(shape, causal, dtype)
    got = emulate_flash_bwd(*args, causal=causal)
    want = ref_attention_backward(*args, causal=causal)
    exact = ref_attention_backward(*(t.double() for t in args),
                                   causal=causal)
    for g, w, x in zip(got, want, exact):
        den = x.abs().max()
        k_err = ((g.double() - x).abs().max() / den).item()
        p_err = ((w.double() - x).abs().max() / den).item()
        assert k_err <= 2.0 * p_err, (k_err, p_err)


# -- the backward's grids -------------------------------------------------------
# ``kernel.bwd_grid`` mirrors how the backward kernels map blockIdx to work:
# dK/dV a block per (batch, query head, 64-key block), dQ a block per (batch,
# head, 64-row block), both issued longest first.  Each must cover every
# (head, key block, row block) tile pair that the causal mask leaves any
# element of exactly once; at the training shape (B 4, S 2048, H 14) the
# longest block walks 32 tile pairs against a mean of 16.5, at most half of
# what a resident block slot gets on average up to three blocks an SM (the
# bf16 kernels' shared memory at hd 64 holds three).

@pytest.mark.parametrize("B,Sq,Sk,H,causal", [
    (4, 2048, 2048, 14, True), (1, 777, 777, 14, True),
    (1, 300, 1000, 28, False), (1, 200, 77, 8, True), (1, 2, 2, 4, True),
    (1, 128, 300, 4, True), (2, 128, 128, 4, False)])
def test_flash_bwd_grid_covers_each_tile_pair_once(B, Sq, Sk, H, causal):
    from repro_torch.kernels.flash_attention import kernel as FK
    T = FK.BWD_TILE
    nq, nk = -(-Sq // T), -(-Sk // T)
    want = {(bh, kb, rb) for bh in range(B * H) for kb in range(nk)
            for rb in range(nq)
            if not causal or kb * T <= min(rb * T + T, Sq) - 1}
    dkdv, dq = FK.bwd_grid(B, Sq, Sk, H, causal)
    assert len(dkdv) == B * H * nk and len(dq) == B * H * nq
    for blocks, key in ((dkdv, lambda p: p[:2]), (dq, lambda p: (p[0], p[2]))):
        pairs = [p for blk in blocks for p in blk]
        assert len(pairs) == len(set(pairs)) and set(pairs) == want
        # a block walks one (head, key block) or one (head, row block)
        assert all(len({key(p) for p in blk}) <= 1 for blk in blocks)
        # longest first
        lens = [len(blk) for blk in blocks]
        assert lens == sorted(lens, reverse=True)


@pytest.mark.parametrize("resident,balanced", [(1, True), (2, True),
                                               (3, True), (4, False)])
def test_flash_bwd_geometry_at_the_training_shape(resident, balanced):
    from repro_torch.kernels.flash_attention import kernel as FK
    geo = FK.bwd_geometry(4, 2048, 2048, 14, True,
                          {"dkdv": resident, "dq": resident})
    for name in ("dkdv", "dq"):
        g = geo[name]
        assert (g["blocks"], g["tile_pairs"], g["longest"]) == \
            (1792, 4 * 14 * 528, 32)
        assert g["mean"] == 16.5
        assert g["pairs_a_slot"] == 4 * 14 * 528 / (132 * resident)
        assert g["balanced"] is balanced


def test_split3_tf32_is_exact():
    """The backward's three-term split: x1 + x2 + x3 is x exactly over
    twelve decades and at the edges, each term keeping 10 explicit
    mantissa bits (its 13 low bits zero); two terms (``split_tf32``) miss
    by up to 2^-22 |x|."""
    from repro_torch.kernels.flash_attention.ref import split3_tf32
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(200_000)
         * np.exp(rng.uniform(-14.0, 14.0, 200_000))).astype(np.float32)
    x = np.concatenate([x, np.array([0.0, 1.0, -1.0, 3.4e38], np.float32)])
    t = torch.from_numpy(x)
    terms = split3_tf32(t)
    for part in terms:
        assert part.dtype == torch.float32
        assert not (part.view(torch.int32) & 0x1FFF).any()
    total = sum(p.double() for p in terms)
    assert torch.equal(total, t.double())
    hi, lo = split_tf32(t)
    assert (hi.double() + lo.double() != t.double()).any()
