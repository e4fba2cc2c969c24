"""The port's cache-row-update against the reference's, on the CPU, and
the decode step that donates its caches to it.

On CPU tensors ``ops.cache_row_update`` runs its plain version (the
kernel runs only on the card; ``test_torch_cuda_kernels.py`` holds it
against the plain version there).  Here, with inputs made by numpy from a
seed:

* ``cache_row_update`` and ``ref_cache_row_update`` equal the reference's
  interpret-mode ``cache_row_update`` and its ``ref_cache_row_update``
  bit for bit, on the reference tests' three shapes and its scalar
  index, in fp32 and bf16, and write the cache in place; a row whose
  index is out of range writes nothing (compared with the reference only
  on the rows in range);
* ``lm_decode_step(donate=True)`` on reduced llava (softmax) gives the
  non-donating call's logits and caches bit for bit, writes the donated
  caches in place and returns them, and follows the reference's
  ``lm_decode_step`` within the model tests' tolerances; Mamba-2 and
  linear attention come out bit-identical with and without donation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bits, f32, shared_params
from repro.kernels.cache_update import cache_row_update as r_update
from repro.kernels.cache_update import ref_cache_row_update as r_ref
from repro.models import model as RM
from repro_torch import bridge
from repro_torch.kernels.cache_update import (cache_row_update,
                                              ref_cache_row_update)
from repro_torch.models import model as TM

SHAPES = [(4, 64, 2, 16), (2, 128, 8, 32), (1, 256, 4, 64)]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ref_decode_step = jax.jit(RM.lm_decode_step, static_argnums=(1,))


def _inputs(shape, dtype, seed):
    """(cache, row) in ``dtype`` as reference arrays and CPU tensors."""
    rng = np.random.default_rng(seed)
    B, S, KV, hd = shape
    cache = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        ).astype(dtype)
    row = jnp.asarray(rng.standard_normal((B, KV, hd)).astype(np.float32)
                      ).astype(dtype)
    return (cache, row, bridge.array_to_tensor(np.asarray(cache), "cpu"),
            bridge.array_to_tensor(np.asarray(row), "cpu"))


def _port_bits(t):
    return bits(bridge.tensor_to_array(t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cache_row_update_bit_exact_against_reference(shape, dtype):
    B, S = shape[:2]
    cache, row, tcache, trow = _inputs(shape, dtype, seed=S + B)
    idx = np.asarray([(i * 7 + 3) % S for i in range(B)], np.int32)
    want = np.asarray(r_ref(cache, row, jnp.asarray(idx)))
    pallas = np.asarray(r_update(jnp.array(cache), row, jnp.asarray(idx),
                                 interpret=True))
    before = _port_bits(tcache).copy()
    plain = ref_cache_row_update(tcache.clone(), trow,
                                 torch.from_numpy(idx))
    got = cache_row_update(tcache, trow, torch.from_numpy(idx))
    assert got is tcache                             # written in place
    for out in (got, plain):
        assert np.array_equal(_port_bits(out), bits(want))
        assert np.array_equal(_port_bits(out), bits(pallas))
    changed = _port_bits(got) != before
    assert not changed[np.arange(S)[None, :] != idx[:, None]].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_row_update_scalar_index(dtype):
    """A scalar index is broadcast to every row, as the reference's
    wrapper does (its test: zeros, ones written at position 5)."""
    cache = jnp.zeros((2, 16, 2, 8), dtype)
    row = jnp.ones((2, 2, 8), dtype)
    want = np.asarray(r_update(cache, row, jnp.asarray(5), interpret=True))
    assert float(want[:, 5].astype(np.float32).sum()) == 2 * 2 * 8
    for idx in (5, torch.tensor(5, dtype=torch.int32)):
        tcache = bridge.array_to_tensor(np.zeros((2, 16, 2, 8), np.float32),
                                        "cpu").to(getattr(torch, dtype))
        trow = torch.ones((2, 2, 8), dtype=getattr(torch, dtype))
        got = cache_row_update(tcache, trow, idx)
        assert np.array_equal(_port_bits(got), bits(want))
        assert float(got.float().sum()) == 2 * 2 * 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_row_update_out_of_range_row_writes_nothing(dtype):
    """Row 1's index is past the cache: the port drops it (its cache row
    stays as it was); the rows in range equal the reference's."""
    shape = (4, 64, 2, 16)
    cache, row, tcache, trow = _inputs(shape, dtype, seed=11)
    idx = np.asarray([3, 64, 10, 63], np.int32)
    before = _port_bits(tcache).copy()
    got = _port_bits(cache_row_update(tcache, trow, torch.from_numpy(idx)))
    ok = np.asarray([0, 2, 3])
    want = np.asarray(r_ref(cache, row, jnp.asarray(idx)))
    pallas = np.asarray(r_update(jnp.array(cache), row, jnp.asarray(idx),
                                 interpret=True))
    for ref in (want, pallas):
        assert np.array_equal(got[ok], bits(ref)[ok])
    assert np.array_equal(got[1], before[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_row_update_casts_the_row_to_the_cache_dtype(dtype):
    """A row of the other dtype lands rounded to the cache's dtype, as the
    reference's ``row.astype(cache.dtype)``."""
    other = "bfloat16" if dtype == "float32" else "float32"
    cache, _, tcache, _ = _inputs((2, 32, 2, 16), dtype, seed=4)
    _, row, _, trow = _inputs((2, 32, 2, 16), other, seed=5)
    idx = np.asarray([0, 31], np.int32)
    want = np.asarray(r_ref(cache, row, jnp.asarray(idx)))
    got = cache_row_update(tcache, trow, torch.from_numpy(idx))
    assert np.array_equal(_port_bits(got), bits(want))


def _decode_inputs(cfg, seed=3, S=24, B=3):
    """A prefilled-looking cache (random softmax caches, per-row lengths)
    and the next tokens, as numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)
    lengths = np.asarray([5, 17, S - 1], np.int32)[:B]
    return tokens, lengths, rng


def _softmax_cache(cfg, rng, B, S):
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    return tuple(jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                             ).astype(cfg.dtype) for _ in range(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_donating_decode_step_equals_the_non_donating_one(dtype):
    rcfg, rparams, tcfg, tparams = shared_params(
        "llava-onevision-0.5b", dtype, "nanomind-serve")
    B, S = 3, 24
    tokens, lengths, rng = _decode_inputs(tcfg, B=B, S=S)
    rk, rv = _softmax_cache(rcfg, rng, B, S)

    def port_cache():
        return {"layers": ((bridge.array_to_tensor(np.asarray(rk), "cpu"),
                            bridge.array_to_tensor(np.asarray(rv), "cpu")),),
                "index": torch.from_numpy(lengths)}
    keep, given = port_cache(), port_cache()
    before = [t.clone() for t in keep["layers"][0]]
    with torch.no_grad():
        l0, c0 = TM.lm_decode_step(tparams, tcfg, torch.from_numpy(tokens),
                                   keep)
        l1, c1 = TM.lm_decode_step(tparams, tcfg, torch.from_numpy(tokens),
                                   given, donate=True)
    # the non-donating call left its caches alone; the donating one wrote
    # its own and handed them back (no copy, no stack)
    for t, b in zip(keep["layers"][0], before):
        assert torch.equal(t, b)
    for new, donated in zip(c1["layers"][0], given["layers"][0]):
        assert new is donated
    assert torch.equal(l0, l1)
    for a, b in zip(c0["layers"][0], c1["layers"][0]):
        assert np.array_equal(_port_bits(a), _port_bits(b))
    assert torch.equal(c0["index"], c1["index"])
    # and the reference's step within the model tests' tolerance
    rl, rc = ref_decode_step(rparams, rcfg, jnp.asarray(tokens),
                             {"layers": ((rk, rv),),
                              "index": jnp.asarray(lengths)})
    m = float(np.abs(f32(rl)).max())
    assert float(np.abs(f32(rl) - f32(l1)).max()) <= TOL[dtype] * m
    rows = np.arange(B)
    for r, t in zip(rc["layers"][0], c1["layers"][0]):
        r, t = f32(r), f32(t)
        written = np.zeros(r.shape[:3], bool)
        written[:, rows, lengths] = True
        assert np.array_equal(t[~written], r[~written])
        w = r[written]
        assert float(np.abs(w - t[written]).max()) <= \
            TOL[dtype] * float(np.abs(w).max())


@pytest.mark.parametrize("arch,variant", [
    ("mamba2-1.3b", {}),
    ("llava-onevision-0.5b", {"attn_impl": "linear", "subquadratic": True})])
def test_donation_leaves_slot_state_mixers_unchanged(arch, variant):
    """Mamba-2 and linear attention have no cache row to write: their
    decode step gives the same logits and state bit for bit either way."""
    _, _, tcfg, tparams = shared_params(arch, "float32", "nanomind-serve")
    tcfg = dataclasses.replace(tcfg, **variant)
    B = 2
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(3, tcfg.vocab_size, (B, 1)
                                           ).astype(np.int32))
    base = TM.init_decode_state(tcfg, B, 32, start_index=4, device="cpu")
    g = torch.Generator().manual_seed(2)
    layers = tuple(tuple(torch.randn(t.shape, generator=g).to(t.dtype)
                         for t in pos) for pos in base["layers"])
    outs = []
    for donate in (False, True):
        cache = {"layers": tuple(tuple(t.clone() for t in pos)
                                 for pos in layers),
                 "index": base["index"]}
        with torch.no_grad():
            outs.append(TM.lm_decode_step(tparams, tcfg, tokens, cache,
                                          donate=donate))
    (l0, c0), (l1, c1) = outs
    assert torch.equal(l0, l1)
    for a, b in zip(c0["layers"][0], c1["layers"][0]):
        assert torch.equal(a, b)
