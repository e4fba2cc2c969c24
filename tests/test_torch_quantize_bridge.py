"""The port's quantization and parameter bridge against the reference.

* ``quantize`` gives codes and scales array-equal to the reference's on
  the same fp32 / bf16 input (MSE scale search and its tie order
  included); ``dequantize`` is bit-equal, bf16 compared as uint16 bits.
* The port's ``init_params`` gives the reference's tree, shapes, dtypes
  and init scales (its own random numbers).
* The bridge carries every leaf of reduced llava — plain and after
  ``quantize_tree(nanomind-serve)`` — reference -> port -> numpy bit for
  bit, and the port's own ``quantize_tree`` packs the same leaves the
  same way.
* The bridge puts tensors on the card unless the caller asks for the
  CPU, and carries the linear-attention variant's (state, z) caches
  both ways bit for bit.
* Mamba-2-1.3B's layer leaves at their full widths: ``nanomind-serve``
  packs the same ones (the projections, the conv taps and bias, both
  norm scales) to the same codes and scales in both packages, keeps
  A_log, D and dt_bias fp32, and the per-layer dequantize the decoder
  runs is bit-equal to the reference's.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (bits, flat, from_numpy_to_ref, jax_to_numpy,
                           shared_params, to_port)
from repro.configs import get_config as ref_config
from repro.core import quantize as RQ
from repro.launch.steps import init_params as ref_init
from repro.models import model as RM
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import quantize as TQ
from repro_torch.models import model as TM
from repro_torch.models.model import init_params
from repro_torch.tree import tree_leaves


def _pair(bits_, group):
    return RQ.QuantSpec(bits_, group_size=group), TQ.QuantSpec(
        bits_, group_size=group)


@pytest.mark.parametrize("shape,nbits,group", [
    ((2, 128, 4, 32), 4, 32),   # main path: q4 g32 along hd (as wq)
    ((96, 256), 8, 64),
    ((3, 64, 96), 2, 64)])      # 96 pads to 128 along the packed axis
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_reference(shape, nbits, group, dtype):
    rng = np.random.default_rng(len(shape) * 7 + nbits)
    rspec, tspec = _pair(nbits, group)
    normal = rng.standard_normal(shape).astype(np.float32)
    grid = rng.integers(-7, 8, shape).astype(np.float32) * 0.25
    for w in (normal, grid):   # grid: exact groups, the max-abs tie wins
        wj = jnp.asarray(w).astype(dtype)
        rq = RQ.quantize(wj, rspec)
        tq = TQ.quantize(bridge.array_to_tensor(np.asarray(wj), device="cpu"),
                         tspec)
        assert np.array_equal(np.asarray(rq.codes), tq.codes.numpy())
        assert np.array_equal(bits(np.asarray(rq.scales)),
                              bits(tq.scales.numpy()))
        assert tq.shape == tuple(rq.shape)
        rd = bits(np.asarray(RQ.dequantize(rq)))
        td = bits(bridge.tensor_to_array(TQ.dequantize(tq)))
        assert np.array_equal(rd, td)


@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_unpack_codes_matches_reference(nbits):
    rng = np.random.default_rng(nbits)
    codes = rng.integers(-2 ** 31, 2 ** 31, (5, 6), dtype=np.int64).astype(
        np.int32)
    rspec, tspec = _pair(nbits, 64)
    want = np.asarray(RQ.unpack_codes(jnp.asarray(codes), rspec))
    got = TQ.unpack_codes(torch.from_numpy(codes), tspec).numpy()
    assert np.array_equal(want, got)


ARCH = "llava-onevision-0.5b"


@functools.lru_cache(maxsize=None)
def ref_params(policy=None):
    """Reduced llava initialized by the reference (seed 0), optionally
    quantized by the reference's policy.  The init runs under one jit
    (the same bits as eager, half the compile time); quantize_tree stays
    eager, as the reference serves it."""
    cfg = ref_config(ARCH).reduced()
    params = jax.jit(ref_init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    if policy is not None:
        params = RQ.quantize_tree(params, RQ.PROFILES[policy])
    return params


def _leaves_equal(a, b):
    """Two numpy trees (bridge form) equal path for path, bits exact."""
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for path, x in fa.items():
        y = fb[path]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(bits(np.asarray(x)), bits(np.asarray(y)))
        else:
            assert x == y


@pytest.mark.parametrize("quantized", [False, True])
def test_bridge_round_trip_is_bit_exact(quantized):
    params = ref_params("nanomind-serve" if quantized else None)
    src = jax_to_numpy(params)
    port = bridge.from_numpy(src, device="cpu")
    n_q = sum(isinstance(l, TQ.QTensor) for l in tree_leaves(port))
    assert (n_q > 0) == quantized
    back = bridge.to_numpy(port)
    _leaves_equal(src, back)


def test_port_quantize_tree_matches_reference():
    """The port's quantize_tree of the bridged plain params packs the same
    leaves to the same codes and scales as the reference's."""
    policy = "nanomind-serve"
    params = ref_params()
    qparams = ref_params(policy)
    want = jax_to_numpy(qparams)
    got = bridge.to_numpy(TQ.quantize_tree(to_port(params),
                                           TQ.PROFILES[policy]))
    _leaves_equal(want, got)
    assert RQ.tree_bytes(qparams) == TQ.tree_bytes(
        bridge.from_numpy(want, device="cpu"))


def test_init_params_has_reference_shapes_and_scales():
    """The port's own init: the reference's tree, shapes and dtypes, and
    init scales within sampling noise (numbers differ by design)."""
    ref = flat(jax_to_numpy(ref_params()))
    port = flat(init_params(get_config(ARCH).reduced(), device="cpu",
                            seed=3))
    assert sorted(ref) == sorted(port)
    for path, leaf in ref.items():
        t = port[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
        want = float(np.std(np.asarray(leaf, np.float32)))
        got = float(t.float().std()) if t.numel() > 1 else 0.0
        assert abs(got - want) <= 0.1 * want + 1e-6, (path, got, want)


def _mamba_leaves():
    """nanomind-serve's view of Mamba-2-1.3B: every layer leaf at its
    full width and 48 stacked layers (so the size rule decides as at full
    size), except the two projections, cut to 2 layers of 64 rows (their
    grouped last axis, 8512 and 2048, kept)."""
    rng = np.random.default_rng(9)
    L = 48

    def w(*shape, scale=0.05, base=0.0):
        a = base + scale * rng.standard_normal(shape)
        return jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16)

    def f(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    mixer = {"in_proj": w(2, 64, 8512), "conv_w": w(L, 4, 4352, scale=0.5),
             "conv_b": w(L, 4352), "A_log": f(L, 64), "D": f(L, 64),
             "dt_bias": f(L, 64), "norm_scale": w(L, 4096, base=1.0),
             "out_proj": w(2, 64, 2048)}
    return {"embed": w(64, 2048), "final_norm": {"scale": w(2048, base=1.0)},
            "layers": ({"norm1": {"scale": w(L, 2048, base=1.0)},
                        "mixer": mixer},)}


def test_mamba_leaves_quantize_like_reference():
    policy = "nanomind-serve"
    params = _mamba_leaves()
    rq = RQ.quantize_tree(params, RQ.PROFILES[policy])
    tq = TQ.quantize_tree(to_port(params), TQ.PROFILES[policy])
    _leaves_equal(jax_to_numpy(rq), bridge.to_numpy(tq))
    packed = {path[-2] if path[-1] == "scale" else path[-1]
              for path, leaf in flat(tq).items()
              if isinstance(leaf, TQ.QTensor)}
    assert packed == {"in_proj", "out_proj", "conv_w", "conv_b",
                      "norm_scale", "norm1"}
    mix = tq["layers"][0]["mixer"]
    for name in ("A_log", "D", "dt_bias"):
        assert mix[name].dtype == torch.float32
    rmix = rq["layers"][0]["mixer"]
    for name in ("in_proj", "conv_w", "conv_b", "norm_scale"):
        r, t = rmix[name], mix[name]
        full = TQ.dequantize(t)
        assert np.array_equal(bits(np.asarray(RQ.dequantize(r))),
                              bridge.tensor_to_array(full))
        for i in (0, t.shape[0] - 1):   # the decoder's per-layer slice
            assert torch.equal(TQ.dequantize(t.layer(i)).view(torch.int16),
                               full[i].view(torch.int16))


def test_bridge_defaults_to_the_card():
    """Like every entry point of the port, the bridge defaults to
    ``cuda``: without a card, a call that does not ask for the CPU
    raises instead of quietly staying on the host."""
    for fn in (bridge.array_to_tensor, bridge.from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    if torch.cuda.is_available():
        assert bridge.array_to_tensor(a).is_cuda
        assert bridge.from_numpy({"w": a})["w"].is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            bridge.array_to_tensor(a)
        with pytest.raises((AssertionError, RuntimeError)):
            bridge.from_numpy({"w": a})
    assert bridge.array_to_tensor(a, device="cpu").device.type == "cpu"


def test_bridge_carries_linear_attention_caches_both_ways():
    """The variant's parameters are llava's tree (the bridge carries
    them as they are), and its (state, z) caches cross reference ->
    port -> numpy and port -> numpy -> reference bit for bit."""
    linear = {"attn_impl": "linear", "subquadratic": True}
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, "float32",
                                                 "nanomind-serve")
    rcfg = dataclasses.replace(rcfg, **linear)
    tcfg = dataclasses.replace(tcfg, **linear)
    toks = np.random.default_rng(3).integers(3, 500, (2, 16)).astype(
        np.int32)
    _, rcache = RM.lm_prefill(rparams, rcfg, jnp.asarray(toks), 32)
    src = jax_to_numpy(rcache["layers"])
    port = bridge.from_numpy(src, device="cpu")
    assert all(t.dtype == torch.float32 for t in port[0])
    _leaves_equal(src, bridge.to_numpy(port))
    with torch.no_grad():
        _, tcache = TM.lm_prefill(tparams, tcfg, torch.from_numpy(toks), 32)
    back = from_numpy_to_ref(bridge.to_numpy(tcache["layers"]))
    for r, t in zip(back[0], tcache["layers"][0]):
        assert np.array_equal(bits(np.asarray(r)), bits(t.numpy()))
