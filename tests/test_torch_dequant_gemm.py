"""The port's packed-weight GEMM against the reference's, on the CPU.

On CPU tensors ``dequant_gemm`` and ``quant_einsum`` run their plain
versions (the kernel runs only on the card; ``test_torch_cuda_kernels.py``
holds it against these plain versions there).  Every packed weight here
is made by the reference's ``quantize`` and carried over by the bridge.

* ``dequant_gemm`` (the reference kernel's "nk" layout, packed along K)
  meets the reference's Pallas kernel in interpret mode and its oracle
  ``ref_dequant_gemm`` on the grid of ``tests/test_kernels.py`` (bits,
  shapes, dtypes, the four epilogues, group sizes, a 3-D x), at the
  reference tests' 5e-3 of the largest magnitude in bf16 and 1e-5 in
  fp32 (summation order only).
* ``quant_einsum`` in each of the model's six contractions (the "kn"
  layout, packed along the output axis; q/k/v per head, also with a head
  dim below the group size, which ``quantize`` pads) is bit-equal to
  ``torch.einsum`` on the reference's ``dequantize(w)`` and to
  ``jnp.einsum`` on it in bf16; in fp32 within 1e-6 of the latter (the
  two CPU BLAS libraries may sum in other orders).
* Prefill hands every projection weight to ``quant_einsum`` still packed
  (7 a layer with attention and a gated MLP, 2 a Mamba-2 layer), decode
  hands it dense, and the prefill logits equal those of the dequantized
  weights bit for bit.
* The fp32 route's arithmetic (``ref.emulate_dequant_gemm_tf32x3``: split
  TF32 products, K steps of 32 summed apart, splits of K added in order)
  meets the reference's Pallas kernel in interpret mode and
  ``ref_dequant_gemm`` in both layouts, across bits, epilogues and splits,
  within 1e-5 of the largest magnitude; against a float64 evaluation it
  stays within 2x the plain fp32 version's error (both sit at fp32's
  rounding level, where either may be ahead).
* The route and plan rules (``kernel.route``, ``kernel.tf32x3_plan``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32, shared_params, to_port
from repro.core import quantize as RQ
from repro.kernels.dequant_gemm import dequant_gemm as r_dequant_gemm
from repro.kernels.dequant_gemm import ref_dequant_gemm as r_ref
from repro_torch.core.quantize import QTensor, dequantize_tree
from repro_torch.kernels.dequant_gemm import dequant_gemm, quant_einsum
from repro_torch.kernels.dequant_gemm import ops as dg_ops
from repro_torch.models import model as TM

TOL = {"float32": 1e-5, "bfloat16": 5e-3}


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _arr(rng, shape, dtype, scale=1.0):
    """A numpy draw as a reference array of ``dtype`` and the port's tensor
    of the same bits."""
    a = jnp.asarray((rng.standard_normal(shape) * scale).astype(
        np.float32)).astype(dtype)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _packed(rng, shape, dtype, bits=4, group=64, scale=0.05):
    """A weight quantized by the reference, and the port's copy."""
    w, _ = _arr(rng, shape, dtype, scale)
    rw = RQ.quantize(w, RQ.QuantSpec(bits, group_size=group))
    return rw, to_port(rw)


def _against_reference(x, tx, rw, tw, dtype, bias=None, tbias=None,
                       act=None, **pallas_kw):
    got = dequant_gemm(tx, tw, tbias, act)
    assert got.dtype == tx.dtype
    assert tuple(got.shape) == x.shape[:-1] + (rw.shape[0],)
    pallas = r_dequant_gemm(x, rw, bias, act, use_kernel=True,
                            interpret=True, **pallas_kw)
    assert _rel_err(f32(got), r_ref(x, rw, bias, act)) < TOL[dtype]
    assert _rel_err(f32(got), pallas) < TOL[dtype]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("mkn", [(64, 512, 128), (8, 1024, 256),
                                 (130, 512, 200)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequant_gemm_plain_matches_reference(bits, mkn, dtype):
    M, K, N = mkn
    rng = np.random.default_rng(bits * 1000 + M)
    x, tx = _arr(rng, (M, K), dtype)
    rw, tw = _packed(rng, (N, K), dtype, bits)
    _against_reference(x, tx, rw, tw, dtype)


@pytest.mark.parametrize("act", ["relu", "silu", "gelu", "squared_relu"])
def test_dequant_gemm_plain_epilogue_matches_reference(act):
    rng = np.random.default_rng(3)
    x, tx = _arr(rng, (32, 512), "float32")
    rw, tw = _packed(rng, (128, 512), "float32", scale=0.1)
    bias = jnp.linspace(-0.5, 0.5, 128, dtype=jnp.float32)
    _against_reference(x, tx, rw, tw, "float32", bias,
                       torch.from_numpy(np.array(bias)), act)


@pytest.mark.parametrize("group", [32, 64, 128])
def test_dequant_gemm_plain_group_sizes_match_reference(group):
    rng = np.random.default_rng(group)
    x, tx = _arr(rng, (16, 512), "float32")
    rw, tw = _packed(rng, (64, 512), "float32", group=group, scale=0.2)
    _against_reference(x, tx, rw, tw, "float32", bk=256)


def test_dequant_gemm_plain_3d_input_matches_reference():
    rng = np.random.default_rng(5)
    x, tx = _arr(rng, (2, 16, 512), "float32")
    rw, tw = _packed(rng, (64, 512), "float32", scale=0.1)
    _against_reference(x, tx, rw, tw, "float32")


def test_dequant_gemm_refuses_an_unknown_activation():
    rng = np.random.default_rng(6)
    _, tx = _arr(rng, (4, 64), "float32")
    _, tw = _packed(rng, (32, 64), "float32")
    with pytest.raises(ValueError, match="activation"):
        dequant_gemm(tx, tw, act="tanh")


# (spec, x shape, weight shape): the model's six contractions at reduced
# widths; Mamba-2's in_proj width 560 pads to 576 (g32); the last q/k/v
# case has hd 16 < g 32, which quantize pads per head
EINSUMS = [("bsd,dhk->bshk", (2, 8, 128), (128, 4, 32)),
           ("bshk,hkd->bsd", (2, 8, 4, 32), (4, 32, 128)),
           ("bsd,df->bsf", (2, 8, 128), (128, 256)),
           ("bsf,fd->bsd", (2, 8, 256), (256, 128)),
           ("bsd,de->bse", (2, 8, 128), (128, 560)),
           ("bse,ed->bsd", (2, 8, 256), (256, 128)),
           ("bsd,dhk->bshk", (2, 8, 64), (64, 4, 16))]


@pytest.mark.parametrize("spec,xs,ws", EINSUMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quant_einsum_is_the_reference_dequantize_and_einsum(spec, xs, ws,
                                                             dtype):
    rng = np.random.default_rng(len(spec) + ws[-1])
    x, tx = _arr(rng, xs, dtype)
    rw, tw = _packed(rng, ws, dtype, group=32, scale=ws[0] ** -0.5)
    assert tw.padded == (ws[-1] % 32 != 0)
    dense = RQ.dequantize(rw)
    got = quant_einsum(spec, tx, tw)
    assert got.dtype == tx.dtype
    composed = torch.einsum(spec, tx, torch.from_numpy(np.array(
        dense.astype(jnp.float32))).to(tx.dtype))
    assert torch.equal(got, composed)
    want = np.asarray(jnp.einsum(spec, x, dense).astype(jnp.float32))
    if dtype == "bfloat16":
        assert np.array_equal(f32(got), want)
    else:
        assert _rel_err(f32(got), want) < 1e-6


def test_quant_einsum_refuses_a_packed_weight_outside_the_model():
    rng = np.random.default_rng(7)
    _, tx = _arr(rng, (2, 8, 64), "float32")
    _, tw = _packed(rng, (64, 32), "float32")
    with pytest.raises(ValueError, match="no packed-weight path"):
        quant_einsum("bsd,df->bfs", tx, tw)


@pytest.mark.parametrize("arch,per_layer,variant", [
    ("llava-onevision-0.5b", 7, None), ("qwen2-vl-7b", 7, None),
    ("llava-onevision-0.5b", 7, "linear"), ("mamba2-1.3b", 2, None)])
def test_prefill_hands_projection_weights_packed(monkeypatch, arch,
                                                 per_layer, variant):
    import dataclasses
    _, _, cfg, params = shared_params(arch, "bfloat16", "nanomind-serve")
    if variant == "linear":
        cfg = dataclasses.replace(cfg, attn_impl="linear",
                                  subquadratic=True)
    calls = []
    inner = dg_ops.quant_einsum

    def recording(spec, x, w):
        calls.append((spec, isinstance(w, QTensor)))
        return inner(spec, x, w)
    monkeypatch.setattr(dg_ops, "quant_einsum", recording)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, cfg.vocab_size, (2, 64)).astype(np.int32))
    with torch.no_grad():
        logits, cache = TM.lm_prefill(params, cfg, toks, 72)
        assert len(calls) == per_layer * cfg.n_layers
        assert all(packed for _, packed in calls)
        calls.clear()
        TM.lm_decode_step(params, cfg, torch.tensor([[5], [7]],
                                                    dtype=torch.int32), cache)
        assert len(calls) == per_layer * cfg.n_layers
        assert not any(packed for _, packed in calls)
        dense, _ = TM.lm_prefill({**params, "layers": dequantize_tree(
            params["layers"])}, cfg, toks, 72)
    assert torch.equal(logits, dense)


# -- the kernel a call takes on the card -------------------------------------

def _served_projections(cfg):
    """(K, N, n2, n2p) of each projection of a layer of ``cfg`` that
    serves on a packed weight (q4 g32, ``nanomind-serve``): K the
    contracted width, N the outputs, n2 the packed axis and n2p its length
    padded as ``quantize`` pads it."""
    from repro_torch.models import decoder, mamba2
    D = cfg.d_model
    if decoder.mixer_of(cfg) == "mamba":
        s = cfg.ssm
        d_inner, H, _ = mamba2._dims(cfg)
        n_in = 2 * d_inner + 2 * s.n_groups * s.d_state + H
        outs = [(D, n_in, n_in), (d_inner, D, D)]
    else:
        H, KV, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
        outs = [(D, H * hd, hd), (D, KV * hd, hd), (H * hd, D, D),
                (D, F, F), (F, D, D)]
    return [(K, N, n2, -(-n2 // 32) * 32) for K, N, n2 in outs]


@pytest.mark.parametrize("arch", ["llava-onevision-0.5b", "qwen2-vl-7b",
                                  "mamba2-1.3b", "seamless-m4t-large-v2"])
def test_every_served_projection_takes_the_wgmma_kernel(arch):
    """The shape rule (``kernel.route``) sends every bf16 projection of
    the served models to the warp-specialised kernel; fp32 calls to the
    split-TF32 tile kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.dequant_gemm import kernel as DK
    cfg = get_config(arch)
    shapes = _served_projections(cfg)
    assert len(shapes) == (2 if arch.startswith("mamba") else 5)
    for K, N, n2, n2p in shapes:
        ldw = N // 8                    # q4: 8 codes a word, no padding
        assert DK.route(torch.bfloat16, K, N, 32, DK.KN, n2, n2p, ldw,
                        True) == "wgmma", (K, N)
        assert DK.route(torch.float32, K, N, 32, DK.KN, n2, n2p, ldw,
                        True) == "tf32x3"


@pytest.mark.parametrize("case,want", [
    (dict(K=896, N=896, n2=64, n2p=64), "wgmma"),
    (dict(K=100, N=896, n2=64, n2p=64), "tile"),        # TMA row stride
    (dict(K=896, N=240, n2=40, n2p=64), "tile"),        # segment padding
    (dict(K=896, N=416, n2=416, n2p=416), "tile"),      # N % 64
    (dict(K=896, N=896, n2=64, n2p=64, aligned=False), "tile"),
    (dict(K=896, N=896, n2=64, n2p=64, group=4), "tile"),
    (dict(K=896, N=896, n2=64, n2p=64, group=8), "tile"),
    (dict(K=896, N=1536, n2=1536, n2p=1536, group=96), "tile"),
    (dict(K=896, N=1024, n2=1024, n2p=1024, group=256), "wgmma"),
    (dict(K=896, N=200, n2=1, n2p=1, layout=0, ldw=112), "wgmma"),  # "nk"
    (dict(K=200, N=300, n2=1, n2p=1, layout=0, ldw=14), "tile"),    # rows
    # fp32: every call takes the split-TF32 kernel, in the splits of K
    # the rule picks from (M, N, K): LLaVA's q/o, k/v, up/gate and down at
    # 1024 rows, Mamba-2's in_proj at 2048, then shapes outside every rule
    (dict(dtype="float32", M=1024, K=896, N=896, n2=64, n2p=64),
     ("tf32x3", 2)),
    (dict(dtype="float32", M=1024, K=896, N=128, n2=64, n2p=64),
     ("tf32x3", 8)),
    (dict(dtype="float32", M=1024, K=896, N=4864, n2=4864, n2p=4864),
     ("tf32x3", 1)),
    (dict(dtype="float32", M=1024, K=4864, N=896, n2=896, n2p=896),
     ("tf32x3", 2)),
    (dict(dtype="float32", M=2048, K=2048, N=8512, n2=8512, n2p=8512),
     ("tf32x3", 1)),
    (dict(dtype="float32", M=50, K=100, N=240, n2=40, n2p=64,
          aligned=False), ("tf32x3", 2)),
    (dict(dtype="float32", M=1, K=200, N=300, n2=1, n2p=1, layout=0,
          ldw=14), ("tf32x3", 3)),
])
def test_gemm_route_rule(case, want):
    import torch
    from repro_torch.kernels.dequant_gemm import kernel as DK
    c = dict(dict(group=32, layout=DK.KN, aligned=True, dtype="bfloat16"),
             **case)
    ldw = c.get("ldw", c["N"] // 8)
    route = DK.route(getattr(torch, c["dtype"]), c["K"], c["N"], c["group"],
                     c["layout"], c["n2"], c["n2p"], ldw, c["aligned"])
    if isinstance(want, tuple):
        want, splits = want
        assert DK.tf32x3_plan(c["M"], c["N"], c["K"]) == splits
    assert route == want


# -- the fp32 route's arithmetic -----------------------------------------------

def _f64_err(got, x, dense, transpose):
    """max |got - x @ W| over its largest magnitude, W the dequantized
    weight ((N, K) when ``transpose``, else (K, N)) and the product in
    float64."""
    w = np.asarray(dense, np.float64)
    want = np.asarray(x, np.float64) @ (w.T if transpose else w)
    return float(np.max(np.abs(f32(got).astype(np.float64) - want))
                 / np.max(np.abs(want)))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("mkn,splits", [
    pytest.param((64, 512, 128), None, id="mkn0-None"),
    pytest.param((8, 1024, 256), 4, id="mkn1-plan1"),
    pytest.param((130, 512, 200), 3, id="mkn2-plan2"),
    pytest.param((64, 2048, 96), None, id="mkn3-None")])
def test_tf32x3_emulation_matches_reference(bits, mkn, splits, monkeypatch):
    """The fp32 route's arithmetic on the reference kernel's layout ("nk")
    against interpret-mode ``dequant_gemm_pallas`` and ``ref_dequant_gemm``
    within 1e-5; against float64 within 2x the plain fp32 version.
    ``splits`` (None: the rule's) replaces ``kernel.tf32x3_plan``."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    from repro_torch.kernels.dequant_gemm.ref import (
        emulate_dequant_gemm_tf32x3)
    if splits is not None:
        monkeypatch.setattr(DK, "tf32x3_plan", lambda M, N, K: splits)
    from repro_torch.kernels.dequant_gemm.ref import ref_dequant_gemm
    M, K, N = mkn
    rng = np.random.default_rng(bits * 1000 + M)
    x, tx = _arr(rng, (M, K), "float32")
    rw, tw = _packed(rng, (N, K), "float32", bits=bits)
    got = emulate_dequant_gemm_tf32x3(tx, tw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert _rel_err(f32(got), r_ref(x, rw)) < 1e-5
    assert _rel_err(f32(got), r_dequant_gemm(
        x, rw, use_kernel=True, interpret=True)) < 1e-5
    dense = RQ.dequantize(rw)
    assert _f64_err(got, x, dense, True) <= 2 * _f64_err(
        ref_dequant_gemm(tx, tw), x, dense, True)


@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu",
                                 "squared_relu"])
def test_tf32x3_emulation_epilogue_matches_reference(act, monkeypatch):
    """Bias and activation after the split products and the sum of four
    splits of K."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    from repro_torch.kernels.dequant_gemm.ref import (
        emulate_dequant_gemm_tf32x3)
    monkeypatch.setattr(DK, "tf32x3_plan", lambda M, N, K: 4)
    rng = np.random.default_rng(11)
    x, tx = _arr(rng, (32, 1024), "float32")
    rw, tw = _packed(rng, (128, 1024), "float32", scale=0.1)
    bias, tbias = _arr(rng, (128,), "float32", 0.5)
    got = emulate_dequant_gemm_tf32x3(tx, tw, tbias, act)
    assert _rel_err(f32(got), r_ref(x, rw, bias, act)) < 1e-5
    assert _rel_err(f32(got), r_dequant_gemm(
        x, rw, bias, act, use_kernel=True, interpret=True)) < 1e-5


@pytest.mark.parametrize("spec,xs,ws", EINSUMS)
def test_tf32x3_emulation_in_the_model_layout(spec, xs, ws):
    """The model's layout ("kn"; padded q/k/v heads included) against
    ``jnp.einsum`` on the reference's ``dequantize`` within 1e-5, and
    against float64 within 2x the plain fp32 version."""
    from repro_torch.kernels.dequant_gemm.ref import (
        MODEL_SPECS, emulate_dequant_gemm_tf32x3)
    rng = np.random.default_rng(len(spec) + ws[-1] + 1)
    x, tx = _arr(rng, xs, "float32")
    rw, tw = _packed(rng, ws, "float32", group=32, scale=ws[0] ** -0.5)
    n_k = MODEL_SPECS[spec]
    got = emulate_dequant_gemm_tf32x3(tx, tw, n_k=n_k)
    dense = RQ.dequantize(rw)
    want = jnp.einsum(spec, x, dense)
    assert tuple(got.shape) == want.shape
    assert _rel_err(f32(got), want) < 1e-5
    K = int(np.prod(ws[:n_k]))
    x2 = np.asarray(x).reshape(-1, K)
    d2 = np.asarray(dense).reshape(K, -1)
    plain = quant_einsum(spec, tx, tw).reshape(-1, d2.shape[1])
    assert _f64_err(got.reshape(-1, d2.shape[1]), x2, d2, False) <= (
        2 * _f64_err(plain, x2, d2, False))
