"""The port's model against the reference's, same parameters (through
the bridge) and the same numpy inputs: teacher-forced prefill logits and
one decode step's logits, for reduced llava (VLM, qkv biases, projector),
reduced stablelm (LayerNorm, partial RoPE, plain weights), reduced
mamba2 (SSD mixers, conv tail and SSD state as the cache) and reduced
qwen2-vl (M-RoPE, untied packed head, single-region attention:
``attn_q_chunk=0``) and reduced llava with the paper's streaming linear
attention (``attn_impl="linear"``: the (state, z) caches per query
head), plus ``apply_mrope`` on three distinct position streams.

fp32 agrees within 1e-4 of the largest logit.  In bf16 both frameworks
round every activation to bf16, but at different points (and in
different summation orders), so the logits agree to about 1.5e-2 of the
largest logit on these configs; the test holds them to 5e-2.  The
reference runs under ``jax.jit``, as its serving engine runs it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32, shared_params
from repro.models import model as RM
from repro.models.common import apply_mrope
from repro_torch import bridge
from repro_torch.configs import get_config, list_archs, torch_dtype
from repro_torch.core.quantize import QTensor
from repro_torch.models import model as TM
from repro_torch.models.common import apply_mrope as port_apply_mrope

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ref_prefill = jax.jit(RM.lm_prefill, static_argnums=(1, 3))
ref_decode_step = jax.jit(RM.lm_decode_step, static_argnums=(1,))


def _rel_err(want, got):
    want, got = f32(want), f32(got)
    return float(np.abs(want - got).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,policy", [
    ("llava-onevision-0.5b", "nanomind-serve"), ("stablelm-1.6b", None),
    ("mamba2-1.3b", "nanomind-serve")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(arch, policy, dtype):
    rcfg, rparams, tcfg, tparams = shared_params(arch, dtype, policy)
    rng = np.random.default_rng(1)
    toks = rng.integers(3, rcfg.vocab_size, (2, 16)).astype(np.int32)
    feats = None
    if rcfg.vlm:
        feats = (rng.standard_normal((2, rcfg.vision_tokens,
                                      rcfg.vision_feat_dim)) * 0.02
                 ).astype(np.float32)
    rl, rcache = ref_prefill(
        rparams, rcfg, jnp.asarray(toks), 32,
        vision_feats=None if feats is None else jnp.asarray(feats))
    with torch.no_grad():
        tl, tcache = TM.lm_prefill(
            tparams, tcfg, torch.from_numpy(toks), 32,
            vision_feats=None if feats is None else torch.from_numpy(feats))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == rl.shape
    assert _rel_err(rl, tl) <= TOL[dtype]
    for r, t in zip(rcache["layers"][0], tcache["layers"][0]):
        assert tuple(t.shape) == r.shape
        assert _rel_err(r, t) <= TOL[dtype]
    nxt = np.array([[5], [7]], np.int32)
    rl2, _ = ref_decode_step(rparams, rcfg, jnp.asarray(nxt), rcache)
    with torch.no_grad():
        tl2, tc2 = TM.lm_decode_step(tparams, tcfg, torch.from_numpy(nxt),
                                     tcache)
    assert _rel_err(rl2, tl2) <= TOL[dtype]
    assert int(tc2["index"]) == 17


def test_init_cache_matches_reference_layout():
    from repro.configs import get_config as ref_config
    from repro.models import decoder as RD
    from repro_torch.configs import get_config
    from repro_torch.models import decoder as TD
    rcfg = ref_config("llava-onevision-0.5b").reduced()
    want = RD.init_cache(rcfg, 3, 16)
    got = TD.init_cache(get_config("llava-onevision-0.5b").reduced(), 3, 16,
                        "cpu")
    for w, g in zip(want[0], got[0]):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


@pytest.mark.parametrize("arch", list_archs())
def test_config_matches_reference(arch):
    """The port's own copy of each config, and its ``reduced()`` (which
    the parity tests run), field for field the reference's."""
    from repro.configs import get_config as ref_config
    for overrides in (None, {}, {"dtype": "float32", "attn_q_chunk": 0}):
        want, got = ref_config(arch), get_config(arch)
        if overrides is not None:
            want, got = want.reduced(**overrides), got.reduced(**overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(dtype):
    """Three different position streams, so a wrong section split shows:
    fp32 within 1e-6 of max|x|, bf16 within one bf16 step of max|x|."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 6, 3, 32)).astype(np.float32)
                    .astype(jnp.dtype(dtype)))
    pos = np.stack([rng.integers(0, n, (2, 6)) for n in (4, 600, 3000)]
                   ).astype(np.int32)
    assert len({tuple(p.ravel()) for p in pos}) == 3
    want = f32(apply_mrope(x, jnp.asarray(pos), 1e6))
    got = port_apply_mrope(bridge.array_to_tensor(np.asarray(x), device="cpu"),
                      torch.from_numpy(pos), 1e6)
    assert got.dtype == torch_dtype(dtype)
    m = float(np.abs(f32(x)).max())
    tol = 1e-6 * m if dtype == "float32" else 2.0 ** (np.floor(np.log2(m))
                                                        - 7)
    assert float(np.abs(want - f32(got)).max()) <= tol


@pytest.fixture(scope="module")
def qwen_reference():
    """Reduced qwen2-vl (fp32, nanomind-serve) run once by the reference
    with ``attn_q_chunk=0`` (its off-TPU stand-in for the flash kernel,
    ``dense_attention``): prefill with three distinct M-RoPE streams,
    then one decode step."""
    rcfg, rparams, tcfg, tparams = shared_params("qwen2-vl-7b", "float32",
                                                 "nanomind-serve")
    rcfg = dataclasses.replace(rcfg, attn_q_chunk=0)
    rng = np.random.default_rng(6)
    toks = rng.integers(3, rcfg.vocab_size, (2, 16)).astype(np.int32)
    feats = (rng.standard_normal((2, rcfg.vision_tokens,
                                  rcfg.vision_feat_dim)) * 0.02
             ).astype(np.float32)
    mrope = np.stack([np.broadcast_to(np.arange(16) * m, (2, 16))
                      for m in (0, 1, 3)]).astype(np.int32)
    nxt = np.array([[5], [7]], np.int32)
    rl, rcache = jax.jit(RM.lm_prefill, static_argnums=(1, 3))(
        rparams, rcfg, jnp.asarray(toks), 32,
        vision_feats=jnp.asarray(feats), mrope_positions=jnp.asarray(mrope))
    rl2, _ = ref_decode_step(rparams, rcfg, jnp.asarray(nxt), rcache)
    return tcfg, tparams, (toks, feats, mrope, nxt), (rl, rcache, rl2)


@pytest.mark.parametrize("q_chunk", [0, 512])
def test_qwen2_vl_logits_match_reference(qwen_reference, q_chunk):
    """The port's flash branch (``attn_q_chunk=0``; on the CPU the
    kernel's plain version) and its chunked branch both give the
    reference's single-region logits within 1e-4 of the largest logit;
    the head is the untied q4-packed ``lm_head``."""
    tcfg, tparams, (toks, feats, mrope, nxt), (rl, rcache, rl2) = \
        qwen_reference
    tcfg = dataclasses.replace(tcfg, attn_q_chunk=q_chunk)
    assert isinstance(tparams["lm_head"], QTensor)
    with torch.no_grad():
        tl, tcache = TM.lm_prefill(
            tparams, tcfg, torch.from_numpy(toks), 32,
            vision_feats=torch.from_numpy(feats),
            mrope_positions=torch.from_numpy(mrope))
        tl2, _ = TM.lm_decode_step(tparams, tcfg, torch.from_numpy(nxt),
                                   tcache)
    assert _rel_err(rl, tl) <= TOL["float32"]
    for r, t in zip(rcache["layers"][0], tcache["layers"][0]):
        assert _rel_err(r, t) <= TOL["float32"]
    assert _rel_err(rl2, tl2) <= TOL["float32"]


LINEAR = {"attn_impl": "linear", "subquadratic": True}


@pytest.mark.parametrize("dtype,seq", [("float32", 16), ("bfloat16", 16),
                                       ("float32", 512)])
def test_linear_attention_variant_matches_reference(dtype, seq):
    """Reduced llava with ``attn_impl="linear"`` (the reference test's
    variant), its ``nanomind-serve`` weights (llava's own tree): prefill
    logits, the (state, z) caches of every layer and one decode step's
    logits against the reference's.  At 512 positions the prefill runs
    two chunks of 256."""
    rcfg, rparams, tcfg, tparams = shared_params(
        "llava-onevision-0.5b", dtype, "nanomind-serve")
    rcfg = dataclasses.replace(rcfg, **LINEAR)
    tcfg = dataclasses.replace(tcfg, **LINEAR)
    rng = np.random.default_rng(7)
    toks = rng.integers(3, rcfg.vocab_size, (2, seq)).astype(np.int32)
    feats = (rng.standard_normal((2, rcfg.vision_tokens,
                                  rcfg.vision_feat_dim)) * 0.02
             ).astype(np.float32)
    nxt = np.array([[5], [7]], np.int32)
    rl, rcache = ref_prefill(rparams, rcfg, jnp.asarray(toks), seq + 16,
                             vision_feats=jnp.asarray(feats))
    rl2, rcache2 = ref_decode_step(rparams, rcfg, jnp.asarray(nxt), rcache)
    with torch.no_grad():
        tl, tcache = TM.lm_prefill(tparams, tcfg, torch.from_numpy(toks),
                                   seq + 16,
                                   vision_feats=torch.from_numpy(feats))
        tl2, tcache2 = TM.lm_decode_step(tparams, tcfg,
                                         torch.from_numpy(nxt), tcache)
    L, H, hd = tcfg.n_layers, tcfg.n_heads, tcfg.hd
    assert _rel_err(rl, tl) <= TOL[dtype]
    assert _rel_err(rl2, tl2) <= TOL[dtype]
    for want, got in ((rcache, tcache), (rcache2, tcache2)):
        (rs, rz), (ts, tz) = want["layers"][0], got["layers"][0]
        assert tuple(ts.shape) == rs.shape == (L, 2, H, hd, hd)
        assert tuple(tz.shape) == rz.shape == (L, 2, H, hd)
        assert ts.dtype == tz.dtype == torch.float32
        assert _rel_err(rs, ts) <= TOL[dtype]
        assert _rel_err(rz, tz) <= TOL[dtype]


def test_linear_init_cache_matches_reference_layout():
    from repro.configs import get_config as ref_config
    from repro.models import decoder as RD
    from repro_torch.models import decoder as TD
    arch = "llava-onevision-0.5b"
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **LINEAR)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **LINEAR)
    want = RD.init_cache(rcfg, 3, 16)
    got = TD.init_cache(tcfg, 3, 16, "cpu")
    for w, g in zip(want[0], got[0]):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
