"""The port's model against the reference's, same parameters (through
the bridge) and the same numpy inputs: teacher-forced prefill logits and
one decode step's logits, for reduced llava (VLM, qkv biases, projector)
and reduced stablelm (LayerNorm, partial RoPE, plain weights).

fp32 agrees within 1e-4 of the largest logit.  In bf16 both frameworks
round every activation to bf16, but at different points (and in
different summation orders), so the logits agree to about 1.5e-2 of the
largest logit on these configs; the test holds them to 5e-2.  The
reference runs under ``jax.jit``, as its serving engine runs it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32, shared_params
from repro.models import model as RM
from repro_torch.models import model as TM

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ref_prefill = jax.jit(RM.lm_prefill, static_argnums=(1, 3))
ref_decode_step = jax.jit(RM.lm_decode_step, static_argnums=(1,))


def _rel_err(want, got):
    want, got = f32(want), f32(got)
    return float(np.abs(want - got).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,policy", [
    ("llava-onevision-0.5b", "nanomind-serve"), ("stablelm-1.6b", None)])
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
