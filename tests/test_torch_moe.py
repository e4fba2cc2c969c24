"""The port's mixture of experts (``models/moe.py``) and the five configs
of its slice against the reference's, on the CPU.

The weights come from the port's ``init_params`` (seed 0) and cross to
the reference through the bridge; inputs are numpy draws from seeds.

* ``capacity`` equals the reference's at every group size and both
  capacity factors.
* ``router_logits`` (a float64 product rounded to fp32) does not depend
  on the call's row count.
* ``route`` on fp32 logits: the top-k indices and the dispatch (which
  expert, which position, which choices were dropped) equal the
  reference's exactly; the combine weights within 1e-6 and the aux loss
  within 1e-6 of its size.  The two CPU backends' ``exp`` differ by one
  ulp, so the weights cannot be bit-equal; each case asserts that its
  logits have no near-tie (the k-th and the next probability at least
  1e-6 apart), so the indices cannot flip.
* ``apply_moe`` (``valid=None``) against the reference's, in fp32 within
  1e-5 and in bf16 within 2e-2 of the largest output, at the reference's
  capacity factor 1.25 (drops asserted to occur) and at 8.0 (none); with
  packed experts bit-equal to the same weights dequantized.
* The masked routing (``valid``): all-valid equals ``valid=None``,
  invalid tokens get the shared experts alone, a prompt routes the same
  at every padded width and beside any other row in its call, and a
  batch of 384 tokens (three 128-token rows) runs where the reference
  raises.
* The expert contractions' plain versions are ``dequantize`` + einsum
  bit for bit, and the fp32 route's emulation with the expert axis stays
  within 1e-5 of the reference's einsum and within 2x the plain fp32
  version's error against float64.
* ``lm_prefill`` and one decode step for each of the five new configs,
  and decode against teacher forcing at capacity factor 8.0.
* ``init_params(policy=)`` packs the stacked expert leaves as they are
  made and equals ``quantize_tree`` of the dense tree; the 4-D packed
  leaves cross the bridge both ways and slice with ``QTensor.layer``.
* ``count_params_analytic(cfg, active_only)`` and ``_brick_flops`` equal
  the reference's for every arch of both registries.
* Faults of the reference the port's masked routing repairs (ROADMAP
  §3), each shown on the reference: right pads route and take capacity,
  so a prompt's last logits depend on its bucket; 384 tokens raise;
  the full-width ``nanomind-serve`` router is packed to q4; a cohort of
  8 decode rows drops tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (f32, flat, from_numpy_to_ref, shared_params,
                           to_port)
from repro.configs import get_config as ref_config
from repro.configs import list_archs as ref_archs
from repro.core import quantize as RQ
from repro.models import model as RM
from repro.models import moe as RMOE
from repro_torch import bridge
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig
from repro_torch.core.quantize import (PROFILES, QTensor, dequantize,
                                       dequantize_tree, quantize_tree)
from repro_torch.kernels.dequant_gemm import quant_einsum
from repro_torch.kernels.dequant_gemm.ref import (
    EXPERT_SPECS, emulate_dequant_gemm_tf32x3)
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.mlp import apply_mlp

NEW_ARCHS = ("stablelm-12b", "nemotron-4-15b", "deepseek-67b",
             "deepseek-moe-16b", "dbrx-132b")
MOE_ARCHS = ("deepseek-moe-16b", "dbrx-132b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ref_prefill = jax.jit(RM.lm_prefill, static_argnums=(1, 3))
ref_decode_step = jax.jit(RM.lm_decode_step, static_argnums=(1,))


def _rel_err(want, got):
    want, got = f32(want), f32(got)
    return float(np.abs(want - got).max() / np.abs(want).max())


def _moe_cfgs(arch, dtype, capacity_factor=1.25):
    """(reference cfg, port cfg) reduced, at ``capacity_factor``."""
    out = []
    for get in (ref_config, get_config):
        cfg = get(arch).reduced(dtype=dtype)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor)))
    return out


def _moe_params(cfg, dtype):
    """One reduced MoE FFN (unstacked) from the port's init, and the
    reference's copy through the bridge."""
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        p = TMOE.init_moe(gen, cfg, cfg.d_model, "cpu")
    return p, from_numpy_to_ref(bridge.to_numpy(p))


def _skewed_x(p, shape, dtype, seed, skew):
    """Inputs with a component along the router's first column, so that
    most tokens pick expert 0 and a capacity factor of 1.25 drops."""
    rng = np.random.default_rng(seed)
    r0 = p["router"][:, 0].numpy().astype(np.float64)
    x = rng.standard_normal(shape) + skew * r0 / np.linalg.norm(r0) * 4
    x = jnp.asarray(x.astype(np.float32)).astype(dtype)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _min_gap(logits, k):
    """The smallest gap between the k-th and the (k+1)-th probability of
    any token, in float64."""
    z = np.asarray(logits, np.float64)
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    s = -np.sort(-p, axis=-1)
    return float((s[..., k - 1] - s[..., k]).min()) if k < z.shape[-1] \
        else 1.0


# -- capacity and routing ------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("gs", [1, 8, 100, 256])
def test_capacity_matches_reference(arch, reduced, gs):
    for cf in (1.25, 8.0):
        r, t = (get(arch) for get in (ref_config, get_config))
        if reduced:
            r, t = r.reduced(), t.reduced()
        rm = dataclasses.replace(r.moe, capacity_factor=cf)
        tm = dataclasses.replace(t.moe, capacity_factor=cf)
        assert TMOE.capacity(tm, gs) == RMOE.capacity(rm, gs)
    assert TMOE.GROUP_SIZE == RMOE.GROUP_SIZE


@pytest.mark.parametrize("G,S,E,k,cap", [
    (2, 64, 4, 2, 4), (2, 64, 4, 2, 40), (4, 256, 64, 6, 30),
    (1, 8, 64, 6, 4), (1, 8, 4, 2, 5), (3, 32, 16, 4, 20)])
def test_route_matches_reference(G, S, E, k, cap):
    rng = np.random.default_rng(G * 1000 + S + E + k)
    logits = (rng.standard_normal((G, S, E)) * 2).astype(np.float32)
    assert _min_gap(logits, k) >= 1e-6
    rc, rd, ra = RMOE.route(jnp.asarray(logits), k, cap)
    tl = torch.from_numpy(logits)
    tc, td, ta = TMOE.route(tl, k, cap)
    _, _, idx, keep, _, _ = TMOE.choices(tl, k, cap)
    _, ridx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), k)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert td.dtype == torch.bfloat16
    assert np.array_equal(td.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(rd).view(np.uint16))
    assert np.abs(tc.numpy() - np.asarray(rc)).max() <= 1e-6
    assert abs(float(ta) - float(ra)) <= 1e-6 * abs(float(ra))
    # the dispatch holds exactly the kept choices, each at one position
    assert int(td.float().sum()) == int(keep.sum())
    if cap * E < S * k:
        assert not bool(keep.all())


def test_router_logits_do_not_depend_on_the_row_count():
    """A float64 product rounded once to fp32: the same groups give the
    same logits bit for bit in a call of 2 groups and one of 8, and the
    logits are the fp32 rounding of the exact product."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((8, 256, 512)).astype(
        np.float32)).to(torch.bfloat16)
    r = torch.from_numpy((rng.standard_normal((512, 64)) * 512 ** -0.5)
                         .astype(np.float32))
    two, eight = TMOE.router_logits(x[:2], r), TMOE.router_logits(x, r)
    assert two.dtype == torch.float32
    assert torch.equal(two, eight[:2])
    exact = np.einsum("gsd,de->gse", x.double().numpy(), r.double().numpy())
    assert np.array_equal(two.numpy(), exact[:2].astype(np.float32))


def test_route_masks_tokens_out_of_the_capacity():
    """A masked token chooses nothing: the others' positions are those of
    the same tokens routed without it."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((1, 32, 4))
                              .astype(np.float32))
    mask = torch.ones((1, 32), dtype=torch.bool)
    mask[0, ::3] = False
    comb, disp, _ = TMOE.route(logits, 2, 6, mask)
    assert not disp[0, ~mask[0]].any()
    sub, _, _ = TMOE.route(logits[:, mask[0]], 2, 6)
    assert torch.equal(comb[:, mask[0]], sub)


# -- apply_moe -----------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_apply_moe_matches_reference(arch, dtype, cf):
    rcfg, tcfg = _moe_cfgs(arch, dtype, cf)
    p, rp = _moe_params(tcfg, dtype)
    x, tx = _skewed_x(p, (2, 256, tcfg.d_model), dtype, seed=3, skew=1.0)
    # routing decisions of the first layer, from the same fp32 logits
    logits = np.array(jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                 rp["router"])).reshape(2, 256, -1)
    assert _min_gap(logits, tcfg.moe.top_k) >= 1e-6
    _, _, _, keep, _, _ = TMOE.choices(
        torch.from_numpy(logits), tcfg.moe.top_k,
        TMOE.capacity(tcfg.moe, 256))
    assert bool(keep.all()) == (cf == 8.0)        # 1.25 drops, 8.0 not
    ry, raux = RMOE.apply_moe(rp, rcfg, x)
    with torch.no_grad():
        ty, taux = TMOE.apply_moe(p, tcfg, tx)
    assert ty.dtype == tx.dtype and tuple(ty.shape) == ry.shape
    assert _rel_err(ry, ty) <= TOL[dtype]
    assert abs(float(taux) - float(raux)) <= 1e-5 * abs(float(raux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_packed_experts_equal_their_dequantized_weights(dtype):
    _, tcfg = _moe_cfgs("deepseek-moe-16b", dtype)
    p, _ = _moe_params(tcfg, dtype)
    packed = quantize_tree(p, PROFILES["all-q4"])
    assert all(isinstance(packed[n], QTensor)
               for n in ("w_up", "w_gate", "w_down"))
    _, tx = _skewed_x(p, (2, 128, tcfg.d_model), dtype, seed=4, skew=0.5)
    with torch.no_grad():
        got, _ = TMOE.apply_moe(packed, tcfg, tx)
        want, _ = TMOE.apply_moe(dequantize_tree(packed), tcfg, tx)
    assert torch.equal(got, want)


def test_masked_routing_all_valid_and_invalid_tokens():
    _, tcfg = _moe_cfgs("deepseek-moe-16b", "float32")
    p, _ = _moe_params(tcfg, "float32")
    _, tx = _skewed_x(p, (2, 256, tcfg.d_model), "float32", seed=6, skew=1.0)
    valid = torch.ones((2, 256), dtype=torch.bool)
    with torch.no_grad():
        y0, _ = TMOE.apply_moe(p, tcfg, tx)
        y1, _ = TMOE.apply_moe(p, tcfg, tx, valid)
        assert torch.equal(y0, y1)
        valid[1, 200:] = False
        valid[0, ::7] = False
        y2, _ = TMOE.apply_moe(p, tcfg, tx, valid)
        shared = apply_mlp(p["shared"], tcfg.act, tx)
    assert torch.equal(y2[~valid], shared[~valid])
    assert not torch.equal(y2[valid], shared[valid])


@pytest.mark.parametrize("n,widths", [(100, (100, 128, 256, 512)),
                                      (300, (300, 512, 1024))])
def test_masked_routing_does_not_depend_on_the_padded_width(n, widths):
    """A prompt's tokens route the same and get the same outputs at every
    width it is right-padded to (the engine's buckets), with the pads
    marked invalid: the groups are GROUP_SIZE tokens whatever the width."""
    _, tcfg = _moe_cfgs("deepseek-moe-16b", "float32", 1.0)
    p, _ = _moe_params(tcfg, "float32")
    _, tx = _skewed_x(p, (1, n, tcfg.d_model), "float32", seed=7, skew=1.0)
    outs = []
    with torch.no_grad():
        for w in widths:
            xp = torch.nn.functional.pad(tx, (0, 0, 0, w - n))
            valid = torch.arange(w)[None] < n
            outs.append(TMOE.apply_moe(p, tcfg, xp, valid)[0][:, :n])
    for o in outs[1:]:
        assert _rel_err(outs[0], o) <= 1e-6


def test_masked_routing_does_not_depend_on_the_other_rows(monkeypatch):
    """Two 100-token requests in one 128-token prefill bucket route and
    give the same outputs as each one alone: every row is padded to
    whole groups of its own, so no group holds two rows and neither takes
    the other's capacity."""
    _, tcfg = _moe_cfgs("deepseek-moe-16b", "float32")
    p, _ = _moe_params(tcfg, "float32")
    _, tx = _skewed_x(p, (2, 128, tcfg.d_model), "float32", seed=11,
                      skew=1.0)
    valid = torch.arange(128)[None].expand(2, -1) < 100
    log, inner = [], TMOE.choices

    def logged(logits, top_k, cap, mask=None):
        out = inner(logits, top_k, cap, mask)
        log.append((out[2], out[3]))
        return out
    monkeypatch.setattr(TMOE, "choices", logged)
    with torch.no_grad():
        both, _ = TMOE.apply_moe(p, tcfg, tx, valid)
        both_route = log.pop()
        for b in range(2):
            alone, _ = TMOE.apply_moe(p, tcfg, tx[b:b + 1, :100],
                                      torch.ones((1, 100), dtype=torch.bool))
            idx, keep = log.pop()
            assert torch.equal(both_route[0][b, :100], idx[0, :100])
            assert torch.equal(both_route[1][b, :100], keep[0, :100])
            assert _rel_err(alone, both[b:b + 1, :100]) <= 1e-6
        # the witness: in one group over both rows (the reference's
        # flattened groups) the second row's choices come after the
        # first's and more of them are dropped
        shared_group, _ = TMOE.apply_moe(p, tcfg, tx)
        shared_keep = log.pop()[1].reshape(2, 128, -1)
    assert (~shared_keep[1, :100]).sum() > (~both_route[1][1, :100]).sum()
    assert _rel_err(alone, shared_group[1:, :100]) > 1e-3


def test_moe_runs_384_tokens_where_the_reference_raises():
    """Three 128-token rows (N = 384, over 256 and no multiple of it):
    the reference's reshape raises; the port pads to two groups, the
    first two rows route as the reference routes them alone and the third
    as it routes in a masked group of its own."""
    rcfg, tcfg = _moe_cfgs("deepseek-moe-16b", "float32")
    p, rp = _moe_params(tcfg, "float32")
    x, tx = _skewed_x(p, (3, 128, tcfg.d_model), "float32", seed=8, skew=1.0)
    with pytest.raises(TypeError):
        RMOE.apply_moe(rp, rcfg, x)
    with torch.no_grad():
        y, _ = TMOE.apply_moe(p, tcfg, tx)
        alone, _ = TMOE.apply_moe(p, tcfg, tx[2:],
                                  torch.ones((1, 128), dtype=torch.bool))
    assert y.isfinite().all() and tuple(y.shape) == (3, 128, tcfg.d_model)
    ry, _ = RMOE.apply_moe(rp, rcfg, x[:2])
    assert _rel_err(ry, y[:2]) <= 1e-5
    assert _rel_err(alone, y[2:]) <= 1e-6


# -- the expert contractions ----------------------------------------------------

def _expert_operands(rng, spec, dtype, G=2, E=4, C=8, K=256, N=96):
    xs = (G, E, C, K)
    x = jnp.asarray(rng.standard_normal(xs).astype(np.float32)).astype(dtype)
    w = jnp.asarray((rng.standard_normal((E, K, N)) * K ** -0.5).astype(
        np.float32)).astype(dtype)
    rw = RQ.quantize(w, RQ.QuantSpec(4, group_size=32))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return x, tx, rw, to_port(rw)


@pytest.mark.parametrize("spec", EXPERT_SPECS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_expert_contraction_plain_is_dequantize_and_einsum(spec, dtype):
    rng = np.random.default_rng(len(spec) + (dtype == "float32"))
    x, tx, rw, tw = _expert_operands(rng, spec, dtype)
    assert tuple(tw.codes.shape) == (4, 256, 96 // 8)
    got = quant_einsum(spec, tx, tw)
    dense = dequantize(tw)
    assert torch.equal(got, torch.einsum(spec, tx, dense))
    want = jnp.einsum(spec, x, RQ.dequantize(rw))
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    assert _rel_err(want, got) <= (1e-6 if dtype == "float32" else 5e-3)


@pytest.mark.parametrize("spec", EXPERT_SPECS)
@pytest.mark.parametrize("splits", [None, 3])
def test_tf32x3_emulation_with_the_expert_axis(spec, splits, monkeypatch):
    """The fp32 route over the expert axis (each expert's G * C rows one
    product, the split of K planned over all experts' tiles): within 1e-5
    of the reference's einsum, and against float64 within 2x the plain
    fp32 version's error."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    if splits is not None:
        monkeypatch.setattr(DK, "tf32x3_plan", lambda M, N, K, E=1: splits)
    rng = np.random.default_rng(21 + len(spec))
    x, tx, rw, tw = _expert_operands(rng, spec, "float32", K=512)
    got = emulate_dequant_gemm_tf32x3(tx, tw, experts=True)
    dense = RQ.dequantize(rw)
    want = jnp.einsum(spec, x, dense)
    assert tuple(got.shape) == want.shape
    assert _rel_err(want, got) < 1e-5
    f64 = np.einsum(spec, np.asarray(x, np.float64),
                    np.asarray(dense, np.float64))

    def err(t):
        return float(np.abs(f32(t).astype(np.float64) - f64).max()
                     / np.abs(f64).max())
    assert err(got) <= 2 * err(quant_einsum(spec, tx, tw))


def test_tf32x3_plan_counts_every_experts_tiles():
    from repro_torch.kernels.dequant_gemm import kernel as DK
    assert DK.tf32x3_plan(120, 1408, 2048, 1) > 1
    assert DK.tf32x3_plan(120, 1408, 2048, 64) == 1
    assert DK.tf32x3_plan(240, 2048, 1408, 64) == 1


def test_expert_weights_take_the_wgmma_kernel():
    """The served expert shapes route to the warp-specialised kernel in
    bf16 (DeepSeek-MoE-16B's 2048 <-> 1408, DBRX's 6144 <-> 10752), the
    tile kernel where N is no multiple of 64, tf32x3 in fp32."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        D, F = cfg.d_model, cfg.moe.d_ff_expert
        for K, N in ((D, F), (F, D)):
            assert DK.route(torch.bfloat16, K, N, 32, DK.KN, N, N, N // 8,
                            True) == "wgmma"
            assert DK.route(torch.float32, K, N, 32, DK.KN, N, N, N // 8,
                            True) == "tf32x3"
    assert DK.route(torch.bfloat16, 256, 96, 32, DK.KN, 96, 96, 12,
                    True) == "tile"


# -- the model ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(arch, dtype):
    rcfg, rparams, tcfg, tparams = shared_params(arch, dtype,
                                                 "nanomind-serve")
    rng = np.random.default_rng(1)
    toks = rng.integers(3, rcfg.vocab_size, (2, 16)).astype(np.int32)
    rl, rcache = ref_prefill(rparams, rcfg, jnp.asarray(toks), 32)
    with torch.no_grad():
        tl, tcache = TM.lm_prefill(tparams, tcfg, torch.from_numpy(toks), 32)
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert tl.dtype == torch.float32 and tuple(tl.shape) == rl.shape
    assert _rel_err(rl, tl) <= tol
    nxt = np.array([[5], [7]], np.int32)
    rl2, _ = ref_decode_step(rparams, rcfg, jnp.asarray(nxt), rcache)
    with torch.no_grad():
        tl2, _ = TM.lm_decode_step(tparams, tcfg, torch.from_numpy(nxt),
                                   tcache)
    assert _rel_err(rl2, tl2) <= tol


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_teacher_forcing(arch, dtype):
    """Greedy decode logits against the prefill logits of the same prefix,
    as the reference's test holds its own (capacity factor 8.0, so that a
    (B, S) forward and a (B, 1) step route alike): the same top-1, fp32
    within 1e-4 of the largest logit, bf16 within the reference test's
    rtol 0.1 / atol 0.35."""
    tcfg = _moe_cfgs(arch, dtype, 8.0)[1]
    params = TM.init_params(tcfg, device="cpu", seed=0)
    S, extra = 24, 4
    tokens = (torch.arange(S + extra).reshape(1, -1) % 50 + 3).to(
        torch.int32)
    with torch.no_grad():
        _, cache = TM.lm_prefill(params, tcfg, tokens[:, :S], S + extra + 1)
        for t in range(S, S + extra):
            got, cache = TM.lm_decode_step(params, tcfg,
                                           tokens[:, t:t + 1], cache)
            want, _ = TM.lm_prefill(params, tcfg, tokens[:, :t + 1], t + 1)
            g, w = (f32(a)[0, :tcfg.vocab_size] for a in (got, want))
            assert g.argmax() == w.argmax()
            if dtype == "float32":
                assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
            else:
                np.testing.assert_allclose(g, w, rtol=0.1, atol=0.35)


def test_init_params_packs_the_experts_as_they_are_made():
    cfg = get_config("deepseek-moe-16b").reduced()
    policy = PROFILES["nanomind-serve"]
    want = quantize_tree(TM.init_params(cfg, device="cpu", seed=0), policy)
    got = TM.init_params(cfg, device="cpu", seed=0, policy=policy)
    wl, gl = (bridge.to_numpy(t) for t in (want, got))
    fw, fg = flat(wl), flat(gl)
    assert fw.keys() == fg.keys()
    for k in fw:
        assert np.array_equal(np.asarray(fw[k]), np.asarray(fg[k])), k
    ffn = got["layers"][0]["ffn"]
    L, E, D, Fe = (cfg.n_layers, cfg.moe.n_experts, cfg.d_model,
                   cfg.moe.d_ff_expert)
    assert isinstance(ffn["w_up"], QTensor)
    assert tuple(ffn["w_up"].codes.shape) == (L, E, D, Fe // 8)
    assert tuple(ffn["w_down"].shape) == (L, E, Fe, D)
    # the reduced router (2 x 128 x 4) stays fp32 under the policy
    assert ffn["router"].dtype == torch.float32


def test_stacked_expert_leaves_cross_the_bridge_and_slice():
    cfg = get_config("deepseek-moe-16b").reduced()
    params = TM.init_params(cfg, device="cpu", seed=0,
                            policy=PROFILES["nanomind-serve"])
    w = params["layers"][0]["ffn"]["w_gate"]
    back = bridge.from_numpy(bridge.to_numpy({"w": w}), device="cpu")["w"]
    assert torch.equal(back.codes, w.codes)
    assert torch.equal(back.scales, w.scales)
    assert back.shape == w.shape and back.dtype == w.dtype
    rq = from_numpy_to_ref(bridge.to_numpy(w))
    assert np.array_equal(np.asarray(RQ.dequantize(rq).astype(jnp.float32)),
                          f32(dequantize(w)))
    again = to_port(rq)
    assert torch.equal(again.codes, w.codes)
    for i in range(cfg.n_layers):
        layer = w.layer(i)
        assert tuple(layer.shape) == tuple(w.shape[1:])
        assert torch.equal(dequantize(layer), dequantize(w)[i])


# -- the parameter count the scheduler prices ---------------------------------------

def _port_cfg(rcfg):
    """The reference's config as the port's dataclass (the port has no
    Jamba or Seamless module, but its count covers every layout)."""
    d = dataclasses.asdict(rcfg)
    d["moe"] = MoEConfig(**d["moe"]) if d["moe"] else None
    d["ssm"] = SSMConfig(**d["ssm"]) if d["ssm"] else None
    d["vision_token_buckets"] = tuple(d["vision_token_buckets"])
    return ModelConfig(**d)


@pytest.mark.parametrize("arch", sorted(set(ref_archs()) | set(list_archs())))
@pytest.mark.parametrize("active_only", [False, True])
def test_count_params_and_brick_flops_match_reference(arch, active_only):
    from repro.core.bricks import _brick_flops as r_flops
    from repro_torch.core.bricks import _brick_flops as t_flops
    rcfg = ref_config(arch)
    tcfg = get_config(arch) if arch in list_archs() else _port_cfg(rcfg)
    for r, t in ((rcfg, tcfg), (rcfg.reduced(), tcfg.reduced())):
        assert TM.count_params_analytic(t, active_only) == \
            RM.count_params_analytic(r, active_only)
        for kind in ("embed", "head", "decoder", "projector", "encoder",
                     "frontend"):
            assert t_flops(t, kind) == r_flops(r, kind)


# -- faults of the reference that the port's masked routing repairs ----------------

def _ref_prefill_last(eng, tokens, n, width):
    """The reference engine's bucket prefill (``engine.py:1030``): the
    prompt right-padded with token 0 to ``width``, logits at n - 1."""
    padded = np.zeros((1, width), np.int32)
    padded[0, :n] = tokens[:n]
    logits, _ = eng._prefill_fn(width)(eng.params, jnp.asarray(padded),
                                       None, jnp.asarray([n], jnp.int32))
    return f32(logits)


def test_reference_fault_right_pads_take_capacity():
    """The reference routes the right pads (token 0) and lets them take
    capacity, so a prompt's last logits depend on its prefill bucket; the
    port's engine prefill masks them, and the groups keep GROUP_SIZE
    tokens, so the same prompt gives the same logits in both buckets."""
    from repro_torch.serving.engine import ServingEngine
    rcfg, rparams, tcfg, tparams = shared_params("deepseek-moe-16b",
                                                 "float32")
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    from repro.serving.engine import ServingEngine as RServingEngine
    toks = np.random.default_rng(9).integers(3, 500, 100).astype(np.int32)
    with RServingEngine(rcfg, rparams, n_slots=1, max_len=512) as reng:
        a, b = (_ref_prefill_last(reng, toks, 100, w) for w in (128, 256))
    assert np.abs(a - b).max() > 1e-3 * np.abs(a).max()
    eng = ServingEngine(tcfg, tparams, n_slots=1, max_len=512,
                        block_size=32, device="cpu")
    got = []
    for w in (128, 256):
        padded = torch.zeros((1, w), dtype=torch.int32)
        padded[0, :100] = torch.from_numpy(toks)
        logits, _ = eng._prefill(padded, None, torch.tensor([100]))
        got.append(f32(logits))
    eng.shutdown()
    assert np.abs(got[0] - got[1]).max() <= 1e-5 * np.abs(got[0]).max()
    with torch.no_grad():
        unpadded, _ = TM.lm_prefill(tparams, tcfg, torch.from_numpy(
            toks[None]), 128, valid_len=torch.tensor([100]))
    assert np.abs(got[0] - f32(unpadded)).max() <= 1e-5 * np.abs(got[0]).max()


def test_reference_fault_router_packed_at_full_width():
    """``nanomind-serve`` packs the stacked router at full width (28 x
    2048 x 64 = 3.67 M elements, over ``min_size``, under ``layers``), so
    the reference's routing runs on q4 router weights; the reduced router
    (2 x 128 x 4) stays fp32.  The port keeps the policy."""
    policy = RQ.PROFILES["nanomind-serve"]
    cfg = ref_config("deepseek-moe-16b")
    full = (cfg.n_layers, cfg.d_model, cfg.moe.n_experts)
    assert np.prod(full) >= policy.min_size
    tree = {"layers": ({"ffn": {"router": jnp.zeros(full, jnp.float32)}},)}
    packed = RQ.quantize_tree(tree, policy)
    assert isinstance(packed["layers"][0]["ffn"]["router"], RQ.QTensor)
    assert packed["layers"][0]["ffn"]["router"].spec.bits == 4
    small = {"layers": ({"ffn": {"router": jnp.zeros((2, 128, 4),
                                                       jnp.float32)}},)}
    assert not isinstance(RQ.quantize_tree(small, policy)["layers"][0]
                          ["ffn"]["router"], RQ.QTensor)
    port = quantize_tree({"layers": ({"ffn": {"router": torch.zeros(
        full, dtype=torch.float32)}},)}, PROFILES["nanomind-serve"])
    assert isinstance(port["layers"][0]["ffn"]["router"], QTensor)


def test_reference_fault_cohort_of_eight_drops_tokens():
    """A decode cohort is routed as one group of its rows: at 8 rows the
    reference's capacity is max(4, ...) and eight rows on the same experts
    overflow it, so rows are not independent (its engine's "Rows are
    independent").  The port's masked decode pads each row to a group of
    GROUP_SIZE of its own: every row gets what it gets alone."""
    rcfg, tcfg = _moe_cfgs("deepseek-moe-16b", "float32")
    p, rp = _moe_params(tcfg, "float32")
    _, tx1 = _skewed_x(p, (1, 1, tcfg.d_model), "float32", seed=10, skew=0.)
    x8 = np.repeat(np.asarray(f32(tx1)), 8, axis=0)
    assert RMOE.capacity(rcfg.moe, 8) < 8
    ry8, _ = RMOE.apply_moe(rp, rcfg, jnp.asarray(x8))
    ry1, _ = RMOE.apply_moe(rp, rcfg, jnp.asarray(x8[:1]))
    assert np.abs(f32(ry8)[5:] - f32(ry1)).max() > 1e-3
    with torch.no_grad():
        ty8, _ = TMOE.apply_moe(p, tcfg, torch.from_numpy(x8),
                                torch.ones((8, 1), dtype=torch.bool))
        ty1, _ = TMOE.apply_moe(p, tcfg, tx1)
    assert np.abs(f32(ty8) - f32(ty1)).max() <= 1e-6 * np.abs(f32(ty1)).max()
