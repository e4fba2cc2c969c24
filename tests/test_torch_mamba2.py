"""The port's Mamba-2 against the reference's, same parameters (through
the bridge) and the same numpy inputs, on reduced ``mamba2-1.3b`` (2
layers, d 128, 16 SSD heads of 16, state 16, chunk 32).

* the mixer (``mamba_forward``, then ``mamba_decode`` from its state);
* ``mamba_forward(valid_len=...)`` on right-padded rows against the
  reference's ``mamba_forward`` on each row cut to its true length;
* the composed cohort step over a slot-state pool (sentinel row
  included) against the reference's ``ref_cohort_step``;
* cache layouts, decode-state entry, init shapes and the analytic
  parameter count.

fp32: within 1e-4 of the largest magnitude.  bf16: both packages round
the same intermediates to bf16 but sum in different orders, so an output
may differ by one bf16 step of its largest magnitude (the rule of
``test_torch_model.py``'s M-RoPE test); the fp32 SSD state keeps 1e-4;
logits after the whole stack keep the model tests' 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bits, f32, flat, jax_to_numpy, shared_params
from repro.configs import get_config as ref_config
from repro.kernels.fused_decode.ref import ref_cohort_step
from repro.models import decoder as RD
from repro.models import mamba2 as RM2
from repro.models import model as RM
from repro_torch import bridge
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.fused_decode import cohort_step
from repro_torch.models import decoder as TD
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM

ARCH = "mamba2-1.3b"


def _rel_err(want, got):
    want, got = f32(want), f32(got)
    return float(np.abs(want - got).max() / np.abs(want).max())


def _check(want, got, dtype):
    """fp32 within 1e-4 of max|want|; bf16 within one bf16 step of it."""
    want, got = f32(want), f32(got)
    assert want.shape == got.shape
    m = float(np.abs(want).max())
    tol = 1e-4 * m if dtype == "float32" else 2.0 ** (np.floor(np.log2(m))
                                                        - 7)
    assert float(np.abs(want - got).max()) <= tol


def _mixers(dtype):
    """Layer 0's mixer params, reference and port (the same weights)."""
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, dtype)
    rp = jax.tree.map(lambda l: l[0], rparams["layers"][0]["mixer"])
    tp = TD.layer_slice(tparams["layers"], 0)[0]["mixer"]
    return rcfg, rp, tcfg, tp


def _hidden(rng, shape, dtype):
    return rng.standard_normal(shape).astype(np.float32).astype(
        jnp.dtype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_forward_then_decode_match_reference(dtype):
    rcfg, rp, tcfg, tp = _mixers(dtype)
    rng = np.random.default_rng(0)
    x = _hidden(rng, (2, 64, rcfg.d_model), dtype)
    ro, (rtail, rh) = RM2.mamba_forward(rp, rcfg, jnp.asarray(x))
    with torch.no_grad():
        to, (ttail, th) = TM2.mamba_forward(
            tp, tcfg, bridge.array_to_tensor(x, device="cpu"))
    _check(ro, to, dtype)
    _check(rtail, ttail, dtype)
    assert th.dtype == torch.float32 and _rel_err(rh, th) < 1e-4
    for step in range(2):
        xn = _hidden(rng, (2, 1, rcfg.d_model), dtype)
        ro, (rtail, rh) = RM2.mamba_decode(rp, rcfg, jnp.asarray(xn), rtail,
                                           rh)
        with torch.no_grad():
            to, (ttail, th) = TM2.mamba_decode(
                tp, tcfg, bridge.array_to_tensor(xn, device="cpu"), ttail, th)
        _check(ro, to, dtype)
        _check(rtail, ttail, dtype)
        assert _rel_err(rh, th) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_valid_len_matches_reference_on_the_truncated_input(dtype):
    """Rows right-padded to 64 with true lengths 64, 32, 20 and 2: the
    outputs before each row's end, its conv tail and its SSD state equal
    the reference's on the row cut to its length (a 2-token row's tail
    has a zero row before position 0, the causal conv's own padding)."""
    rcfg, rp, tcfg, tp = _mixers(dtype)
    rng = np.random.default_rng(1)
    lens = [64, 32, 20, 2]
    x = _hidden(rng, (len(lens), 64, rcfg.d_model), dtype)
    with torch.no_grad():
        to, (ttail, th) = TM2.mamba_forward(
            tp, tcfg, bridge.array_to_tensor(x, device="cpu"),
            valid_len=torch.tensor(lens, dtype=torch.int32))
    for b, n in enumerate(lens):
        ro, (rtail, rh) = RM2.mamba_forward(rp, rcfg, jnp.asarray(x[b:b + 1,
                                                                    :n]))
        _check(ro, to[b:b + 1, :n], dtype)
        k = rtail.shape[1]               # min(n, d_conv - 1) rows
        _check(rtail, ttail[b:b + 1, -k:], dtype)
        assert not ttail[b, :ttail.shape[1] - k].any()
        assert _rel_err(rh, th[b:b + 1]) < 1e-4


@pytest.mark.parametrize("dtype,bc", [("float32", 1), ("float32", 2),
                                      ("float32", 4), ("bfloat16", 4)])
def test_cohort_step_over_slot_state_matches_reference(dtype, bc):
    """The composed step gathers each row's state by slot, decodes, and
    writes the new state back by slot, in place; the sentinel slot
    (n_slots) reads zeros and writes nothing.  Logits within 1e-4 (fp32) / 5e-2 (bf16)
    of the largest; unwritten slots bit-equal; written slots within 1e-4
    / 2e-2 of their largest (the attention cohort test's bounds: in bf16
    the second layer's state inherits the first layer's rounding).  The
    fused step is refused for ssm."""
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, dtype,
                                                 "nanomind-serve")
    rng = np.random.default_rng(bc)
    n_slots = 5
    pool = tuple(np.asarray(l) for l in RD.init_cache(rcfg, n_slots, 8)[0])
    pool = ((_hidden(rng, pool[0].shape, dtype),
             (rng.standard_normal(pool[1].shape) * 0.1).astype(np.float32)),)
    slot_ids = np.array([3, 0, 4, 1][:bc], np.int32)
    if bc >= 2:
        slot_ids[-1] = n_slots                 # a padded sentinel row
    tokens = (np.arange(bc)[:, None] * 7 % 50 + 3).astype(np.int32)
    lengths = np.array([5 + 3 * i for i in range(bc)], np.int32)
    tables = np.zeros((bc, 1), np.int32)
    rl, rpool = ref_cohort_step(
        rparams, rcfg, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(slot_ids), jnp.asarray(tables),
        tuple(tuple(jnp.asarray(l) for l in pos) for pos in pool),
        block_size=8, paged=(False,))
    tpool = tuple(tuple(bridge.array_to_tensor(l, device="cpu") for l in pos)
                  for pos in pool)
    args = [torch.from_numpy(a) for a in (tokens, lengths, slot_ids, tables)]
    with torch.no_grad():
        tl, tpool2 = cohort_step(tparams, tcfg, *args, tpool, block_size=8,
                                 paged=(False,))
    tol, wtol = (1e-4, 1e-4) if dtype == "float32" else (5e-2, 2e-2)
    assert _rel_err(rl, tl) <= tol
    written = [s for s in slot_ids if s < n_slots]
    kept = [s for s in range(n_slots) if s not in written]
    for r, tt, old in zip(rpool[0], tpool2[0], pool[0]):
        t = bridge.tensor_to_array(tt)
        assert np.array_equal(bits(t)[:, kept], bits(old)[:, kept])
        assert np.array_equal(bits(np.asarray(r))[:, kept],
                              bits(old)[:, kept])
        assert _rel_err(np.asarray(r)[:, written], tt[:, written]) <= wtol
    # written in place: the step returns the pool it was given
    assert all(a is b for a, b in zip(tpool[0], tpool2[0]))
    with pytest.raises(ValueError, match="uniform dense-attention"):
        cohort_step(tparams, tcfg, *args, tpool, block_size=8,
                    paged=(False,), use_fused=True)


def test_init_cache_and_decode_state_match_reference():
    rcfg = ref_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    want = RM.init_decode_state(rcfg, 3, 16)
    got = TM.init_decode_state(tcfg, 3, 16, device="cpu")
    assert int(got["index"]) == int(want["index"]) == 15
    for w, g in zip(want["layers"][0], got["layers"][0]):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


@pytest.mark.parametrize("arch", list_archs())
def test_count_params_matches_reference(arch):
    for reduce in (False, True):
        rcfg, tcfg = ref_config(arch), get_config(arch)
        if reduce:
            rcfg, tcfg = rcfg.reduced(), tcfg.reduced()
        assert TM.count_params_analytic(tcfg) == \
            RM.count_params_analytic(rcfg)


def test_init_params_has_reference_tree_and_scales():
    """The port's own Mamba-2 init: the reference's tree, shapes, dtypes
    and init scales within sampling noise; A_log, D and dt_bias exact."""
    from repro.launch.steps import init_params as ref_init
    rcfg = ref_config(ARCH).reduced()
    ref = flat(jax_to_numpy(jax.jit(ref_init, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)))
    port = flat(TM.init_params(get_config(ARCH).reduced(), device="cpu",
                               seed=3))
    assert sorted(ref) == sorted(port)
    for path, leaf in ref.items():
        t = port[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
        if path[-1] in ("A_log", "D", "dt_bias"):
            assert np.allclose(f32(t), np.asarray(leaf, np.float32),
                               rtol=1e-6, atol=0), path
            continue
        want = float(np.std(np.asarray(leaf, np.float32)))
        got = float(t.float().std()) if t.numel() > 1 else 0.0
        assert abs(got - want) <= 0.1 * want + 1e-6, (path, got, want)


def test_slot_pool_matches_reference_pool():
    """``PagedKVCache`` for Mamba-2: no paged position and no block,
    slot-state leaves ``(L, n_slots, ...)`` of the reference's shapes
    and dtypes; a batch-2 prefilled state lands by slot as the
    reference's ``insert_many`` lands it, bit for bit; ``nbytes`` counts
    the same bytes."""
    from repro.serving.kv_cache import PagedKVCache as RPool
    from repro_torch.serving.kv_cache import PagedKVCache as TPool
    rcfg = ref_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    rpool = RPool(rcfg, 4, 64, block_size=16)
    tpool = TPool(tcfg, 4, 64, block_size=16, device="cpu")
    assert rpool.paged == tpool.paged == (False,)
    assert tpool.n_blocks == tpool.blocks_per_slot == 0   # nothing paged
    rng = np.random.default_rng(3)
    batch = tuple(_hidden(rng, (l.shape[0], 2) + l.shape[2:], l.dtype)
                  for l in rpool.pool[0])
    rpool.insert_many([2, 0], {"layers": (tuple(
        jnp.asarray(b) for b in batch),)}, [5, 9])
    tpool.insert_many([2, 0], {"layers": (tuple(
        bridge.array_to_tensor(b, device="cpu") for b in batch),)}, [5, 9])
    for r, t in zip(rpool.pool[0], tpool.pool[0]):
        assert tuple(t.shape) == r.shape
        assert np.array_equal(bits(np.asarray(r)),
                              bits(bridge.tensor_to_array(t)))
    assert list(tpool.lengths) == list(rpool.lengths) == [9, 0, 5, 0]
    assert tpool.nbytes == sum(l.size * l.dtype.itemsize
                               for l in rpool.pool[0])
