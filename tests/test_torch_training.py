"""The port's training path against the reference's, on the CPU.

Same weights for both packages (the port's init through the bridge,
``_torch_parity.shared_params``), inputs from numpy seeds:

- the data pipeline's stream and ``seek``, bit for bit;
- ``schedule_lr`` for the three schedules, within 1e-6 relative (both in
  fp32; XLA's and torch's ``cos`` may differ by an ulp);
- the set of decayed leaves, path for path;
- ``adamw_update`` on identical inputs: fp32 params and states within
  1e-6 of each leaf's largest magnitude, bf16 ones within one bf16 step
  (2^-7 of the leaf's largest), the step and the metrics;
- ``lm_loss``: the loss within 1e-5 relative in fp32 (summation order)
  and 1e-3 in bf16, and every leaf's gradient against ``jax.value_and_
  grad`` of the reference's ``lm_loss``, within 2e-5 of the leaf's
  largest magnitude in fp32 and 8e-2 in bf16 (both frameworks round the
  activations and their cotangents to bf16, at different points: about
  2.5e-2 on these configs), for reduced llava, stablelm-1.6b, qwen2-vl
  (M-RoPE), deepseek-moe-16b (its ``aux_loss`` too, once both packages
  are shown to choose the same experts on the data) and mamba2-1.3b (the
  SSD through the port's autograd Function and ``ref_ssd_backward``),
  ``attn_q_chunk`` 0 and 512, ``remat`` on and off, with and without a
  ``loss_mask``;
- gradient accumulation over 2 microbatches against accumulation 1 and
  the reference's accumulating step, fp32, on the first moment after the
  step (linear in the gradient; Adam's update flips with rounding noise
  where a gradient is near 0), within 1e-5 of each leaf's largest
  magnitude;
- ``fit``'s losses over 5 steps against the reference's ``fit`` from the
  same weights and data, within 1e-4 relative (fp32; reduced stablelm,
  deepseek-moe-16b and mamba2-1.3b);
- checkpoint, crash and resume (as ``tests/test_training.py``), and a
  port checkpoint read by the reference's ``restore``;
- the families the port does not train (hybrid groups, linear
  attention, the encoder-decoder) raise, naming their ROADMAP items;
- the guard that every kernel wrapper but flash attention calls: it
  raises for an input that requires grad under grad mode, only then;
- the flash wrapper's autograd Function, its launchers swapped for their
  plain versions (the kernels run only on the card): its gradients equal
  autograd's of ``ref_attention``, and it counts one forward and one
  backward launch.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32, flat, shared_params
from repro.configs import get_config as ref_config
from repro.data import multimodal_batch_iter as ref_batches
from repro.distributed import checkpoint as ref_ck
from repro.models import model as RM
from repro.training import optimizer as RO
from repro.training import train_loop as RT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data import multimodal_batch_iter, PackedLMDataset, \
    ShardedLoader
from repro_torch.distributed import checkpoint as ck
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT
from repro_torch.tree import tree_leaves_with_path

LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 2e-5, "bfloat16": 8e-2}


def _batch(cfg, B=2, S=64, seed=3, loss_mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if loss_mask:
        batch["loss_mask"] = (rng.random((B, S)) > 0.3).astype(np.int32)
    if cfg.vlm:
        batch["vision_feats"] = (rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_feat_dim)) * 0.02
        ).astype(np.float32)
    return batch


def _leaf_err(want, got):
    want, got = f32(want), f32(got)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llava-onevision-0.5b", "stablelm-1.6b",
                                  "seamless-m4t-large-v2"])
def test_data_stream_bit_equal_to_reference(arch):
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    mine, theirs = multimodal_batch_iter(cfg, 4, 48, seed=5), \
        ref_batches(rcfg, 4, 48, seed=5)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_loader_seek_replays_the_stream():
    from repro.data import PackedLMDataset as RDs, ShardedLoader as RLd
    mine = ShardedLoader(PackedLMDataset(512, 32, seed=2), 4, host_id=1,
                         n_hosts=2)
    theirs = RLd(RDs(512, 32, seed=2), 4, host_id=1, n_hosts=2)
    first = [next(mine) for _ in range(3)]
    mine.seek(1)
    theirs.seek(1)
    for want in first[1:]:
        a, b = next(mine), next(theirs)
        for k in want:
            np.testing.assert_array_equal(a[k], want[k])
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.step == theirs.step == 3


# -- optimizer --------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    rc, tc = RO.OptConfig(**kw), TO.OptConfig(**kw)
    for step in (0, 1, 5, 10, 11, 37, 60, 99, 100, 150):
        want = float(RO.schedule_lr(rc, jnp.asarray(step)))
        got = TO.schedule_lr(tc, step)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=0.0)


@pytest.mark.parametrize("arch", ["llava-onevision-0.5b", "stablelm-1.6b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b",
                                  "deepseek-moe-16b"])
def test_decayed_leaves_match_reference(arch):
    """The port's paths are the reference's strings, and the same leaves
    decay (Mamba-2's A_log / dt_bias / D and the norms do not)."""
    _, rparams, _, tparams = shared_params(arch, "float32")
    want = {"/".join(p): RO._decay_mask(
        [jax.tree_util.DictKey(k) if not k.isdigit()
         else jax.tree_util.SequenceKey(int(k)) for k in p])
        for p in flat(rparams)}
    ref_paths = {"/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                          for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(
                     rparams)[0]}
    got = {path: TO._decay_mask(path)
           for path, _ in tree_leaves_with_path(tparams)}
    assert set(got) == ref_paths == set(want)
    assert got == want
    assert any(got.values()) and not all(got.values())


def _opt_inputs(rparams, state_dtype, seed=7):
    """Numpy grads and moments for every leaf (moments already in the
    state dtype), the same arrays for both packages."""
    rng = np.random.default_rng(seed)
    sd = jnp.dtype(state_dtype)

    def arr(p, scale, pos=False):
        a = rng.standard_normal(np.shape(p)).astype(np.float32) * scale
        return np.abs(a) if pos else a
    grads = jax.tree.map(lambda p: jnp.asarray(arr(p, 0.3)).astype(p.dtype),
                         rparams)
    m = jax.tree.map(lambda p: jnp.asarray(arr(p, 0.01)).astype(sd), rparams)
    v = jax.tree.map(lambda p: jnp.asarray(arr(p, 1e-3, True)).astype(sd),
                     rparams)
    return grads, m, v


@pytest.mark.parametrize("dtype,state_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_adamw_update_matches_reference(dtype, state_dtype):
    _, rparams, _, tparams = shared_params("llava-onevision-0.5b", dtype)
    grads, m, v = _opt_inputs(rparams, state_dtype)
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=20,
              state_dtype=state_dtype, clip_norm=5.0)
    rstate = {"m": m, "v": v, "step": jnp.asarray(4, jnp.int32)}
    tstate = {"m": bridge.from_numpy(jax.tree.map(np.asarray, m), "cpu"),
              "v": bridge.from_numpy(jax.tree.map(np.asarray, v), "cpu"),
              "step": torch.tensor(4, dtype=torch.int32)}
    tgrads = bridge.from_numpy(jax.tree.map(np.asarray, grads), "cpu")
    rp, rs, rm = jax.jit(RO.adamw_update, static_argnums=(3,))(
        rparams, grads, rstate, RO.OptConfig(**kw))
    tp, ts, tm = TO.adamw_update(tparams, tgrads, tstate, TO.OptConfig(**kw))
    assert int(ts["step"]) == int(rs["step"]) == 5
    assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=1e-5)
    for want_tree, got_tree, dt in ((rp, tp, dtype),
                                    (rs["m"], ts["m"], state_dtype),
                                    (rs["v"], ts["v"], state_dtype)):
        want, got = flat(want_tree), flat(got_tree)
        assert set(want) == set(got)
        tol = 1e-6 if dt == "float32" else 2.0 ** -7
        for k in want:
            assert str(got[k].dtype) == f"torch.{dt}"
            assert _leaf_err(want[k], got[k]) <= tol, k
    # the inputs are left as they were
    assert torch.equal(tstate["m"]["embed"], bridge.from_numpy(
        np.asarray(m["embed"]), "cpu"))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_donated_state_is_the_same_update(state_dtype):
    """``donate_state``: the same bits as the functional update, the new
    moments written into the donated tensors, the params untouched."""
    _, rparams, _, tparams = shared_params("deepseek-moe-16b", "bfloat16")
    grads, m, v = _opt_inputs(rparams, state_dtype)
    state = lambda: {
        "m": bridge.from_numpy(jax.tree.map(np.asarray, m), "cpu"),
        "v": bridge.from_numpy(jax.tree.map(np.asarray, v), "cpu"),
        "step": torch.tensor(4, dtype=torch.int32)}
    tgrads = bridge.from_numpy(jax.tree.map(np.asarray, grads), "cpu")
    oc = TO.OptConfig(lr=1e-3, warmup_steps=3, total_steps=20,
                      state_dtype=state_dtype, clip_norm=5.0)
    before = {k: t.clone() for k, t in flat(tparams).items()}
    want = TO.adamw_update(tparams, tgrads, state(), oc)
    donated = state()
    got = TO.adamw_update(tparams, tgrads, donated, oc, donate_state=True)
    for k in ("m", "v"):
        b, d = (dict(tree_leaves_with_path(t)) for t in (want[1][k],
                                                         donated[k]))
        for path, a in tree_leaves_with_path(got[1][k]):
            assert a is d[path] and torch.equal(a, b[path]), path
    b = dict(tree_leaves_with_path(want[0]))
    for path, a in tree_leaves_with_path(got[0]):
        assert torch.equal(a, b[path]), path
    assert all(torch.equal(t, before[k]) for k, t in flat(tparams).items())


# -- attention's backward ---------------------------------------------------

# -- the loss and its gradients ---------------------------------------------

LOSS_CASES = [
    ("llava-onevision-0.5b", "float32", 0, False, False),
    ("llava-onevision-0.5b", "float32", 512, True, True),
    ("llava-onevision-0.5b", "bfloat16", 0, True, True),
    ("stablelm-1.6b", "float32", 512, False, True),
    ("stablelm-1.6b", "bfloat16", 0, False, False),
    ("qwen2-vl-7b", "float32", 0, True, False),
    ("qwen2-vl-7b", "bfloat16", 512, False, True),
    ("deepseek-moe-16b", "float32", 0, False, False),
    ("deepseek-moe-16b", "float32", 512, True, True),
    ("deepseek-moe-16b", "bfloat16", 512, True, False),
    ("mamba2-1.3b", "float32", 0, False, True),
    ("mamba2-1.3b", "bfloat16", 0, True, False),
]


class _RefExperts:
    """Inside the block, the reference's ``moe.route`` also reports each
    call's top-k experts from the compiled step (``jax.debug.callback``,
    in order): ``idx`` holds one int array a MoE call of the forward
    (a recomputation under remat reports again, after them)."""

    def __enter__(self):
        from repro.models import moe as RMoE
        self.mod, self.inner, self.idx = RMoE, RMoE.route, []

        def spy(logits, top_k, cap):
            _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
            jax.debug.callback(lambda i: self.idx.append(np.asarray(i)), idx,
                               ordered=True)
            return self.inner(logits, top_k, cap)
        RMoE.route = spy
        return self

    def __exit__(self, *exc):
        self.mod.route = self.inner


def _port_experts(tcfg, tparams, batch):
    """The port's top-k experts of every MoE call of one forward of
    ``lm_loss`` on ``batch``."""
    from repro_torch.models import moe as TMoE
    inner, idx = TMoE.route, []

    def spy(logits, top_k, cap, mask=None):
        idx.append(TMoE.top_choices(logits, top_k)[2].numpy())
        return inner(logits, top_k, cap, mask)
    TMoE.route = spy
    try:
        with torch.no_grad():
            TM.lm_loss(tparams, tcfg,
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        TMoE.route = inner
    return idx


@pytest.mark.parametrize("arch,dtype,q_chunk,remat,loss_mask", LOSS_CASES)
def test_lm_loss_and_grads_match_reference(arch, dtype, q_chunk, remat,
                                           loss_mask):
    rcfg, rparams, tcfg, tparams = shared_params(arch, dtype)
    rcfg = dataclasses.replace(rcfg, attn_q_chunk=q_chunk, remat=remat)
    tcfg = dataclasses.replace(tcfg, attn_q_chunk=q_chunk, remat=remat)
    batch = _batch(rcfg, loss_mask=loss_mask)
    # the reference's results in hand before the port's CPU arithmetic runs
    with _RefExperts() as ref_experts:
        (rl, rparts), rg = jax.block_until_ready(jax.jit(jax.value_and_grad(
            lambda p, b: RM.lm_loss(p, rcfg, b), has_aux=True))(
            rparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    if rcfg.moe is not None:
        # the gradients are comparable only where both packages took the
        # same experts
        port_idx = _port_experts(tcfg, tparams, batch)
        assert len(port_idx) == rcfg.n_layers
        for a, b in zip(ref_experts.idx[:rcfg.n_layers], port_idx):
            np.testing.assert_array_equal(a, b)
    tl, tparts, tg = TS.loss_and_grads(
        tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.dtype == torch.float32
    assert float(tl) == pytest.approx(float(rl), rel=LOSS_TOL[dtype])
    for k in ("nll", "z_loss"):
        assert float(tparts[k]) == pytest.approx(float(rparts[k]),
                                                 rel=LOSS_TOL[dtype])
    if rcfg.moe is not None:
        assert float(tparts["aux_loss"]) > 0
        assert float(tparts["aux_loss"]) == pytest.approx(
            float(rparts["aux_loss"]), rel=LOSS_TOL[dtype])
    else:
        assert float(tparts["aux_loss"]) == float(rparts["aux_loss"]) == 0
    want, got = flat(rg), flat(tg)
    assert set(want) == set(got)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        # each leaf's gradient in its param's dtype (the MoE's router and
        # Mamba-2's A_log, D and dt_bias are fp32 in both dtypes)
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        assert _leaf_err(want[k], got[k]) <= GRAD_TOL[dtype], k
    # the loss itself, without grad, is the same function
    with torch.no_grad():
        again, _ = TM.lm_loss(tparams, tcfg, {
            k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(again) == pytest.approx(float(tl), rel=1e-6)


def test_head_loss_chunks_add_up():
    """Chunks of 16 and one chunk of 64 give the same sums (fp32)."""
    _, _, cfg, params = shared_params("stablelm-1.6b", "float32")
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model)
                                             ).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    mask = torch.from_numpy((rng.random((2, 64)) > 0.2).astype(np.int32))
    one = TM.head_loss_chunked(params, cfg, x, labels, mask, chunk=64)
    four = TM.head_loss_chunked(params, cfg, x, labels, mask, chunk=16)
    for a, b in zip(one, four):
        assert float(a) == pytest.approx(float(b), rel=1e-5)


# -- the train step, accumulation, fit --------------------------------------

def test_grad_accum_matches_accum_1_and_reference():
    """Accumulation over 2 microbatches of 2 rows against one batch of 4
    and the reference's accumulating step (fp32, no loss mask: every
    microbatch has the same count of positions, so the mean of the
    microbatch means is the batch mean).  Held on the first moment after
    the step, m = (1 - b1) clip g: linear in the gradient, where the
    params' update (about sign(g) at step 1) flips with rounding noise
    wherever g is near 0."""
    rcfg, rparams, tcfg, tparams = shared_params("stablelm-1.6b", "float32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(rcfg, B=4, S=32, seed=11)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # each step updates the moments it is handed in place: a state each
    _, s1, m1 = TT.build_accum_train_step(tcfg, TO.OptConfig(**kw), 1)(
        tparams, TO.init_opt(tparams, TO.OptConfig(**kw)), tb)
    _, s2, m2 = TT.build_accum_train_step(tcfg, TO.OptConfig(**kw), 2)(
        tparams, TO.init_opt(tparams, TO.OptConfig(**kw)), tb)
    ropt = RO.init_opt(rparams, RO.OptConfig(**kw))
    _, rs2, rm2 = jax.jit(RT.build_accum_train_step(
        rcfg, RO.OptConfig(**kw), 2))(rparams, ropt,
                                      {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["loss"]) == pytest.approx(float(rm2["loss"]), rel=1e-5)
    assert float(m2["grad_norm"]) == pytest.approx(float(rm2["grad_norm"]),
                                                   rel=1e-5)
    a, b, r = flat(s1["m"]), flat(s2["m"]), flat(rs2["m"])
    assert set(a) == set(b) == set(r)
    for k in a:
        assert _leaf_err(a[k], b[k]) <= 1e-5, k
        assert _leaf_err(r[k], b[k]) <= 1e-5, k


@pytest.fixture(scope="module", params=["stablelm-1.6b", "deepseek-moe-16b",
                                        "mamba2-1.3b"])
def fit_pair(request):
    """The reference's and the port's ``fit`` over 5 steps, a reduced
    config in fp32 (dense, the mixture of experts, Mamba-2), same weights
    and data."""
    rcfg, rparams, tcfg, tparams = shared_params(request.param, "float32")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    tc = dict(steps=5, log_every=100)
    rres = RT.fit(rcfg, RO.OptConfig(**kw), RT.TrainConfig(**tc),
                  ref_batches(rcfg, 4, 64, seed=0), params=rparams,
                  log=lambda s: None)
    tres = TT.fit(tcfg, TO.OptConfig(**kw), TT.TrainConfig(**tc),
                  multimodal_batch_iter(tcfg, 4, 64, seed=0), params=tparams,
                  log=lambda s: None, device="cpu")
    return rres, tres


def test_fit_losses_match_reference(fit_pair):
    rres, tres = fit_pair
    assert [m["step"] for m in tres.metrics_history] == [1, 2, 3, 4, 5]
    for r, t in zip(rres.metrics_history, tres.metrics_history):
        assert t["loss"] == pytest.approx(r["loss"], rel=1e-4)
        assert t["lr"] == pytest.approx(r["lr"], rel=1e-6)


def test_checkpoint_crash_and_resume():
    cfg = get_config("stablelm-1.6b").reduced(n_layers=2)
    oc = TO.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    with tempfile.TemporaryDirectory() as d:
        res = TT.fit(cfg, oc, TT.TrainConfig(steps=10, ckpt_dir=d,
                                             ckpt_every=5, log_every=100),
                     multimodal_batch_iter(cfg, 4, 64), log=lambda s: None,
                     device="cpu")
        assert res.metrics_history[-1]["loss"] < \
            res.metrics_history[0]["loss"]
        assert ck.latest_step(d) == 10
        # crash + restart: resumes from step 10
        res2 = TT.fit(cfg, oc, TT.TrainConfig(steps=12, ckpt_dir=d,
                                              ckpt_every=5, log_every=100),
                      multimodal_batch_iter(cfg, 4, 64), log=lambda s: None,
                      device="cpu")
        assert res2.recovery.events[0]["kind"] == "restore"
        assert res2.metrics_history[0]["step"] == 11
        assert [e["kind"] for e in res.recovery.events] == ["checkpoint"] * 2


def test_port_checkpoint_restores_in_the_reference():
    """A port checkpoint of params and optimizer state (bf16 params, fp32
    moments, an int32 step) read by the reference's ``restore`` into the
    reference's own trees (dict keys sorted), bit for bit; and read back
    by the port's."""
    _, rparams, tcfg, tparams = shared_params("llava-onevision-0.5b",
                                              "bfloat16")
    oc = TO.OptConfig()
    topt = TO.init_opt(tparams, oc)
    topt["m"] = TO.tree_map(lambda t: torch.randn_like(t), topt["m"])
    topt["step"] = torch.tensor(7, dtype=torch.int32)
    tree = {"params": tparams, "opt": topt}
    like = {"params": rparams, "opt": RO.init_opt(rparams, RO.OptConfig())}
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 7, tree)
        got, step, _ = ref_ck.restore(d, like)
        assert step == 7
        want, have = flat(tree), flat(got)
        assert set(want) == set(have)
        for k in want:
            assert str(have[k].dtype) == str(want[k].dtype).replace(
                "torch.", "")
            np.testing.assert_array_equal(f32(have[k]), f32(want[k]))
        back, _, _ = ck.restore(d, tree)
        for k, t in flat(back).items():
            assert t.dtype == want[k].dtype and torch.equal(t, want[k])
        # and a reference checkpoint restores in the port
        ref_ck.save(d, 8, got)
        back, step, _ = ck.restore(d, tree)
        assert step == 8
        for k, t in flat(back).items():
            assert torch.equal(t, want[k])


def test_async_checkpointer_writes_a_host_copy():
    with tempfile.TemporaryDirectory() as d:
        x = torch.arange(10, dtype=torch.float32)
        acp = ck.AsyncCheckpointer(d)
        acp.save_async(3, {"x": x, "y": (torch.ones(2, dtype=torch.bfloat16),)})
        x += 1                       # after the snapshot: not in the file
        acp.wait()
        got, step, _ = ck.restore(d, {"x": x, "y": (torch.ones(2, dtype=torch.bfloat16),)})
        assert step == 3 and torch.equal(got["x"], torch.arange(10.0))
        assert os.path.exists(os.path.join(d, "step_00000003",
                                           "manifest.json"))


# -- what the port does not train -------------------------------------------

@pytest.mark.parametrize("arch,overrides", [
    ("llava-onevision-0.5b", {"attn_impl": "linear"}),
    ("jamba-1.5-large-398b", {}), ("seamless-m4t-large-v2", {})])
def test_unported_families_raise(arch, overrides):
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    with pytest.raises(NotImplementedError, match="ROADMAP 11.4"):
        TS.build_train_step(cfg, TO.OptConfig())
    with pytest.raises(NotImplementedError, match="ROADMAP 11.4"):
        TM.lm_loss({}, cfg, {"tokens": torch.zeros((1, 8), dtype=torch.int32)})
    with pytest.raises(NotImplementedError):
        TT.fit(cfg, TO.OptConfig(), TT.TrainConfig(steps=1), iter(()),
               device="cpu")


# -- the kernels' guard and the flash Function -------------------------------

def test_refuse_grad_raises_only_for_inputs_that_require_grad():
    from repro_torch.core.quantize import QuantSpec, quantize
    from repro_torch.kernels import refuse_grad
    x = torch.ones(4, 8)
    w = torch.ones(8, 8, requires_grad=True)
    refuse_grad("k", x, None, 3)                   # nothing requires grad
    with pytest.raises(RuntimeError, match="k: the kernel has no backward"):
        refuse_grad("k", x, w)
    with torch.no_grad():
        refuse_grad("k", x, w)                     # grad mode off
    qt = quantize(torch.randn(64, 32), QuantSpec(4, group_size=32))
    refuse_grad("k", qt)
    qt.scales.requires_grad_(True)
    with pytest.raises(RuntimeError):
        refuse_grad("k", x, qt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,Sq,Sk", [(True, 40, 40), (False, 24, 56)])
def test_flash_function_wires_forward_and_backward(monkeypatch, dtype,
                                                   causal, Sq, Sk):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        ref_attention, ref_attention_backward, ref_attention_lse)
    monkeypatch.setattr(K, "launch_flash_attention",
                        lambda q, k, v, *, causal, want_lse=False:
                        ref_attention_lse(q, k, v, causal=causal))
    monkeypatch.setattr(K, "launch_flash_attention_backward",
                        ref_attention_backward)
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(s, generator=g).to(dtype).requires_grad_(True)
               for s in ((2, Sq, 6, 16), (2, Sk, 2, 16), (2, Sk, 2, 16)))
    do = torch.randn((2, Sq, 6, 16), generator=g).to(dtype)
    reset_launch_counts()
    o = ops.FlashAttention.apply(q, k, v, causal)
    got = torch.autograd.grad(o, (q, k, v), do)
    counts = {n: c for n, c in launch_counts().items() if c}
    route = K.ROUTES[dtype]
    assert counts == {"flash_attention": 1, f"flash_attention/{route}": 1,
                      "flash_attention/bwd": 1,
                      f"flash_attention/{K.BWD_ROUTES[dtype]}": 1}
    want = torch.autograd.grad(ref_attention(q, k, v, causal=causal),
                               (q, k, v), do)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _leaf_err(b, a) <= tol
