"""The cohort decode step as the engine captures it on the card, checked on
the CPU: the in-place fixed-shape slot scatter against the copying form
it replaces, the slot-state composed step against the reference engine's
compiled cohort step (``_cohort_fn``), the launch-count bookkeeping that
a replay adds back, and the engine's one cached step per cohort bucket.
The CUDA graph itself is captured only on the card
(``tests/test_torch_cuda_kernels.py``)."""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bits, f32, shared_params
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine
from repro_torch import bridge
from repro_torch.kernels import (count_launch, count_launches, launch_counts,
                                 launches_of, reset_launch_counts)
from repro_torch.kernels.fused_decode.ref import (scatter_slots,
                                                  scatter_slots_copy)
from repro_torch.models import decoder as dec
from repro_torch.serving import cohort_graph
from repro_torch.serving.engine import Request, ServingEngine

LINEAR = {"attn_impl": "linear", "subquadratic": True}
N_SLOTS = 4


def _cfgs(arch, dtype="float32"):
    """(reference cfg, reference params, port cfg, port params) of a
    reduced slot-state config: Mamba-2, or llava with linear attention."""
    name = "mamba2-1.3b" if arch == "mamba" else "llava-onevision-0.5b"
    rcfg, rparams, tcfg, tparams = shared_params(name, dtype,
                                                 "nanomind-serve")
    if arch == "linear":
        rcfg = dataclasses.replace(rcfg, **LINEAR)
        tcfg = dataclasses.replace(tcfg, **LINEAR)
    return rcfg, rparams, tcfg, tparams


def _random_pool(cfg, rng):
    """A slot-state pool (L, N_SLOTS, ...) of random values, as numpy."""
    out = []
    for leaf in dec.init_cache(cfg, N_SLOTS, 8, "cpu")[0]:
        a = rng.standard_normal(tuple(leaf.shape)).astype(np.float32) * 0.1
        out.append(bridge.tensor_to_array(torch.from_numpy(a).to(
            leaf.dtype)))
    return tuple(out)


def _slot_ids(rng, bc, n_sentinel):
    """bc rows: distinct real slots, ``n_sentinel`` sentinel rows (slot id
    N_SLOTS), in a random order."""
    ids = np.full(bc, N_SLOTS, np.int32)
    ids[:bc - n_sentinel] = rng.permutation(N_SLOTS)[:bc - n_sentinel]
    return rng.permutation(ids).astype(np.int32)


# (bc, sentinel rows): every bucket up to four slots, 0-3 sentinels, and
# the all-sentinel step of a bucket's capture warm-up
SCATTER_CASES = [(1, 0), (1, 1), (2, 0), (2, 1), (2, 2), (4, 0), (4, 1),
                 (4, 2), (4, 3), (4, 4)]


@pytest.mark.parametrize("bc,n_sentinel", SCATTER_CASES)
@pytest.mark.parametrize("arch", ["mamba", "linear"])
def test_scatter_slots_in_place_is_the_copying_form(arch, bc, n_sentinel):
    """``scatter_slots`` (fixed shape, in place) writes bit for bit what
    the copying form it replaces (``scatter_slots_copy``, the plain
    step's) returns, on every slot-state leaf of the reduced config,
    sentinel rows writing nothing; the pool passed in is the pool
    returned, at the same address."""
    _, _, tcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(10 * bc + n_sentinel)
    ids = torch.from_numpy(_slot_ids(rng, bc, n_sentinel))
    for leaf in _random_pool(tcfg, rng):
        pool = bridge.array_to_tensor(leaf, device="cpu")
        rows = torch.from_numpy(rng.standard_normal(
            (pool.shape[0], bc) + tuple(pool.shape[2:])).astype(np.float32))
        want = scatter_slots_copy(pool, ids, rows)
        ptr = pool.data_ptr()
        got = scatter_slots(pool, ids, rows)
        assert got is pool and got.data_ptr() == ptr
        assert np.array_equal(bits(bridge.tensor_to_array(got)),
                              bits(bridge.tensor_to_array(want)))
        kept = [s for s in range(N_SLOTS) if s not in ids.tolist()]
        assert np.array_equal(bits(bridge.tensor_to_array(got))[:, kept],
                              bits(leaf)[:, kept])


@pytest.mark.parametrize("arch", ["mamba", "linear"])
def test_scatter_slots_has_a_fixed_shape(arch):
    """On the meta device (shapes, no data) the in-place scatter runs:
    nothing in it reads a value back or sizes a tensor from the data,
    which a CUDA graph could not capture.  The copying form it replaces
    indexes with a mask and does not run there."""
    _, _, tcfg, _ = _cfgs(arch)
    ids = torch.tensor([2, N_SLOTS], dtype=torch.int32, device="meta")
    for leaf in dec.init_cache(tcfg, N_SLOTS, 8, "meta")[0]:
        rows = torch.empty((leaf.shape[0], 2) + tuple(leaf.shape[2:]),
                           device="meta")
        assert scatter_slots(leaf, ids, rows).shape == leaf.shape
        with pytest.raises(NotImplementedError):
            scatter_slots_copy(leaf, ids, rows)


@pytest.mark.parametrize("bc", [1, 2, 4])
@pytest.mark.parametrize("arch", ["mamba", "linear"])
def test_slot_state_step_matches_reference_cohort_fn(arch, bc):
    """The engine's cohort step on a reduced Mamba-2 / linear-attention
    config (fp32, nanomind-serve) against the reference engine's compiled
    cohort step, ``ServingEngine._cohort_fn(bc)``, on the same weights,
    inputs and pool (both lay the slot pool out (L, n_slots, ...)): the
    logits within 1e-4 of the largest, the written slots within 1e-4 of
    their largest, the others bit-equal; the port's step returns the pool
    it was given, written in place (a sentinel row for bc >= 2)."""
    rcfg, rparams, tcfg, tparams = _cfgs(arch)
    rng = np.random.default_rng(20 + bc)
    pool = _random_pool(tcfg, rng)
    ids = _slot_ids(rng, bc, 1 if bc >= 2 else 0)
    tokens = rng.integers(3, tcfg.vocab_size, (bc, 1)).astype(np.int32)
    lengths = rng.integers(5, 40, bc).astype(np.int32)
    tables = np.zeros((bc, 0), np.int32)
    with RServingEngine(rcfg, rparams, n_slots=N_SLOTS, max_len=64) as reng:
        rl, rpool = reng._cohort_fn(bc)(
            reng.params, jnp.asarray(tokens), jnp.asarray(lengths),
            jnp.asarray(ids), jnp.asarray(tables),
            (tuple(jnp.asarray(leaf) for leaf in pool),))
    tpool = (tuple(bridge.array_to_tensor(leaf, device="cpu")
                   for leaf in pool),)
    with ServingEngine(tcfg, tparams, n_slots=N_SLOTS, max_len=64,
                       device="cpu") as eng:
        with torch.no_grad():
            tl, out = eng._cohort_fn(bc)(
                *(torch.from_numpy(a) for a in (tokens, lengths, ids,
                                                tables)), tpool)
    assert all(a is b for a, b in zip(out[0], tpool[0]))
    rl, tl = f32(rl), f32(tl)
    assert np.abs(rl - tl).max() <= 1e-4 * np.abs(rl).max()
    written = [s for s in ids.tolist() if s < N_SLOTS]
    kept = [s for s in range(N_SLOTS) if s not in written]
    for r, t, old in zip(rpool[0], out[0], pool):
        r, t = np.asarray(r), bridge.tensor_to_array(t)
        assert np.array_equal(bits(t)[:, kept], bits(old)[:, kept])
        w, g = f32(r[:, written]), f32(t[:, written])
        assert np.abs(w - g).max() <= 1e-4 * np.abs(w).max()


def _fake_step(names):
    """A step that counts one launch under each of ``names`` (as the
    kernel wrappers do on the card) and returns its call number."""
    calls = []

    def step():
        for name in names:
            count_launch(name)
        calls.append(None)
        return len(calls)
    return step


@pytest.mark.parametrize("replays", [1, 5])
def test_replayed_delta_counts_as_eager_steps(replays):
    """A capture's launches taken with ``launches_of`` (the registry left
    as it was) and added back once a replay with ``count_launches`` give
    the totals that as many eager steps count."""
    names = ["cache_row_update", "cache_row_update", "kv_scatter"]
    reset_launch_counts()
    eager = _fake_step(names)
    for _ in range(replays):
        eager()
    want = launch_counts()
    reset_launch_counts()
    count_launch("kv_scatter", 7)             # counts before the capture
    before = launch_counts()
    out, delta = launches_of(_fake_step(names))
    assert out == 1 and launch_counts() == before
    assert delta == {"cache_row_update": 2, "kv_scatter": 1}
    for _ in range(replays):
        count_launches(delta)
    got = launch_counts()
    got["kv_scatter"] -= 7
    assert got == want
    reset_launch_counts()


def test_launches_of_restores_the_counts_when_the_step_raises():
    reset_launch_counts()

    def failing():
        count_launch("kv_scatter", 3)
        raise RuntimeError("capture failed")
    with pytest.raises(RuntimeError, match="capture failed"):
        launches_of(failing)
    assert launch_counts()["kv_scatter"] == 0


def test_launches_of_in_one_thread_leaves_another_threads_counts():
    """Two engines on one card count from two threads: a capture's
    ``launches_of`` in one thread takes that thread's launches only, and
    the other thread's launches meanwhile land in the registry."""
    reset_launch_counts()
    inside, resume = threading.Event(), threading.Event()

    def capture():
        count_launch("kv_scatter", 2)
        inside.set()
        assert resume.wait(10)
        count_launch("cache_row_update")
        return "graph"
    got = []
    t = threading.Thread(target=lambda: got.append(launches_of(capture)))
    t.start()
    assert inside.wait(10)
    count_launch("kv_scatter", 5)              # the other engine's launches
    count_launch("cache_row_update", 3)
    resume.set()
    t.join(10)
    assert got == [("graph", {"kv_scatter": 2, "cache_row_update": 1})]
    counts = launch_counts()
    assert counts["kv_scatter"] == 5 and counts["cache_row_update"] == 3
    reset_launch_counts()


@pytest.mark.parametrize("bc,width", [(1, 0), (2, 3), (4, 32), (3, 5)])
def test_static_inputs_are_aligned_views_of_one_buffer(bc, width):
    """The bucket's four inputs are views of one flat int32 buffer, each
    starting 16-byte aligned, and a host buffer's views take a step's
    arrays in place."""
    n = cohort_graph._offsets(bc, width)[-1]
    host = np.zeros(n, np.int32)
    views = cohort_graph._views(host, bc, width)
    shapes = [(bc, 1), (bc,), (bc,), (bc, width)]
    assert [v.shape for v in views] == shapes
    arrays = [np.arange(np.prod(s), dtype=np.int32).reshape(s) + 10 * i
              for i, s in enumerate(shapes)]
    for v, a in zip(views, arrays):
        assert np.shares_memory(v, host) or v.size == 0
        assert (v.ctypes.data - host.ctypes.data) % 16 == 0
        v[...] = a
    for v, a in zip(cohort_graph._views(torch.from_numpy(host), bc, width),
                    arrays):
        assert np.array_equal(v.numpy(), a)


def test_cpu_engine_caches_one_step_per_bucket_as_the_reference():
    """``_cohort_fn(bc)`` returns one cached callable a cohort bucket, as
    the reference's ``_cohort_cache`` holds one compiled step a bucket;
    serving the same text requests fills the same buckets in both
    engines, and ``shutdown`` drops the port's."""
    rcfg, rparams, tcfg, tparams = shared_params("llava-onevision-0.5b",
                                                 "float32",
                                                 "nanomind-serve")
    prompts = [(np.arange(6 + i) % 50 + 3).astype(np.int32)
               for i in range(3)]
    news = (2, 4, 6)
    with RServingEngine(rcfg, rparams, n_slots=N_SLOTS, max_len=64,
                        block_size=16) as reng:
        for i, (p, n) in enumerate(zip(prompts, news)):
            reng.submit(RRequest(rid=i, tokens=p, max_new_tokens=n))
        assert all(r.error is None for r in reng.run())
        want = set(reng._cohort_cache)
    eng = ServingEngine(tcfg, tparams, n_slots=N_SLOTS, max_len=64,
                        block_size=16, device="cpu")
    with eng:
        fn = eng._cohort_fn(2)
        assert eng._cohort_fn(2) is fn and set(eng._cohort_cache) == {2}
        eng._cohort_cache.clear()
        for i, (p, n) in enumerate(zip(prompts, news)):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=n))
        assert all(r.error is None for r in eng.run())
        assert set(eng._cohort_cache) == want == {1, 2, 4}
        assert eng.graph_stats["captures"] == eng.graph_stats["replays"] == 0
    assert not eng._cohort_cache
