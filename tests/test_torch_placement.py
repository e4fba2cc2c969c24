"""Placed plans of the port: ``schedule`` on ``edge_accelerators()`` ->
``compile_plan(placement=, accels=, tabm=)`` -> a run whose vision side
lowers through the host backend (the emulated NPU) and the rest through
the device backend, the vision_embeds edge crossing units through the
TABM ring — held against the reference's placed plan and engine on the
same weights (through the bridge) and inputs (numpy, seeded).

The placement is the one the DP gives at LLaVA's full config and 1024
tokens (vision_frontend and projector on the NPU, the rest on the GPU;
``tests/test_torch_scheduler.py``), applied to the reduced config's
bricks, whose names are the same: at the reduced widths the DP would
put every brick on the GPU and no edge would cross units.  The port's
``device`` row is the card unless the caller names another device: these
tests pass ``device="cpu"``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32, shared_params
from repro.configs import get_config as ref_config
from repro.core import bricks as RB
from repro.core import plan as RP
from repro.core import scheduler as RS
from repro.core import tabm as RT
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine
from repro_torch.configs import get_config
from repro_torch.core import transport as TR
from repro_torch.core.backends import BACKENDS, HostBackend
from repro_torch.core.bricks import decompose
from repro_torch.core.plan import PlanError, compile_plan
from repro_torch.core.scheduler import (edge_accelerators,
                                        populate_brick_bytes, schedule)
from repro_torch.core.tabm import EMPTY, RingBuffer
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "llava-onevision-0.5b"
SPLIT = {"vision_frontend": "npu", "projector": "npu", "embedding": "gpu",
         "decoder": "gpu", "head": "gpu"}


def _full_placement(sched, dec, cfg, accels):
    g = dec(cfg)
    g.bricks = [dataclasses.replace(
        b, param_bytes=max(1, int(b.flops_per_token))) for b in g.bricks]
    return sched(g, accels, n_tokens=1024)


def _placements():
    """(port placement, its accels, reference placement, its accels)."""
    acc, racc = edge_accelerators(), RS.edge_accelerators()
    pl = _full_placement(schedule, decompose, get_config(ARCH), acc)
    rpl = _full_placement(RS.schedule, RB.decompose, ref_config(ARCH), racc)
    assert pl.assignment == rpl.assignment == SPLIT
    return pl, acc, rpl, racc


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(3, 200, (1, 24)).astype(np.int32),
            "vision_feats": (rng.standard_normal(
                (1, cfg.vision_tokens, cfg.vision_feat_dim)) * 0.02
            ).astype(np.float32)}


def _port_plan(tcfg, tparams, pl, acc, **kw):
    ring = RingBuffer(n_slots=2, max_tokens=tcfg.vision_tokens,
                      dim=tcfg.d_model, dtype=tcfg.dtype, device="cpu")
    return compile_plan(decompose(tcfg), tparams, placement=pl, accels=acc,
                        tabm=ring, device="cpu", **kw), ring


def _run(plan, inputs):
    out, _ = plan.run({k: torch.from_numpy(v) for k, v in inputs.items()})
    return out


@pytest.mark.parametrize("dtype,policy", [("bfloat16", "nanomind-serve"),
                                          ("float32", "nanomind-serve"),
                                          ("bfloat16", None)])
def test_placed_plan_matches_reference(dtype, policy):
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, dtype, policy)
    pl, acc, rpl, racc = _placements()
    inputs = _inputs(tcfg)
    plan, ring = _port_plan(tcfg, tparams, pl, acc)
    got = _run(plan, inputs)
    rring = RT.RingBuffer(n_slots=2, max_tokens=rcfg.vision_tokens,
                          dim=rcfg.d_model, dtype=rcfg.dtype)
    rplan = RP.compile_plan(RB.decompose(rcfg), rparams, placement=rpl,
                            accels=racc, tabm=rring)
    want, _ = rplan.run({k: jnp.asarray(v) for k, v in inputs.items()})
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    assert plan.describe() == rplan.describe()
    assert [(k[0], k[1]) for k in plan.pipes] == \
        [(k[0], k[1]) for k in rplan.pipes]
    assert ring.stats["writes"] == ring.stats["reads"] == 1
    assert all(s == EMPTY for s in ring.states)          # slot released
    assert [p.name for p in plan.input_ports] == \
        [p.name for p in rplan.input_ports] == ["vision_feats", "tokens"]


def test_steps_lower_through_the_carried_backends():
    _, _, tcfg, tparams = shared_params(ARCH, "bfloat16", "nanomind-serve")
    pl, acc, _, _ = _placements()
    plan, _ = _port_plan(tcfg, tparams, pl, acc)
    by_name = {a.name: a for a in acc}
    for s in plan.steps:
        assert s.backend.name == pl.backends[s.brick.name]
        assert s.accel is by_name[pl.assignment[s.brick.name]]
        assert plan.backend_of(s.brick.name) is s.backend
    assert plan.backend_of("projector") is BACKENDS["host"]
    dev = plan.backend_of("decoder")
    assert dev.name == "device" and dev.device.type == "cpu"
    assert plan.brick_params("projector")["vis_proj"]["w1"].device.type \
        == "cpu"
    # the npu -> gpu edge runs producer-side into the ring; what is left
    # inbound is the external tokens' edge onto the gpu
    assert set(plan.steps[2].inbound) == {"tokens"}
    assert plan._tabm_transfer is not None
    assert [(k[0], k[1]) for k in plan.pipes] == [
        ("-", "npu"), ("-", "gpu"), ("npu", "gpu")]
    with pytest.raises(KeyError):
        plan.backend_of("no-such-brick")


def test_placed_plan_equals_the_unplaced_run_of_its_lowering():
    """The placement changes where each brick runs, not what it computes:
    the placed plan's logits equal a plan with the same backends given
    as a per-brick override (no accelerators, no edges)."""
    _, _, tcfg, tparams = shared_params(ARCH, "float32", "nanomind-serve")
    pl, acc, _, _ = _placements()
    inputs = _inputs(tcfg, seed=1)
    placed, _ = _port_plan(tcfg, tparams, pl, acc)
    flat = compile_plan(decompose(tcfg), tparams, device="cpu",
                        backend={b: "host" if a == "npu" else "device"
                                 for b, a in SPLIT.items()})
    assert torch.equal(_run(placed, inputs), _run(flat, inputs))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serializing_transport_gives_bit_identical_logits(dtype):
    _, _, tcfg, tparams = shared_params(ARCH, dtype, "nanomind-serve")
    pl, acc, _, _ = _placements()
    inputs = _inputs(tcfg, seed=2)
    direct, _ = _port_plan(tcfg, tparams, pl, acc)
    piped, ring = _port_plan(tcfg, tparams, pl, acc,
                             transport=TR.PipeTransport(None, None))
    want, got = _run(direct, inputs), _run(piped, inputs)
    assert torch.equal(got, want)
    assert ring.stats["writes"] == 1
    assert len(piped.pipes) == 3 and all(
        fn is not None for fn in piped.pipes.values())


def test_transport_edges():
    be = BACKENDS["host"]
    # in process the backend's own edge is the hand-off; over a pipe or a
    # socket the value round-trips the codec first
    assert not TR.InProcTransport.serializes
    assert TR.PipeTransport.serializes and TR.SocketTransport.serializes

    x = torch.randn(3, 5).to(torch.bfloat16)
    direct = TR.InProcTransport().make_edge(None, None, be)
    assert torch.equal(direct(x), x)
    edge = TR.PipeTransport(None, None).make_edge(None, None, be)
    for dt in (torch.bfloat16, torch.float32, torch.float16, torch.int32):
        x = (torch.arange(24) - 7).reshape(2, 3, 4).to(dt)
        y = edge(x)
        assert y.dtype == dt and y.shape == x.shape and torch.equal(y, x)
        assert y.device.type == "cpu"


def test_placement_validation():
    _, _, tcfg, tparams = shared_params(ARCH, "bfloat16", "nanomind-serve")
    pl, acc, _, _ = _placements()
    with pytest.raises(PlanError):
        compile_plan(decompose(tcfg), tparams, device="cpu",
                     placement={"projector": "npu"}, accels=acc)
    with pytest.raises(PlanError):
        compile_plan(decompose(tcfg), tparams, device="cpu",
                     placement=dict(SPLIT, head="dsp"), accels=acc)
    # a raw assignment dict lowers through each unit's substrate row
    plan = compile_plan(decompose(tcfg), tparams, device="cpu",
                        placement=dict(SPLIT), accels=acc)
    assert plan.describe() == compile_plan(
        decompose(tcfg), tparams, device="cpu", placement=pl,
        accels=acc).describe()
    plan, _ = _port_plan(tcfg, tparams, pl, acc)
    with pytest.raises(PlanError):                 # missing required port
        plan.run({"tokens": torch.zeros((1, 8), dtype=torch.int32)})


def test_relower_keeps_accel_and_edges():
    _, _, tcfg, tparams = shared_params(ARCH, "bfloat16", "nanomind-serve")
    pl, acc, _, _ = _placements()
    plan, _ = _port_plan(tcfg, tparams, pl, acc)
    inputs = _inputs(tcfg, seed=4)
    want = _run(plan, inputs)
    old = plan.steps[2]
    new = plan.relower("embedding", "host")
    assert new.backend is BACKENDS["host"]
    assert new.accel is old.accel and new.inbound is old.inbound
    assert plan.relower("embedding", "host") is new
    back = plan.relower("embedding", "device")
    assert back.backend is old.backend              # the plan's device row
    assert torch.equal(_run(plan, inputs), want)


def test_populated_bytes_keep_the_split_at_full_tokens():
    """Real packed bytes (reduced widths) keep the DP deterministic and
    every brick on a unit whose backend resolves here."""
    _, _, tcfg, tparams = shared_params(ARCH, "bfloat16", "nanomind-serve")
    g = decompose(tcfg)
    populate_brick_bytes(g, tparams)
    acc = edge_accelerators()
    for n in (24, 1024):
        pl = schedule(g, acc, n_tokens=n)
        plan = compile_plan(g, tparams, placement=pl, accels=acc,
                            device="cpu")
        assert [s.backend.name for s in plan.steps] == \
            [pl.backends[b] for b in g.names()]


def _requests(request_cls, cfg):
    rng = np.random.default_rng(0)
    reqs = []
    for rid, (nt, ni, plen) in enumerate([(8, 1, 12), (2, 1, 7),
                                          (8, 1, 10)]):
        feats = (rng.standard_normal((1, nt, cfg.vision_feat_dim)) * 0.02
                 ).astype(np.float32)
        reqs.append(request_cls(
            rid=rid, tokens=(np.arange(plen) % 50 + 3).astype(np.int32),
            n_images=ni, max_new_tokens=3, vision_feats=feats))
    return reqs


def test_engine_with_placement_matches_reference_first_step():
    """``ServingEngine(placement=, accels=)`` stages vision on the host
    backend and hands the embeds over the TABM edge; its first-step
    logits (teacher-forced: prefill only) equal the reference engine's
    with the same placement."""
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, "float32",
                                                 "nanomind-serve")
    pl, acc, rpl, racc = _placements()
    want = {}
    with RServingEngine(rcfg, rparams, n_slots=2, max_len=128,
                        block_size=32, placement=rpl, accels=racc) as reng:
        pick = reng._pick

        def recording_pick(logits, req):
            want.setdefault(req.rid, np.asarray(logits, np.float32)[0])
            return pick(logits, req)
        reng._pick = recording_pick
        for r in _requests(RRequest, rcfg):
            reng.submit(r)
        rdone = reng.run()
    assert all(r.error is None for r in rdone)
    got = {}
    with ServingEngine(tcfg, tparams, n_slots=2, max_len=128, block_size=32,
                       placement=pl, accels=acc, device="cpu") as eng:
        assert eng.plan.backend_of("projector") is BACKENDS["host"]
        assert eng.plan.backend_of("decoder").device.type == "cpu"
        pick_rows = eng._pick_rows

        def recording_rows(logits, reqs):
            for b, r in enumerate(reqs):
                got.setdefault(r.rid, f32(logits[b]))
            return pick_rows(logits, reqs)
        eng._pick_rows = recording_rows
        for r in _requests(Request, tcfg):
            eng.submit(r)
        done = eng.run()
        assert len(done) == 3 and all(r.error is None for r in done)
        stats = eng.tabm.stats
        assert stats["writes"] == stats["reads"] == 3
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], rtol=2e-2,
                                   atol=2e-2)


def test_engine_default_path_is_unchanged():
    """Without a placement the engine lowers every brick through one
    DeviceBackend on its own device, as before."""
    _, _, tcfg, tparams = shared_params(ARCH, "bfloat16", "nanomind-serve")
    with ServingEngine(tcfg, tparams, n_slots=2, max_len=128, block_size=32,
                       device="cpu") as eng:
        backends = {s.backend for s in eng.plan.steps}
        assert len(backends) == 1
        (be,) = backends
        assert be.name == "device" and be.device.type == "cpu"
        assert all(s.accel is None and not s.inbound
                   for s in eng.plan.steps)


def test_host_backend_on_the_cpu_binds_host_side():
    _, _, tcfg, tparams = shared_params(ARCH, "bfloat16", "nanomind-serve")
    be = HostBackend(device="cpu")
    brick = decompose(tcfg).brick("projector")
    bound = be.bind_params(brick, tparams)
    assert bound["vis_proj"]["w1"].device.type == "cpu"
    assert not bound["vis_proj"]["w1"].is_pinned()
    edge = be.make_edge(None, None)
    x = torch.ones(2, 3)
    assert torch.equal(edge(x), x)
