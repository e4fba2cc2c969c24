"""The port's energy model, substrate table and placement scheduler held
against the reference's (``analysis/energy.py``, ``core/backends.py``,
``core/scheduler.py``): the same constants give the same numbers, the
same bricks the same metadata, and the chain DP the same placement —
assignment and backends equal, latency and energy within rel 1e-12.

The bricks are priced as the reference's own tests price them
(``tests/test_scheduler_power.py``): full configs with analytic param
bytes (``max(1, flops_per_token)``), so nothing full-size is allocated.
"""
import dataclasses
import itertools
import random

import pytest
from hypothesis import given, settings, strategies as hst

from _torch_parity import shared_params
from repro.analysis import energy as RE
from repro.configs import get_config as ref_config
from repro.core import backends as RBK
from repro.core import bricks as RB
from repro.core import scheduler as RS
from repro.core.transport import resolve_transport as ref_transport
from repro_torch.analysis import energy as TE
from repro_torch.configs import get_config, list_archs
from repro_torch.core import backends as TBK
from repro_torch.core import bricks as TB
from repro_torch.core import scheduler as TS
from repro_torch.core.transport import TRANSPORTS

PROFILES = ("TPU_V5E", "EDGE_NPU", "EDGE_GPU", "EDGE_CPU")
LABELS = ("q8f16", "q4f16", "q2f16", "fp16", "bf16", "q4f16-g32",
          "q4f16-g32-sp50")
WORK = ((0.0, 0.0, 0.0), (3.7e9, 1.2e8, 0.0), (1e12, 4e6, 2e7),
        (5e7, 9e9, 1e9))


# ---------------------------------------------------------------------------
# energy model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_energy_profile_and_model_equal_reference(profile):
    tp, rp = getattr(TE, profile), getattr(RE, profile)
    assert dataclasses.asdict(tp) == dataclasses.asdict(rp)
    for flops, hbm, link in WORK:
        assert TE.step_time(tp, flops, hbm, link) == \
            RE.step_time(rp, flops, hbm, link)
        for wall in (0.0, 1e-3, 2.5):
            assert TE.step_energy(tp, flops, hbm, link, wall) == \
                RE.step_energy(rp, flops, hbm, link, wall)
        assert TE.watts(tp, flops, hbm, link) == \
            RE.watts(rp, flops, hbm, link)


@pytest.mark.parametrize("avg_watts", [0.0, 0.3, 2.5, 60.0])
def test_hours_on_battery_equals_reference(avg_watts):
    for mah, volts in ((2000.0, 3.7), (5000.0, 3.85), (100.0, 3.7)):
        assert TE.hours_on_battery(avg_watts, mah, volts) == \
            RE.hours_on_battery(avg_watts, mah, volts)
    assert TE.hours_on_battery(avg_watts) == RE.hours_on_battery(avg_watts)


# ---------------------------------------------------------------------------
# substrate table and backend resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["rk-npu", "rk-gpu", "rk-cpu", "tpu-v5e",
                                     "no-such-unit"])
def test_bit_efficiency_equals_reference(profile):
    for label in LABELS + ("q4f16-sp30", "int3", "bf16-g64"):
        assert TBK.bit_efficiency(profile, label) == \
            RBK.bit_efficiency(profile, label), label
    assert TBK.substrate_backend(profile) == RBK.substrate_backend(profile)


def test_substrate_rows_equal_reference():
    assert set(TBK.SUBSTRATES) == set(RBK.SUBSTRATES)
    for name, row in TBK.SUBSTRATES.items():
        ref = RBK.SUBSTRATES[name]
        assert (row.backend, row.bit_efficiency, row.sparse_gain) == \
            (ref.backend, ref.bit_efficiency, ref.sparse_gain)


def test_resolve_backend_priorities():
    BACKENDS = TBK.BACKENDS
    assert TBK.resolve_backend("host") is BACKENDS["host"]
    assert TBK.resolve_backend(BACKENDS["device"]) is BACKENDS["device"]
    with pytest.raises(TBK.BackendError):
        TBK.resolve_backend("no-such-substrate")
    # the accelerator's backend field beats the table
    acc = TS.Accelerator("x", TE.TPU_V5E, backend="device")
    assert TBK.resolve_backend(None, acc) is BACKENDS["device"]
    # the tpu-v5e row names submesh, which the port lacks: host
    assert TBK.resolve_backend(None, TS.Accelerator("y", TE.TPU_V5E)) \
        is BACKENDS["host"]
    # the table row of an edge profile
    npu, gpu, cpu = TS.edge_accelerators()
    assert TBK.resolve_backend(None, npu) is BACKENDS["host"]
    assert TBK.resolve_backend(None, gpu) is BACKENDS["device"]
    assert TBK.resolve_backend(None, cpu) is BACKENDS["host"]
    # nothing at all -> the device row
    assert TBK.resolve_backend(None) is BACKENDS["device"]
    assert BACKENDS["device"].device.type == "cuda"
    assert BACKENDS["host"].device.type == "cpu"
    # the device row on another torch device, cached, same name
    row = TBK.resolve_backend(None, gpu, device="cpu")
    assert row.name == "device" and row.device.type == "cpu"
    assert TBK.resolve_backend("device", None, "cpu") is row
    assert TBK.resolve_backend(None, npu, device="cpu") is BACKENDS["host"]
    assert TBK.resolve_backend(None, device="cuda") is BACKENDS["device"]


def test_device_ordinals_never_fall_back():
    with pytest.raises(TBK.BackendError):
        TBK.resolve_backend("device:abc")
    import torch
    n = torch.cuda.device_count()
    for ordinal in (n, n + 7):
        with pytest.raises(TBK.BackendError):
            TBK.resolve_backend(f"device:{ordinal}")


def test_register_backend_adds_a_row():
    be = TBK.HostBackend(pin_thread=False)
    be.name = "host-unpinned"
    try:
        assert TBK.register_backend(be) is be
        assert TBK.resolve_backend("host-unpinned") is be
    finally:
        del TBK.BACKENDS["host-unpinned"]


# ---------------------------------------------------------------------------
# bricks
# ---------------------------------------------------------------------------

def _brick_meta(g):
    return [(b.name, b.kind, b.param_keys,
             [(p.name, p.dtype_kind, p.optional) for p in b.in_ports],
             (b.out_port.name, b.out_port.dtype_kind), b.static_shape,
             b.quant_label, b.flops_per_token) for b in g.bricks]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_decompose_metadata_equals_reference(arch, reduced):
    tcfg, rcfg = get_config(arch), ref_config(arch)
    if reduced:
        tcfg, rcfg = tcfg.reduced(), rcfg.reduced()
    tg, rg = TB.decompose(tcfg), RB.decompose(rcfg)
    assert _brick_meta(tg) == _brick_meta(rg)
    assert tg.names() == rg.names()


def test_populate_brick_bytes_equals_reference():
    """Bridged ``nanomind-serve`` weights of reduced LLaVA: the port's
    per-brick bytes are the reference's (packed codes and scales
    counted; the tied table in both the embedding and the head)."""
    rcfg, rparams, tcfg, tparams = shared_params(
        "llava-onevision-0.5b", "bfloat16", "nanomind-serve")
    tg, rg = TB.decompose(tcfg), RB.decompose(rcfg)
    want = RB.brick_param_bytes(rg, rparams)
    assert TB.brick_param_bytes(tg, tparams) == want
    TS.populate_brick_bytes(tg, tparams)
    RS.populate_brick_bytes(rg, rparams)
    assert {b.name: b.param_bytes for b in tg.bricks} == \
        {b.name: b.param_bytes for b in rg.bricks} == want
    from repro_torch.core.quantize import tree_bytes
    # tied: the table counts in the embedding and in the head
    assert want["head"] == want["embedding"] + tree_bytes(
        tparams["final_norm"])
    assert want["vision_frontend"] == 0


# ---------------------------------------------------------------------------
# the chain DP
# ---------------------------------------------------------------------------

def _graphs(arch):
    """The port's and the reference's full-config graphs with the
    reference test's analytic param bytes."""
    out = []
    for dec, cfg in ((TB.decompose, get_config(arch)),
                     (RB.decompose, ref_config(arch))):
        g = dec(cfg)
        g.bricks = [dataclasses.replace(
            b, param_bytes=max(1, int(b.flops_per_token)))
            for b in g.bricks]
        out.append(g)
    return out


def _same_placement(got, want):
    assert got.assignment == want.assignment
    assert list(got.assignment) == list(want.assignment)
    assert got.backends == want.backends
    assert got.latency_s == pytest.approx(want.latency_s, rel=1e-12)
    assert got.energy_j == pytest.approx(want.energy_j, rel=1e-12)
    assert set(got.per_brick) == set(want.per_brick)
    for name, c in got.per_brick.items():
        w = want.per_brick[name]
        assert c.latency_s == pytest.approx(w.latency_s, rel=1e-12)
        assert c.energy_j == pytest.approx(w.energy_j, rel=1e-12)
        assert c.feasible == w.feasible


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("n_tokens", [24, 256, 1024])
@pytest.mark.parametrize("arch", ["llava-onevision-0.5b", "qwen2-vl-7b",
                                  "seamless-m4t-large-v2"])
def test_schedule_equals_reference(arch, n_tokens, objective):
    tg, rg = _graphs(arch)
    got = TS.schedule(tg, TS.edge_accelerators(), n_tokens, objective)
    want = RS.schedule(rg, RS.edge_accelerators(), n_tokens, objective)
    _same_placement(got, want)
    assert str(got) == str(want)


@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_llava_places_vision_on_npu_decoder_on_gpu(objective):
    """At LLaVA's full config and 1024 tokens the DP puts the static
    vision side on the NPU (host backend) and the rest on the GPU
    (device backend), as the reference's does."""
    tg, _ = _graphs("llava-onevision-0.5b")
    pl = TS.schedule(tg, TS.edge_accelerators(), 1024, objective)
    assert pl.assignment == {"vision_frontend": "npu", "projector": "npu",
                             "embedding": "gpu", "decoder": "gpu",
                             "head": "gpu"}
    assert pl.backends == {"vision_frontend": "host", "projector": "host",
                           "embedding": "device", "decoder": "device",
                           "head": "device"}


@pytest.mark.parametrize("batch,mem_clock_scale", [(4, 1.0), (1, 0.5),
                                                   (8, 0.7)])
def test_schedule_batch_and_clock_equal_reference(batch, mem_clock_scale):
    tg, rg = _graphs("llava-onevision-0.5b")
    for objective in ("latency", "energy"):
        got = TS.schedule(tg, TS.edge_accelerators(), 729, objective,
                          mem_clock_scale=mem_clock_scale, batch=batch)
        want = RS.schedule(rg, RS.edge_accelerators(), 729, objective,
                           mem_clock_scale=mem_clock_scale, batch=batch)
        _same_placement(got, want)


def test_edge_accelerators_and_costs_equal_reference():
    tg, rg = _graphs("llava-onevision-0.5b")
    ta, ra = TS.edge_accelerators(), RS.edge_accelerators()
    assert [(a.name, dataclasses.asdict(a.profile), a.static_only,
             a.backend, a.backend_name()) for a in ta] == [
        (a.name, dataclasses.asdict(a.profile), a.static_only, a.backend,
         a.backend_name()) for a in ra]
    assert TS.edge_bytes(tg, 729) == RS.edge_bytes(rg, 729)
    for tb, rb in zip(tg.bricks, rg.bricks):
        for x, y in zip(ta, ra):
            c, w = TS.brick_cost(tb, x, 256), RS.brick_cost(rb, y, 256)
            assert (c.latency_s, c.energy_j, c.feasible) == \
                (w.latency_s, w.energy_j, w.feasible)
            assert x.throughput_scale(tb.quant_label) == \
                y.throughput_scale(rb.quant_label)
    for (x, y), (u, v) in itertools.product(zip(ta, ra), repeat=2):
        assert TS.transfer_cost(1 << 20, x, u) == \
            RS.transfer_cost(1 << 20, y, v)
    assert not TS.brick_cost(tg.brick("decoder"), ta[0], 16).feasible


def _brute_force(graph, accels, n_tokens, objective):
    best = float("inf")
    bricks = graph.bricks
    xfer = TS.edge_bytes(graph, n_tokens)
    for combo in itertools.product(range(len(accels)), repeat=len(bricks)):
        total, prev = 0.0, None
        for b, a in zip(bricks, combo):
            c = TS.brick_cost(b, accels[a], n_tokens)
            if not c.feasible:
                total = float("inf")
                break
            total += c.energy_j if objective == "energy" else c.latency_s
            if prev is not None and prev != a:
                tt, te = TS.transfer_cost(xfer, accels[prev], accels[a])
                total += te if objective == "energy" else tt
            prev = a
        best = min(best, total)
    return best


@settings(max_examples=25, deadline=None)
@given(seed=hst.integers(0, 10_000),
       objective=hst.sampled_from(["latency", "energy"]))
def test_dp_matches_brute_force_and_reference(seed, objective):
    """Randomised bricks: the DP's cost is the brute-force optimum, and
    the placement is the reference's."""
    rnd = random.Random(seed)
    tg, rg = _graphs("llava-onevision-0.5b")
    draws = [dict(param_bytes=rnd.randint(1, 10**9),
                  flops_per_token=rnd.uniform(0, 1e9),
                  static_shape=rnd.random() < 0.5) for _ in tg.bricks]
    tg.bricks = [dataclasses.replace(b, **d) for b, d in zip(tg.bricks, draws)]
    rg.bricks = [dataclasses.replace(b, **d) for b, d in zip(rg.bricks, draws)]
    accels = TS.edge_accelerators()
    pl = TS.schedule(tg, accels, 256, objective)
    got = pl.energy_j if objective == "energy" else pl.latency_s
    assert got == pytest.approx(_brute_force(tg, accels, 256, objective),
                                rel=1e-6)
    _same_placement(pl, RS.schedule(rg, RS.edge_accelerators(), 256,
                                    objective))


def test_no_feasible_placement_raises():
    tg, _ = _graphs("llava-onevision-0.5b")
    npu = TS.edge_accelerators()[0]
    with pytest.raises(RuntimeError):
        TS.schedule(tg, [npu], 64)


# ---------------------------------------------------------------------------
# the split over a transport
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["inproc", "pipe", "socket"])
def test_schedule_split_equals_reference(transport):
    graph = TB.decompose(get_config("llava-onevision-0.5b"))
    rgraph = RB.decompose(ref_config("llava-onevision-0.5b"))
    for n_tokens in (196, 729):
        got = TS.schedule_split(graph, transport, n_tokens=n_tokens)
        want = RS.schedule_split(rgraph, transport, n_tokens=n_tokens)
        assert str(got) == str(want)
        _same_placement(got, want)
        # a class or an instance-like object prices the same
        assert str(TS.schedule_split(graph, TRANSPORTS[transport],
                                     n_tokens=n_tokens)) == str(want)


def test_fleet_rows_equal_reference():
    for name in ("inproc", "pipe", "socket"):
        got = TS.fleet_accelerators(TRANSPORTS[name])
        want = RS.fleet_accelerators(ref_transport(name))
        assert [(a.name, dataclasses.asdict(a.profile), a.static_only,
                 a.backend) for a in got] == [
            (a.name, dataclasses.asdict(a.profile), a.static_only,
             a.backend) for a in want]
        assert got[0].profile.link_bw == min(TE.TPU_V5E.link_bw,
                                             TRANSPORTS[name].link_bw)
    one = TS.fleet_accelerators(TRANSPORTS["pipe"], n_devices=1)
    assert [a.backend for a in one] == ["device:0", "device:0"]
    fast = TS.schedule_split(TB.decompose(get_config(
        "llava-onevision-0.5b")), "inproc", n_tokens=729)
    assert fast.assignment["projector"] == "prefill-fleet"
    assert fast.assignment["decoder"] == "decode-fleet"
