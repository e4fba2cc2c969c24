"""The port's fleet battery simulator (``telemetry/fleet.py``) and its
launcher (``launch/fleet_sim.py``) held against the reference's: the
same profile and seed give reports that are equal, not close (tokens/s,
J/token, survival arrays, ticks per state, shed tokens, the histogram,
the summary text), the same trace, and the same replay through fresh
PMUs; the launchers print the same lines.
"""
import contextlib
import io

import numpy as np
import pytest

from repro.launch import fleet_sim as RFS
from repro.telemetry import fleet as RF
from repro.telemetry import ledger as RL
from repro_torch.launch import fleet_sim as TFS
from repro_torch.telemetry import fleet as TF
from repro_torch.telemetry import ledger as TL

# a small pack so a short horizon crosses every power state
SIM = dict(battery_mah=40.0, dt_s=15.0)
HOURS = 1.5


def _profiles(kind):
    if kind == "default":
        return TF.ModalityProfile.default_edge(), \
            RF.ModalityProfile.default_edge()
    return TFS.modeled_profile()[0], RFS.modeled_profile()[0]


def _same_profile(a, b):
    assert dict(a.j_per_token) == dict(b.j_per_token)
    assert dict(a.tokens_per_s) == dict(b.tokens_per_s)
    assert a.idle_w == b.idle_w


def _same_report(a, b):
    assert (a.n_devices, a.hours, a.tokens_per_s, a.j_per_token, a.dead,
            a.states_seen, a.state_ticks, a.shed_tokens) == \
        (b.n_devices, b.hours, b.tokens_per_s, b.j_per_token, b.dead,
         b.states_seen, b.state_ticks, b.shed_tokens)
    assert np.array_equal(a.survival_hours, b.survival_hours)
    assert a.survival_hours_p50 == b.survival_hours_p50
    for bins in (4, 8):
        (c, e), (rc, re_) = a.histogram(bins), b.histogram(bins)
        assert np.array_equal(c, rc) and np.array_equal(e, re_)
    assert a.summary() == b.summary()


@pytest.mark.parametrize("kind", ["default", "modeled"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_reports_equal_reference(seed, kind):
    prof, rprof = _profiles(kind)
    _same_profile(prof, rprof)
    rep = TF.FleetSimulator(24, prof, seed=seed, **SIM).run(HOURS)
    rrep = RF.FleetSimulator(24, rprof, seed=seed, **SIM).run(HOURS)
    _same_report(rep, rrep)
    assert rep.dead > 0 and len(rep.states_seen) == 3


def test_fleet_trace_and_replay_equal_reference():
    prof, rprof = _profiles("default")
    sim = TF.FleetSimulator(6, prof, seed=3, record_trace=True,
                            request_hz=(0.1, 0.4), **SIM)
    rsim = RF.FleetSimulator(6, rprof, seed=3, record_trace=True,
                             request_hz=(0.1, 0.4), **SIM)
    _same_report(sim.run(HOURS), rsim.run(HOURS))
    trace, rtrace = list(sim.trace), list(rsim.trace)
    assert [tuple(e) for e in trace] == [tuple(e) for e in rtrace]
    got = TF.replay_trace(trace, battery_mah=SIM["battery_mah"])
    want = RF.replay_trace(rtrace, battery_mah=SIM["battery_mah"])
    assert got == want
    # the state machine is a pure function of the drain history
    for dev, seq in got.items():
        rec = [(e.state, e.level) for e in trace if e.device == dev]
        assert [s for s, _ in seq] == [s for s, _ in rec]
        assert [lv for _, lv in seq] == [lv for _, lv in rec]


def _ledger_pair(seed):
    rng = np.random.default_rng(seed)
    t, r = TL.Ledger(), RL.Ledger()
    for brick, phase in (("vision_encoder", "stage"), ("projector", "stage"),
                         ("decoder", "prefill"), ("head", "prefill"),
                         ("decoder", "decode"), ("embedding", "decode")):
        f = dict(seconds=float(rng.uniform(0.01, 2.0)),
                 tokens=float(rng.integers(1, 900)),
                 joules=float(rng.uniform(0.0, 40.0)),
                 samples=int(rng.integers(0, 4)))
        t.accumulate(brick, phase, **f)
        r.accumulate(brick, phase, **f)
    return t, r


@pytest.mark.parametrize("seed", [0, 1])
def test_profile_from_ledger_equals_reference(seed):
    t, r = _ledger_pair(seed)
    for idle in (0.35, 120.0):
        _same_profile(TF.ModalityProfile.from_ledger(t, idle_w=idle),
                      RF.ModalityProfile.from_ledger(r, idle_w=idle))
    _same_profile(TF.ModalityProfile.default_edge(),
                  RF.ModalityProfile.default_edge())
    empty = TL.Ledger()
    empty.accumulate("decoder", "decode", seconds=1.0, tokens=4.0)
    with pytest.raises(ValueError):
        TF.ModalityProfile.from_ledger(empty)


def _out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_fleet_sim_smoke_prints_the_reference_summary():
    rc, out = _out(TFS.main, ["--smoke"])
    rrc, rout = _out(RFS.main, ["--smoke"])
    assert rc == rrc == 0
    assert out == rout
    assert "OK: fleet smoke passed" in out.splitlines()[-1]


@pytest.mark.parametrize("profile", ["default", "ledger"])
def test_fleet_sim_profiles_print_the_reference_lines(profile, tmp_path):
    argv = ["--devices", "16", "--hours", "1", "--dt", "60",
            "--battery-mah", "60", "--seed", "5", "--profile", profile]
    if profile == "ledger":
        t, r = _ledger_pair(4)
        path = str(tmp_path / "ledger.json")
        t.save(path)
        assert open(path).read() == open(r.save(
            str(tmp_path / "ref.json"))).read()
        argv += ["--ledger", path]
    assert _out(TFS.main, argv) == _out(RFS.main, argv)
