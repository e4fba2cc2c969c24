"""The port's measured-cost loop held against the reference's: the
calibration table (``telemetry/calibration.py``), the modeled ledger
(``Ledger.modeled``), the calibrated scheduler (``brick_cost``,
``schedule``, ``fleet_accelerators``, ``schedule_split`` with
``calibration=``), the engine's KV energy pressure and measured table,
the launcher's ``--calibration`` loop and the disaggregated launcher's
recalibrated split.

Tables, saved bytes, ledgers and placements are compared with ``==``:
both packages compute them in Python floats with the same operations.
The engine runs reduced LLaVA on the CPU with synchronous staging, so
both engines admit in lockstep and every admission round's budgets can
be compared.
"""
import dataclasses
import json

import numpy as np
import pytest

from _torch_parity import shared_params
from repro.configs import get_config as ref_config
from repro.core import bricks as RB
from repro.core import scheduler as RS
from repro.launch import fleet_sim as RFS
from repro.serving import engine as RE
from repro.serving.disagg import PrefillStats as RPrefillStats
from repro.telemetry import calibration as RC
from repro.telemetry import ledger as RL
from repro_torch.configs import get_config
from repro_torch.core import bricks as TB
from repro_torch.core import scheduler as TS
from repro_torch.launch import fleet_sim as TFS
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import serve_disagg as TSD
from repro_torch.serving import engine as TE
from repro_torch.serving.disagg import PrefillStats
from repro_torch.telemetry import CostCalibration
from repro_torch.telemetry import ledger as TL

ARCH = "llava-onevision-0.5b"
BRICKS = ("vision_frontend", "projector", "embedding", "decoder", "head",
          CostCalibration.LINK_KEY)
PROFS = (None, "rk-npu", "rk-gpu", "rk-cpu", "inproc", "pipe")


def _observations(seed, n=40):
    """A seeded sequence of ``observe`` / ``observe_link`` calls."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        brick = BRICKS[int(rng.integers(len(BRICKS)))]
        prof = PROFS[int(rng.integers(len(PROFS)))]
        sec = float(rng.uniform(1e-4, 2.0))
        tok = float(rng.integers(0, 2000))
        joules = float(rng.uniform(0, 5.0)) if rng.random() < 0.5 else 0.0
        cnt = int(rng.integers(0, 9))
        out.append((brick, prof, sec, tok, joules, cnt))
    return out


def _fill(cal, obs):
    for brick, prof, sec, tok, joules, cnt in obs:
        if brick == cal.LINK_KEY and joules == 0.0:
            cal.observe_link(prof, tok * 1e3, sec, n=cnt)
        else:
            cal.observe(brick, prof, sec, tok, joules=joules, n=cnt)
    return cal


@pytest.mark.parametrize("prior", [0, 1, 4, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_table_equals_reference(seed, prior, tmp_path):
    obs = _observations(seed)
    got = _fill(CostCalibration(prior=prior), obs)
    want = _fill(RC.CostCalibration(prior=prior), obs)
    assert got.prior == want.prior and len(got) == len(want)
    assert bool(got) == bool(want)
    assert got.to_dict() == want.to_dict()
    for brick in BRICKS:
        for prof in PROFS:
            s, r = got.sample(brick, prof), want.sample(brick, prof)
            assert (s is None) == (r is None)
            if s is not None:
                assert dataclasses.astuple(s) == dataclasses.astuple(r)
                assert s.seconds_per_token == r.seconds_per_token
                assert s.joules_per_token == r.joules_per_token
            for modeled in (0.0, 0.0329, 1.5):
                assert got.energy_pressure(brick, prof, modeled) == \
                    want.energy_pressure(brick, prof, modeled)
        for bw in (1e6, 8e9):
            assert got.link_bw(brick if brick in PROFS else None, bw) == \
                want.link_bw(brick if brick in PROFS else None, bw)
    for prof in PROFS:
        for bw in (1e6, 2.5e9, 8e9):
            assert got.link_bw(prof, bw) == want.link_bw(prof, bw)
    for n in (0, 1, 7, 10_000):
        assert got.weight(n) == want.weight(n)
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    got.save(str(a))
    want.save(str(b))
    assert a.read_bytes() == b.read_bytes()
    back = CostCalibration.load(str(b))
    assert back.to_dict() == want.to_dict()
    assert CostCalibration.from_dict(json.loads(a.read_text())).to_dict() \
        == RC.CostCalibration.load(str(a)).to_dict()


def test_empty_table_saves_like_the_reference(tmp_path):
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    CostCalibration().save(str(a))
    RC.CostCalibration().save(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert not CostCalibration() and len(CostCalibration()) == 0


def _ledgers(seed):
    rng = np.random.default_rng(seed)
    t, r = TL.Ledger(), RL.Ledger()
    for _ in range(30):
        brick = BRICKS[int(rng.integers(5))]
        phase = TL.PHASES[int(rng.integers(3))]
        fields = dict(seconds=float(rng.uniform(0, 3)),
                      tokens=float(rng.integers(0, 500)),
                      joules=float(rng.uniform(0, 2)),
                      samples=int(rng.integers(0, 3)))
        t.accumulate(brick, phase, **fields)
        r.accumulate(brick, phase, **fields)
    return t, r


@pytest.mark.parametrize("profile", [None, "rk-gpu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_from_ledger_equals_reference(seed, profile):
    t, r = _ledgers(seed)
    assert t.to_dict() == r.to_dict()
    got = CostCalibration.from_ledger(t, profile=profile, prior=3)
    want = RC.CostCalibration.from_ledger(r, profile=profile, prior=3)
    assert got.to_dict() == want.to_dict()


def test_from_ledger_skips_modeled_rows():
    led = TL.Ledger()
    led.accumulate("decoder", "decode", seconds=1.0, tokens=10, samples=2)
    led.accumulate("embedding", "decode", seconds=9.0, tokens=10, samples=0)
    led.accumulate("head", "decode", seconds=9.0, tokens=0, samples=5)
    cal = CostCalibration.from_ledger(led)
    assert cal.sample("decoder") is not None
    assert cal.sample("embedding") is None, "samples == 0 rows are modeled"
    assert cal.sample("head") is None, "rows without tokens price nothing"


# ---------------------------------------------------------------------------
# the modeled ledger
# ---------------------------------------------------------------------------

def _analytic(g):
    g.bricks = [dataclasses.replace(
        b, param_bytes=max(1, int(b.flops_per_token))) for b in g.bricks]
    return g


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("per_brick", [False, True])
def test_modeled_ledger_equals_reference_on_reduced_llava(per_brick, batch):
    g = _analytic(TB.decompose(get_config(ARCH).reduced()))
    rg = _analytic(RB.decompose(ref_config(ARCH).reduced()))
    acc, racc = TS.edge_accelerators(), RS.edge_accelerators()
    phases = {"stage": 8, "prefill": 24, "decode": 1}
    if per_brick:
        pl = TS.schedule(g, acc, 24, "energy")
        rpl = RS.schedule(rg, racc, 24, "energy")
        assert pl.assignment == rpl.assignment
        by, rby = {a.name: a for a in acc}, {a.name: a for a in racc}
        accel_for = {b: by[a] for b, a in pl.assignment.items()}
        raccel_for = {b: rby[a] for b, a in rpl.assignment.items()}
    else:
        accel_for, raccel_for = acc[1], racc[1]
    got = TL.Ledger.modeled(g, accel_for, phases, batch=batch)
    want = RL.Ledger.modeled(rg, raccel_for, phases, batch=batch)
    assert got.to_dict() == want.to_dict()
    assert all(rec.samples == 0 for _, _, rec in got.items())
    # an NPU-only ledger drops the dynamic bricks (infeasible there)
    npu = TL.Ledger.modeled(g, acc[0], phases)
    assert npu.to_dict() == RL.Ledger.modeled(rg, racc[0], phases).to_dict()


def test_paper_pipeline_and_modeled_profile_equal_reference():
    g, rg = TFS._paper_pipeline(), RFS._paper_pipeline()
    assert [(b.name, b.kind, b.static_shape, b.quant_label,
             b.flops_per_token, b.param_bytes) for b in g.bricks] == \
        [(b.name, b.kind, b.static_shape, b.quant_label,
          b.flops_per_token, b.param_bytes) for b in rg.bricks]
    prof, led = TFS.modeled_profile()
    rprof, rled = RFS.modeled_profile()
    assert led.to_dict() == rled.to_dict()
    assert dict(prof.j_per_token) == dict(rprof.j_per_token)
    assert dict(prof.tokens_per_s) == dict(rprof.tokens_per_s)


# ---------------------------------------------------------------------------
# the calibrated scheduler (tests/test_telemetry.py and
# tests/test_transport.py's named cases, on both packages)
# ---------------------------------------------------------------------------

def _graphs():
    return (_analytic(TB.decompose(get_config(ARCH))),
            _analytic(RB.decompose(ref_config(ARCH))))


def _both(fn):
    """``fn(package scheduler, package table class)`` on both packages."""
    return fn(TS, CostCalibration), fn(RS, RC.CostCalibration)


def _cost(c):
    return (c.latency_s, c.energy_j, c.feasible)


def test_brick_cost_calibrated_equals_reference():
    g, rg = _graphs()

    def case(S, Cal):
        gg = g if S is TS else rg
        acc = next(a for a in S.edge_accelerators() if a.name == "gpu")
        npu = next(a for a in S.edge_accelerators() if a.name == "npu")
        brick = gg.brick("decoder")
        base = S.brick_cost(brick, acc, 64)
        slow = base.latency_s / 64 * 10
        out = [_cost(base),
               _cost(S.brick_cost(brick, acc, 64, calibration=Cal()))]
        for n, joules in ((4, 0.0), (4000, 0.0), (4, 2.5), (1, 0.25)):
            cal = Cal(prior=4)
            cal.observe("decoder", acc.profile.name, seconds=slow * 640,
                        tokens=640, joules=joules, n=n)
            out.append(_cost(S.brick_cost(brick, acc, 64, calibration=cal)))
            out.append(_cost(S.brick_cost(brick, acc, 64, batch=3,
                                          mem_clock_scale=0.5,
                                          calibration=cal)))
        # the profile-agnostic key prices every unit
        cal = Cal(prior=2)
        cal.observe("decoder", None, seconds=1.0, tokens=100, joules=3.0)
        out += [_cost(S.brick_cost(brick, a, 64, calibration=cal))
                for a in S.edge_accelerators()]
        dyn = dataclasses.replace(brick, static_shape=False)
        cal3 = Cal()
        cal3.observe(dyn.name, npu.profile.name, seconds=1e-9, tokens=1e6,
                     n=10_000)
        out.append(_cost(S.brick_cost(dyn, npu, 64, calibration=cal3)))
        return out

    got, want = _both(case)
    assert got == want
    base, empty, half = got[0], got[1], got[2]
    assert empty == base
    assert half[0] > base[0] and half[1] == base[1]
    assert got[-1] == (float("inf"), float("inf"), False)


@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_schedule_placement_flips_under_calibration(objective):
    g, rg = _graphs()

    def case(S, Cal):
        gg = g if S is TS else rg
        accels = S.edge_accelerators()
        base = S.schedule(gg, accels, 256, objective)
        home = base.assignment["decoder"]
        prof = next(a for a in accels if a.name == home).profile.name
        cal = Cal(prior=1)
        cal.observe("decoder", prof, seconds=1e4, tokens=1.0, joules=1e4,
                    n=10_000)
        moved = S.schedule(gg, accels, 256, objective, calibration=cal)
        same = S.schedule(gg, accels, 256, objective, calibration=Cal())
        return [(p.assignment, p.latency_s, p.energy_j, p.backends,
                 {k: _cost(c) for k, c in p.per_brick.items()}, str(p))
                for p in (base, moved, same)]

    got, want = _both(case)
    assert got == want
    base, moved, same = got
    assert moved[0]["decoder"] != base[0]["decoder"]
    assert same[0] == base[0]


def test_fleet_rows_blend_the_measured_link():
    from repro.core.transport import resolve_transport as rresolve
    from repro_torch.core.transport import resolve_transport

    for name in ("inproc", "pipe", "socket"):
        for bytes_moved, secs, n, prior in ((1e6, 1.0, 64, 1),
                                            (3e9, 0.5, 2, 4),
                                            (1e6, 1.0, 1, 1 << 20)):
            cal, rcal = CostCalibration(prior=prior), \
                RC.CostCalibration(prior=prior)
            cal.observe_link(name, bytes_moved, secs, n=n)
            rcal.observe_link(name, bytes_moved, secs, n=n)
            rows = TS.fleet_accelerators(resolve_transport(name),
                                         calibration=cal)
            rrows = RS.fleet_accelerators(rresolve(name), calibration=rcal)
            assert [(a.name, dataclasses.asdict(a.profile), a.static_only,
                     a.backend) for a in rows] == \
                [(a.name, dataclasses.asdict(a.profile), a.static_only,
                  a.backend) for a in rrows]


def test_schedule_split_measured_link_flips_placement():
    graph = TB.decompose(get_config(ARCH))
    rgraph = RB.decompose(ref_config(ARCH))

    def case(S, Cal):
        gg = graph if S is TS else rgraph
        static = S.schedule_split(gg, "inproc", n_tokens=729)
        cal = Cal(prior=1)
        cal.observe_link("inproc", bytes_moved=1e6, seconds=1.0, n=64)
        measured = S.schedule_split(gg, "inproc", n_tokens=729,
                                    calibration=cal)
        light = Cal(prior=1 << 20)
        light.observe_link("inproc", bytes_moved=1e6, seconds=1.0, n=1)
        barely = S.schedule_split(gg, "inproc", n_tokens=729,
                                  calibration=light)
        both = Cal(prior=2)
        both.observe_link("inproc", bytes_moved=5e8, seconds=1.0, n=8)
        both.observe("decoder", None, seconds=2.0, tokens=10.0, n=8)
        mixed = S.schedule_split(gg, "inproc", n_tokens=729,
                                 calibration=both)
        return [(p.assignment, p.latency_s, p.energy_j, str(p))
                for p in (static, measured, barely, mixed)]

    got, want = _both(case)
    assert got == want
    static, measured, barely, _ = got
    assert static[0]["vision_frontend"] == "prefill-fleet"
    assert set(measured[0].values()) == {"decode-fleet"}
    assert barely[0] == static[0]


# ---------------------------------------------------------------------------
# the engine: KV energy pressure, budgets, the measured table
# ---------------------------------------------------------------------------

def _placements():
    g, rg = _graphs()
    acc, racc = TS.edge_accelerators(), RS.edge_accelerators()
    pl = TS.schedule(g, acc, n_tokens=1024)
    rpl = RS.schedule(rg, racc, n_tokens=1024)
    assert pl.assignment == rpl.assignment
    assert pl.assignment["decoder"] == "gpu"
    return pl, acc, rpl, racc


def _requests(request_cls, cfg):
    rng = np.random.default_rng(0)
    reqs = []
    for rid, (nt, plen) in enumerate([(8, 12), (2, 7), (8, 10), (2, 9),
                                      (8, 11)]):
        feats = (rng.standard_normal((1, nt, cfg.vision_feat_dim)) * 0.02
                 ).astype(np.float32)
        reqs.append(request_cls(
            rid=rid, tokens=(np.arange(plen) % 50 + 3).astype(np.int32),
            n_images=1, max_new_tokens=4, vision_feats=feats))
    return reqs


def _table(cls, joules_per_token):
    cal = cls(prior=4)
    cal.observe("decoder", "rk-gpu", seconds=0.5, tokens=200.0,
                joules=200.0 * joules_per_token, n=40)
    cal.observe("projector", None, seconds=0.01, tokens=48.0, n=4)
    return cal


def _run_engine(module, cfg, params, reqs, budgets, **kw):
    real = module.kv_block_budgets

    def recording(*a, **k):
        out = real(*a, **k)
        budgets.append((k.get("energy_pressure"), dict(out)))
        return out
    old = module.kv_block_budgets
    module.kv_block_budgets = recording
    try:
        with module.ServingEngine(cfg, params, n_slots=2, max_len=128,
                                  block_size=32, kv_blocks=6,
                                  async_staging=False, **kw) as eng:
            press = eng._kv_energy_pressure()
            step = next(s for s in eng.plan.steps
                        if s.brick.kind == "decoder")
            modeled = (step.brick, step.accel)
            for r in reqs:
                eng.submit(r)
            done = eng.run(max_steps=200)
            table = eng.measured_calibration()
            held = [r.rid for r in eng.queue]
    finally:
        module.kv_block_budgets = old
    return press, done, table, held, modeled


def _modeled_decode_j(tcfg, tparams, pl, acc):
    """The modeled J/token of the placed engine's decoder step."""
    with TE.ServingEngine(tcfg, tparams, n_slots=2, max_len=128,
                          block_size=32, placement=pl, accels=acc,
                          async_staging=False, device="cpu") as eng:
        step = next(s for s in eng.plan.steps if s.brick.kind == "decoder")
        return TS.brick_cost(step.brick, step.accel, 1).energy_j


@pytest.mark.parametrize("ratio", [0.0, 0.5, 2.0, 30.0, 1e4])
def test_engine_energy_pressure_and_budgets_equal_reference(ratio):
    """Measured decode joules at ``ratio`` times the model: the pressure
    (1.0 without joules, and never below it in the budgets), every
    admission round's budgets and the admitted and held requests equal
    the reference engine's."""
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, "float32",
                                                 "nanomind-serve")
    pl, acc, rpl, racc = _placements()
    jpt = ratio * _modeled_decode_j(tcfg, tparams, pl, acc)
    got_b, want_b = [], []
    press, done, table, held, (brick, accel) = _run_engine(
        TE, tcfg, tparams, _requests(TE.Request, tcfg), got_b,
        placement=pl, accels=acc, calibration=_table(CostCalibration, jpt),
        device="cpu")
    rpress, rdone, rtable, rheld, _ = _run_engine(
        RE, rcfg, rparams, _requests(RE.Request, rcfg), want_b,
        placement=rpl, accels=racc,
        calibration=_table(RC.CostCalibration, jpt))
    assert accel.profile.name == "rk-gpu"
    modeled = TS.brick_cost(brick, accel, 1).energy_j
    assert press == rpress
    measured = _table(CostCalibration, jpt).sample("decoder", "rk-gpu")
    assert press == (measured.joules_per_token / modeled if jpt > 0
                     else 1.0)
    assert press == pytest.approx(ratio if ratio else 1.0, rel=1e-12)
    assert got_b == want_b and len(got_b) > 0
    assert all(p == press for p, _ in got_b)
    assert sorted(r.rid for r in done) == sorted(r.rid for r in rdone)
    assert held == rheld
    thumb = list(TE.SlotClassPool.from_config(
        tcfg, dim=tcfg.d_model, device="cpu").classes)[0]
    assert got_b[0][1][thumb] == 6, "the thumbnail class keeps the pool"
    ta, wa = table.to_dict()["table"], rtable.to_dict()["table"]
    assert sorted(ta) == sorted(wa)
    for key in ta:
        assert ta[key]["tokens"] == wa[key]["tokens"], key
        assert ta[key]["n"] == wa[key]["n"], key


def test_engine_without_accel_or_table_is_unpressed():
    _, _, tcfg, tparams = shared_params(ARCH, "float32", "nanomind-serve")
    cal = _table(CostCalibration, 0.2)
    with TE.ServingEngine(tcfg, tparams, n_slots=2, max_len=128,
                          block_size=32, calibration=cal,
                          device="cpu") as eng:
        assert eng._kv_energy_pressure() == 1.0      # no accel on the step
    pl, acc, _, _ = _placements()
    with TE.ServingEngine(tcfg, tparams, n_slots=2, max_len=128,
                          block_size=32, placement=pl, accels=acc,
                          device="cpu") as eng:
        assert eng._kv_energy_pressure() == 1.0      # no table
    with TE.ServingEngine(tcfg, tparams, n_slots=2, max_len=128,
                          block_size=32, placement=pl, accels=acc,
                          calibration=cal, device="cpu") as eng:
        p = eng._kv_energy_pressure()
        assert p > 1.0 and eng._kv_energy_pressure() is p    # cached


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_calibration_persists_across_two_runs(tmp_path, capsys,
                                                    monkeypatch):
    path = str(tmp_path / "cal.json")
    tables = []

    class Recording(TSERVE.ServingEngine):
        def measured_calibration(self, prior=4):
            t = super().measured_calibration(prior)
            tables.append(t.to_dict()["table"])
            return t
    monkeypatch.setattr(TSERVE, "ServingEngine", Recording)
    argv = ["--device", "cpu", "--requests", "3", "--max-new", "4",
            "--calibration", path]
    assert TSERVE.main(argv) == 0
    first = capsys.readouterr().out
    assert "loaded calibration" not in first
    saved1 = json.load(open(path))["table"]
    assert saved1 == tables[0]
    assert TSERVE.main(argv) == 0
    second = capsys.readouterr().out
    assert f"[serve] loaded calibration from {path} ({len(saved1)} " \
        f"entries)" in second
    saved2 = json.load(open(path))["table"]
    assert sorted(saved2) == sorted(saved1)
    for key in saved1:
        assert saved2[key]["n"] == saved1[key]["n"] + tables[1][key]["n"]
        assert saved2[key]["tokens"] == \
            saved1[key]["tokens"] + tables[1][key]["tokens"]
    assert saved2["decoder@"]["n"] > saved1["decoder@"]["n"]


@pytest.mark.parametrize("transport", ["inproc", "pipe", "socket"])
@pytest.mark.parametrize("wire", [(269304, 1.551, 4), (1e6, 1.0, 64),
                                  (13_890_000, 0.00002, 1)])
def test_recalibrated_split_line_equals_reference(transport, wire):
    """The launcher's recalibrated split, fed the bytes and seconds the
    reference's launcher would print from, gives its line."""
    nbytes, secs, sent = wire
    from repro.core.transport import resolve_transport as rresolve
    name = rresolve(transport).name
    stats = PrefillStats(sent=sent, wire_bytes=int(nbytes),
                         wire_seconds=secs, transport=name)
    graph = TB.decompose(get_config(ARCH))
    bw, split = TSD.recalibrated_split(graph, transport, stats, 729)
    got = TSD.recalibrated_line(bw, split)
    # the reference launcher's own lines (launch/serve_disagg.py:208-219)
    rstats = RPrefillStats(sent=sent, wire_bytes=int(nbytes),
                           wire_seconds=secs, transport=name)
    cal = RC.CostCalibration()
    cal.observe_link(rstats.transport, rstats.wire_bytes,
                     rstats.wire_seconds, n=max(1, rstats.sent))
    mbw = rstats.wire_bytes / rstats.wire_seconds
    split2 = RS.schedule_split(RB.decompose(ref_config(ARCH)), transport,
                               n_tokens=729, calibration=cal)
    want = (f"[schedule_split recalibrated @ {mbw / 1e6:.0f} MB/s "
            f"measured] {split2}")
    assert got == want
    assert TSD.recalibrated_split(graph, transport, PrefillStats(), 729) \
        is None
