"""Fleet-scale battery simulation CLI of the port.

Drives :class:`repro_torch.telemetry.fleet.FleetSimulator` over hundreds
of simulated battery devices, each characterized per modality phase
(stage / prefill / decode) from a telemetry
:class:`~repro_torch.telemetry.ledger.Ledger`:

* ``--profile modeled`` (default) prices the paper's full edge pipeline
  (decomposed llava-onevision graph incl. a SigLip-class vision encoder
  brick) through the scheduler's energy-objective placement and
  ``Ledger.modeled`` — deterministic across machines, the reference's
  numbers for the same arguments;
* ``--profile ledger --ledger FILE`` characterizes from a measured
  ledger (``samples > 0`` rows included), e.g. one whose decoder rows
  carry the card's energy-counter joules;
* ``--profile default`` uses the RK3566-class fallback constants.

``--smoke`` is the CI parameterization: a small pack (150 mAh) so 128
devices traverse UNCONSTRAINED -> THROTTLED -> CRITICAL and die inside a
2 h horizon, with the acceptance checks (>= 100 devices, all three
power states seen, positive fleet J/token, deaths recorded) enforced.

    PYTHONPATH=src python -m repro_torch.launch.fleet_sim --smoke
    PYTHONPATH=src python -m repro_torch.launch.fleet_sim --devices 512 \\
        --hours 12
    PYTHONPATH=src python -m repro_torch.launch.fleet_sim \\
        --profile ledger --ledger run_ledger.json

Everything here is host arithmetic: no tensor is made and no card is
needed.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

# fig8's event shape: SigLip-so400m patches per frame, a short prompt,
# a short voice answer
VISION_TOKENS = 729
SIGLIP_PARAMS = 400e6
PREFILL_TOKENS = 64
SMOKE = dict(devices=128, hours=2.0, dt=10.0, battery_mah=150.0)


def _paper_pipeline(arch: str = "llava-onevision-0.5b"):
    """The full edge pipeline with a real vision-encoder brick swapped in
    for the stub frontend and analytic ``param_bytes`` filled (fig8's
    idiom), so the modeled ledger prices what the paper deploys."""
    from repro_torch.configs import get_config
    from repro_torch.core.bricks import Brick, Port, decompose

    g = decompose(get_config(arch))
    enc = Brick("vision_encoder", "encoder", (),
                lambda p, c, ctx: ctx["vision_feats"],
                in_ports=(Port("vision_feats"),), out_port=Port("patches"),
                static_shape=True, quant_label="fp16",
                flops_per_token=2 * SIGLIP_PARAMS,
                param_bytes=int(SIGLIP_PARAMS * 2))
    g.bricks = [enc if b.name == "vision_frontend" else b for b in g.bricks]
    g.bricks = [b if b.param_bytes else dataclasses.replace(
        b, param_bytes=int(b.flops_per_token / 2 * 0.56))
        for b in g.bricks]
    return g


def modeled_profile():
    """ModalityProfile from the cost model: the scheduler's
    energy-objective placement priced per phase via ``Ledger.modeled``.
    Returns ``(profile, ledger)``."""
    from repro_torch.core.scheduler import edge_accelerators, schedule
    from repro_torch.telemetry.fleet import ModalityProfile
    from repro_torch.telemetry.ledger import Ledger

    g = _paper_pipeline()
    accels = edge_accelerators()
    by_name = {a.name: a for a in accels}
    pl = schedule(g, accels, n_tokens=PREFILL_TOKENS, objective="energy")
    accel_for = {b: by_name[a] for b, a in pl.assignment.items()}
    led = Ledger.modeled(g, accel_for, phase_tokens={
        "stage": VISION_TOKENS, "prefill": PREFILL_TOKENS, "decode": 1})
    return ModalityProfile.from_ledger(led), led


def main(argv=None) -> int:
    from repro_torch.core.power import PowerState
    from repro_torch.telemetry.fleet import FleetSimulator, ModalityProfile

    ap = argparse.ArgumentParser(
        description="fleet-scale battery simulation over the telemetry "
                    "ledger's per-modality energy profile")
    ap.add_argument("--devices", type=int, default=256)
    ap.add_argument("--hours", type=float, default=12.0)
    ap.add_argument("--dt", type=float, default=30.0,
                    help="simulated seconds per tick")
    ap.add_argument("--battery-mah", type=float, default=2000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", choices=("modeled", "ledger", "default"),
                    default="modeled")
    ap.add_argument("--ledger", default=None,
                    help="telemetry ledger JSON to characterize from "
                         "(with --profile ledger)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"CI mode: {SMOKE['devices']} devices on a "
                         f"{SMOKE['battery_mah']:.0f} mAh pack so all "
                         f"three power states and device death happen "
                         f"inside a {SMOKE['hours']:.0f} h horizon; "
                         f"enforces the acceptance checks")
    args = ap.parse_args(argv)
    if args.smoke:
        args.devices = max(args.devices, SMOKE["devices"])
        args.hours, args.dt = SMOKE["hours"], SMOKE["dt"]
        args.battery_mah = SMOKE["battery_mah"]

    if args.profile == "modeled":
        profile, _ = modeled_profile()
    elif args.profile == "ledger":
        if not args.ledger:
            ap.error("--profile ledger needs --ledger FILE")
        from repro_torch.telemetry.ledger import Ledger
        profile = ModalityProfile.from_ledger(Ledger.load(args.ledger))
    else:
        profile = ModalityProfile.default_edge()
    print(f"profile ({args.profile}): "
          f"J/token={dict(profile.j_per_token)} "
          f"tokens/s={dict(profile.tokens_per_s)}")

    sim = FleetSimulator(args.devices, profile, seed=args.seed,
                         battery_mah=args.battery_mah, dt_s=args.dt)
    rep = sim.run(args.hours)
    print(rep.summary())

    if args.smoke:
        all_states = {s.value for s in PowerState}
        if rep.n_devices < 100:
            raise SystemExit(f"fleet smoke: {rep.n_devices} devices < 100")
        if rep.states_seen != all_states:
            raise SystemExit(
                f"fleet never traversed all power states: saw "
                f"{sorted(rep.states_seen)}, want {sorted(all_states)}")
        if not rep.j_per_token > 0:
            raise SystemExit("fleet smoke: no energy accounted")
        if not rep.dead > 0:
            raise SystemExit("fleet smoke: no device exhausted its pack")
        print(f"OK: fleet smoke passed ({rep.n_devices} devices, "
              f"{sorted(rep.states_seen)}, {rep.dead} dead, "
              f"p50 {rep.survival_hours_p50:.2f} h)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
