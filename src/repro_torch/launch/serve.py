"""Serving launcher of the port: continuous-batching engine + battery
policy, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llava-onevision-0.5b --requests 16 --battery 0.9 \\
        --quantize nanomind-serve --full

Qwen2-VL-7B's prompts carry its 1024 vision tokens, so they need the
2048 prefill bucket, and the engine's buckets stop below ``--max-len``:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-vl-7b --requests 4 --quantize nanomind-serve \\
        --full --max-len 4096

DeepSeek-MoE-16B serves at full width and depth on one card (its
experts packed one stacked leaf at a time as ``init_params`` makes them,
10.8 GB under ``nanomind-serve``):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --requests 4 --quantize nanomind-serve \
        --full --max-len 2048

Submits synthetic prompts (with stub vision features for vlm archs; a
vision request's prompt carries one placeholder token per vision token,
then its text), runs the engine to completion and prints tokens/s,
end-to-end latency and memory.  ``--quantize`` keeps the weights packed,
so on the card decode reads them through the fused kernels
(``nanomind-sparse`` prunes half of each decoder row first).

``--calibration PATH`` persists the measured cost table across restarts:
the file, when it exists, is loaded and handed to the engine (its
decoder row's joules, if any, price the KV energy pressure); after the
run the run's measured table is folded into it and saved again:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 3 --max-new 4 --calibration /tmp/cal.json
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.core.power import BatteryAwareExecutor, PMU
from repro_torch.core.quantize import PROFILES
from repro_torch.models.model import init_params
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.telemetry.calibration import CostCalibration


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llava-onevision-0.5b",
                    choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--battery", type=float, default=1.0)
    ap.add_argument("--quantize", default=None,
                    choices=[None, "nanomind-default", "nanomind-serve",
                             "nanomind-sparse", "all-q4", "dec-q2"])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="persist the measured cost table across "
                         "restarts: load PATH if it exists, feed it to "
                         "the engine's energy governor, and save the "
                         "folded table again after the run")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.encdec:
        raise SystemExit("serve: decoder-only archs (the encoder-decoder "
                         "runs through launch/steps.py and the bricks)")
    if not args.full:
        cfg = cfg.reduced()
    # a policy packs each stacked expert leaf as it is made
    params = init_params(cfg, device=args.device, seed=args.seed,
                         policy=PROFILES[args.quantize] if args.quantize
                         else None)

    executor = BatteryAwareExecutor(PMU())
    executor.pmu.level = args.battery
    calibration = None
    if args.calibration and os.path.exists(args.calibration):
        calibration = CostCalibration.load(args.calibration)
        print(f"[serve] loaded calibration from {args.calibration} "
              f"({len(calibration)} entries)")
    eng = ServingEngine(cfg, params, n_slots=args.slots,
                        max_len=args.max_len, executor=executor,
                        calibration=calibration, device=args.device)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        n = int(rng.integers(8, 64))
        req = Request(rid=i, tokens=rng.integers(
            3, cfg.vocab_size - 1, n).astype(np.int32),
            max_new_tokens=args.max_new)
        if cfg.vlm:
            req.vision_feats = (rng.standard_normal(
                (1, cfg.vision_tokens, cfg.vision_feat_dim)) * 0.02
            ).astype(np.float32)
            req.tokens = np.concatenate(
                [np.zeros(cfg.vision_tokens, np.int32), req.tokens])
        eng.submit(req)

    t0 = time.time()
    with eng:
        done = eng.run()
    wall = time.time() - t0
    lat = [r.e2e_latency for r in done if r.e2e_latency]
    mem = eng.memory_bytes()
    state, knobs, objective = executor.current()
    errors = [r for r in done if r.error is not None]
    print(f"[serve] {args.arch} on {eng.device} battery={args.battery:.0%} "
          f"state={state.value} objective={objective}")
    print(f"  finished={len(done) - len(errors)}/{args.requests} "
          f"wall={wall:.1f}s "
          f"throughput={eng.stats.decoded_tokens / wall:.1f} tok/s")
    if lat:
        print(f"  e2e latency: mean={np.mean(lat):.2f}s p95="
              f"{np.percentile(lat, 95):.2f}s")
    print(f"  memory: weights={mem['weights'] / 1e6:.1f}MB "
          f"kv={mem['kv_pool'] / 1e6:.1f}MB tabm={mem['tabm'] / 1e6:.2f}MB")
    if eng.tabm is not None:
        print(f"  tabm ring: {eng.tabm.stats}")
    if args.calibration:
        # fold this run's measured table into the loaded one, so the file
        # converges across restarts (save is atomic: tmp + os.replace)
        table = eng.measured_calibration()
        measured = table.to_dict()["table"]
        print(f"  calibration: this run measured "
              f"{json.dumps({k: s['n'] for k, s in measured.items()})}")
        if calibration is not None:
            for key, s in measured.items():
                brick, _, prof = key.rpartition("@")
                calibration.observe(brick, prof or None, s["seconds"],
                                    s["tokens"], s["joules"], n=s["n"])
            table = calibration
        table.save(args.calibration)
        print(f"  calibration: saved {len(table)} entries to "
              f"{args.calibration}")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
