"""``chip_smoke.stage_all`` on the CPU: a serve whose requests are all
staged before the engine's first step admits them together.

``chip_smoke.py``'s phase 3 serves four LLaVA requests (two slot
classes, one request sharing another's image) and phase 3c holds the
disaggregated fleets' tokens against that serve, which must decode at
the one cohort bucket of its four slots.  The engine admits only staged
requests, and staging runs on its own threads, so without the wait the
buckets follow the threads' timing.  Here reduced LLaVA with async
staging, each staging call slowed by a random 0-30 ms, serves phase 3's
pattern of requests 20 times, each with ``stage_all`` before its first
step: every serve decodes at bucket 4 only, and prefills all four
requests in its first step.
"""
import importlib.util
import os
import random
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.model import init_params
from repro_torch.serving.engine import ServingEngine

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SPECS = [(8, 1, None), (2, 1, None), (8, 1, 0), (2, 1, None)]
REPEATS = 20


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage_all_admits_phase3_requests_together():
    cs = _chip_smoke()
    cfg = get_config("llava-onevision-0.5b").reduced()
    with torch.no_grad():
        params = init_params(cfg, device="cpu", seed=0)
    rng = random.Random(0)
    for rep in range(REPEATS):
        reqs = cs.requests(cfg, SPECS, seed=rep)
        for r in reqs:
            r.max_new_tokens = 4
        eng = ServingEngine(cfg, params, n_slots=cs.N_SLOTS, max_len=128,
                            block_size=32, device="cpu")
        assert eng.async_staging
        produce = eng.plan.produce_many

        def slow(*a, **k):
            time.sleep(rng.uniform(0.0, 0.03))
            return produce(*a, **k)
        eng.plan.produce_many = slow
        with eng:
            for r in reqs:
                eng.submit(r)
            cs.stage_all(eng)
            done = eng.run()
        assert len(done) == len(reqs)
        assert all(r.error is None for r in done)
        buckets = sorted({eng._cohort_bucket(e.rid) for e in eng.trace
                          if e.event == "decode_cohort"})
        assert buckets == [cs.N_SLOTS], (rep, buckets)
        first = [e.event for e in eng.trace
                 if e.event in ("prefill", "decode_step")][:len(reqs)]
        assert first == ["prefill"] * len(reqs), (rep, first)
