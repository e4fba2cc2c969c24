"""The port's TABM ring and slot classes: the same class table and
battery-scaled admission as the reference, and the thread-safe ring
under concurrent producers and consumers (more threads than cores, a
short switch interval)."""
import os
import sys
import threading

import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.core.scheduler import kv_block_budgets as ref_kv_budgets
from repro.core.tabm import SlotClassPool as RefPool
from repro_torch.configs import get_config
from repro_torch.core.scheduler import kv_block_budgets
from repro_torch.core.tabm import EMPTY, RingBuffer, SlotClassPool

ARCH = "llava-onevision-0.5b"


def test_class_table_and_budgets_match_reference():
    for reduced in (True, False):
        rcfg, tcfg = ref_config(ARCH), get_config(ARCH)
        if reduced:
            rcfg, tcfg = rcfg.reduced(), tcfg.reduced()
        ref = RefPool.from_config(rcfg, slots_per_class=3)
        port = SlotClassPool.from_config(tcfg, slots_per_class=3,
                                         device="cpu")
        assert list(port.classes) == list(ref.classes)
        for n_tok, n_img in ((2, 1), (8, 1), (20, 4), (196, 1), (729, 1),
                             (2916, 4)):
            if n_tok <= max(c.max_tokens for c in ref.classes.values()):
                assert port.classify(n_tok, n_img) == \
                    ref.classify(n_tok, n_img)
        for scale in (1.0, 0.6, 0.3, 0.0):
            want = {k: v[1] for k, v in ref.admission_table(scale).items()}
            got = {k: v[1] for k, v in port.admission_table(scale).items()}
            assert got == want
            used = {name: i for i, name in enumerate(port.classes)}
            assert kv_block_budgets(port, 64, used, scale) == \
                ref_kv_budgets(ref, 64, used, scale)


def test_ring_stress_fifo_and_conservation():
    """Producer/consumer pairs on separate rings, with slab commits of 1-3
    slots: every consumer sees its producer's payloads in FIFO order,
    writes == reads, and every ring ends EMPTY."""
    pairs = max(5, (os.cpu_count() or 1) // 2 + 1)     # > cores threads
    n_items, dim = 60, 4
    rings = [RingBuffer(n_slots=4, max_tokens=3, dim=dim, dtype="float32",
                        device="cpu") for _ in range(pairs)]
    seen = [[] for _ in range(pairs)]
    errors = []

    def produce(r, ring):
        rng = np.random.default_rng(r)
        i = 0
        while i < n_items:
            k = int(min(rng.integers(1, 4), n_items - i))
            slots = ring.acquire_write_many(k, block=True, timeout=10)
            if slots is None:
                errors.append(f"ring {r}: producer timed out")
                return
            vals = torch.arange(i, i + k, dtype=torch.float32)
            ring.commit_many(slots, vals[:, None, None].expand(k, 2, dim),
                             [2] * k)
            i += k

    def consume(r, ring):
        for _ in range(n_items):
            got = ring.acquire_read(block=True, timeout=10)
            if got is None:
                errors.append(f"ring {r}: consumer timed out")
                return
            slot, view, n = got
            seen[r].append(float(view[0, 0]))
            if n != 2 or float(view[2:].abs().sum()) != 0.0:
                errors.append(f"ring {r}: bad slot length/tail")
            ring.release(slot)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=f, args=(r, ring))
                   for r, ring in enumerate(rings)
                   for f in (produce, consume)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for r, ring in enumerate(rings):
        assert seen[r] == [float(i) for i in range(n_items)]
        assert ring.stats["writes"] == ring.stats["reads"] == n_items
        assert all(s == EMPTY for s in ring.states)
