"""Disaggregated two-fleet serving of LLaVA-OneVision-0.5B: prefill fleet
-> Transport -> decode fleet, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve_disagg \\
        --transport {inproc,pipe,socket} --requests 4 [--full]

A :class:`~repro_torch.serving.disagg.PrefillWorker` stages, projects
and prefills each request and streams it (committed TABM slab, the
written KV blocks and the block grant, never a whole ``max_len`` lane)
over a serialized transport to a
:class:`~repro_torch.serving.disagg.DecodeWorker`, which admits it into
its own paged pool and cohort-decodes.  ``--transport pipe`` and
``socket`` spawn the decode fleet as a subprocess (``--role decode``
plus the fd or port plumbing below), which makes its own weights from
the same seed: only frames cross the boundary.  ``inproc`` runs the
decode fleet on a thread of this process, on the prefill fleet's
weights.

``--full`` serves the full-size config (24 layers, d 896, 729- and
196-token images, ``max_len`` 2048, blocks of 64) with ``nanomind-serve``
weights; by default the reduced config (``max_len`` 256, blocks of 32),
also packed by ``nanomind-serve``.

Every run asserts:

* over ``pipe`` and ``socket``, both fleets hold the same weights: each
  process prints a digest of its packed weights (``params_digest``, a
  CRC over every leaf's bytes) and the two must be equal;
* greedy decode tokens are bit-identical to a single-process
  ``ServingEngine`` oracle, per request, across >= 2 slot classes;
* the paged KV bytes that crossed the wire are fewer than whole
  ``max_len`` lanes (``PagedKVCache.slot_lane_bytes``) would be.

Before serving, the launcher prints the scheduler's split pricing for
the chosen wire (``[schedule_split @ <transport>] <Placement>``: the
chain DP over the prefill and decode fleet rows, each cross-fleet edge
priced at the transport's ``link_bw``; modeled, from the reference's
profiles).  After serving it prints the split repriced from what the
frames clocked (``[schedule_split recalibrated @ <MB/s> MB/s measured]
<Placement>``: the wire's bytes over its send seconds folded into a
fresh ``CostCalibration`` by ``observe_link``, blended over the class
row's ``link_bw``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.bricks import decompose
from repro_torch.core.quantize import PROFILES, QTensor, quantize_tree
from repro_torch.core.scheduler import populate_brick_bytes, schedule_split
from repro_torch.core.transport import PipeTransport, SocketTransport
from repro_torch.models.model import init_params
from repro_torch.serving.disagg import (DecodeWorker, PrefillWorker,
                                        serve_disagg_inproc)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.telemetry.calibration import CostCalibration

ARCH = "llava-onevision-0.5b"
SEED = 0
ENGINE_KW = {"reduced": dict(n_slots=4, max_len=256, block_size=32),
             "full": dict(n_slots=4, max_len=2048, block_size=64)}


def load_params(cfg, device):
    """The served weights: ``init_params`` from SEED on ``device``, packed
    by ``nanomind-serve``.  Each fleet calls this for itself."""
    with torch.no_grad():
        return quantize_tree(init_params(cfg, device=device, seed=SEED),
                             PROFILES["nanomind-serve"])


def params_digest(params) -> str:
    """CRC32 over every leaf of a parameter tree (a packed weight's codes
    and scales), each leaf's dtype and shape and then its bytes, dict
    keys in sorted order: equal digests mean equal weights."""
    crc = 0

    def walk(t):
        nonlocal crc
        if isinstance(t, QTensor):
            walk(t.codes)
            walk(t.scales)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            crc = zlib.crc32(f"{t.dtype}{tuple(t.shape)}".encode(), crc)
            flat = t.detach().contiguous().reshape(-1)
            if flat.numel():
                crc = zlib.crc32(flat.view(torch.uint8).cpu().numpy(), crc)
    walk(params)
    return f"{crc & 0xFFFFFFFF:08x}"


def make_requests(cfg, n: int, max_new: int):
    """>= 2 slot classes: thumbnails (the smallest resolution bucket) and
    full-resolution images alternating, each prompt one placeholder
    token per vision token and then 6-8 text tokens."""
    thumb = min(cfg.vision_token_buckets or (cfg.vision_tokens,))
    reqs = []
    for i in range(n):
        rng = np.random.default_rng(i)
        n_vis = cfg.vision_tokens if i % 2 else thumb
        text = (np.arange(6 + i % 3) % 50 + 3).astype(np.int32)
        reqs.append(Request(
            rid=i, tokens=np.concatenate([np.zeros(n_vis, np.int32), text]),
            n_images=1, max_new_tokens=max_new + i % 2,
            vision_feats=(rng.standard_normal((1, n_vis, cfg.vision_feat_dim))
                          * 0.02).astype(np.float32)))
    return reqs


def oracle_tokens(cfg, params, reqs, engine_kw, device):
    """The single-process baseline: the same engine geometry and staging
    as the prefill fleet, no wire."""
    with ServingEngine(cfg, params, async_staging=False, device=device,
                       **engine_kw) as eng:
        for r in reqs:
            eng.submit(r)
        done = eng.run()
    bad = [(r.rid, r.error) for r in done if r.error is not None]
    if bad or len(done) != len(reqs):
        raise RuntimeError(f"oracle requests failed: {bad}")
    return {r.rid: list(r.out_tokens) for r in done}


def _config(args):
    cfg = get_config(ARCH)
    return (cfg, ENGINE_KW["full"]) if args.full else \
        (cfg.reduced(), ENGINE_KW["reduced"])


def run_decode_fleet(args):
    """The decode-fleet subprocess (``--role decode``): its own weights
    from SEED; only frames cross the wire."""
    cfg, engine_kw = _config(args)
    params = load_params(cfg, args.device)
    digest = params_digest(params)
    if args.transport == "pipe":
        tr = PipeTransport(args.recv_fd, args.send_fd)
    elif args.transport == "socket":
        tr = SocketTransport.connect("127.0.0.1", args.port)
    else:
        raise SystemExit("--role decode needs --transport pipe|socket")
    worker = DecodeWorker(cfg, params, tr, device=args.device, **engine_kw)
    try:
        results = worker.run()
    finally:
        worker.engine.shutdown()
        tr.close()
    ok = sum(1 for r in results.values() if r.error is None)
    g = worker.engine.graph_stats
    print(f"[decode-fleet] served {ok}/{len(results)} requests, "
          f"{worker.engine.stats.decoded_tokens} decode tokens, "
          f"graph captures {g['captures']} replays {g['replays']}")
    print(f"[decode-fleet] weights digest {digest}", flush=True)


def _child_digest(out: str) -> str:
    for line in out.splitlines():
        if line.startswith("[decode-fleet] weights digest "):
            return line.split()[-1]
    raise RuntimeError("the decode fleet printed no weights digest")


def recalibrated_split(graph, transport, stats, n_tokens: int):
    """The split repriced from the wire's measured bandwidth: ``stats``
    (a ``PrefillStats``) folded into a fresh table by ``observe_link``.
    Returns ``(measured bytes/s, Placement)``, or None when nothing was
    clocked."""
    if not (stats.wire_seconds > 0 and stats.wire_bytes > 0):
        return None
    cal = CostCalibration()
    cal.observe_link(stats.transport, stats.wire_bytes, stats.wire_seconds,
                     n=max(1, stats.sent))
    return (stats.wire_bytes / stats.wire_seconds,
            schedule_split(graph, transport, n_tokens=n_tokens,
                           calibration=cal))


def recalibrated_line(bw: float, placement) -> str:
    return (f"[schedule_split recalibrated @ {bw / 1e6:.0f} MB/s "
            f"measured] {placement}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "pipe", "socket"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device of both fleets (default: the card)")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: reduced)")
    # decode-fleet subprocess plumbing (not for direct use)
    ap.add_argument("--role", default="prefill",
                    choices=["prefill", "decode"], help=argparse.SUPPRESS)
    ap.add_argument("--recv-fd", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--send-fd", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.role == "decode":
        run_decode_fleet(args)
        return 0
    if args.requests < 3:
        raise SystemExit("--requests must be >= 3")
    cfg, engine_kw = _config(args)
    params = load_params(cfg, args.device)
    digest = params_digest(params)
    print(f"[prefill-fleet] weights digest {digest}")

    # the scheduler's split pricing for this wire: the chain DP over the
    # two fleet rows priced at the transport's link_bw
    graph = decompose(cfg)
    populate_brick_bytes(graph, params)
    split = schedule_split(graph, args.transport,
                           n_tokens=cfg.vision_tokens)
    print(f"[schedule_split @ {args.transport}] {split}")

    oracle = oracle_tokens(cfg, params, make_requests(
        cfg, args.requests, args.max_new), engine_kw, args.device)
    reqs = make_requests(cfg, args.requests, args.max_new)
    fleet_kw = dict(device=args.device, **engine_kw)

    t0 = time.time()
    if args.transport == "inproc":
        results, stats = serve_disagg_inproc(
            cfg, params, reqs, prefill_kwargs=fleet_kw,
            decode_kwargs=fleet_kw)
    else:
        base_cmd = [sys.executable, "-m", "repro_torch.launch.serve_disagg",
                    "--role", "decode", "--transport", args.transport,
                    "--device", args.device] + (["--full"] if args.full
                                                else [])
        if args.transport == "pipe":
            a2b_r, a2b_w = os.pipe()
            b2a_r, b2a_w = os.pipe()
            child = subprocess.Popen(
                base_cmd + ["--recv-fd", str(a2b_r),
                            "--send-fd", str(b2a_w)],
                pass_fds=(a2b_r, b2a_w), stdout=subprocess.PIPE, text=True)
            os.close(a2b_r)
            os.close(b2a_w)
            tr = PipeTransport(b2a_r, a2b_w)
        else:
            srv, port = SocketTransport.listen()
            child = subprocess.Popen(base_cmd + ["--port", str(port)],
                                     stdout=subprocess.PIPE, text=True)
            try:
                tr = SocketTransport.accept(srv, timeout=300.0)
            finally:
                srv.close()
        pre = PrefillWorker(cfg, params, tr, **fleet_kw)
        try:
            for r in reqs:
                pre.submit(r)
            stats = pre.run()
            results = pre.collect(len(reqs))
            stats.wire_seconds = tr.send_seconds
            stats.transport = tr.name
        finally:
            pre.engine.shutdown()
            tr.close()
        out, _ = child.communicate(timeout=600)
        print(out, end="")
        if child.returncode != 0:
            raise RuntimeError(f"decode fleet exited {child.returncode}")
        child_digest = _child_digest(out)
        if child_digest != digest:
            raise RuntimeError(f"the fleets' weights differ: digest "
                               f"{digest} against the decode fleet's "
                               f"{child_digest}")
    wall = time.time() - t0

    # bit-identical greedy tokens, across >= 2 slot classes
    classes = {r.slot_class for r in reqs}
    if len(classes) < 2:
        raise RuntimeError(f"need >= 2 slot classes, got {classes}")
    for r in reqs:
        got = results.get(r.rid)
        if got is None or got.error is not None:
            raise RuntimeError(f"request {r.rid} failed: "
                               f"{got and got.error}")
        if got.tokens != oracle[r.rid]:
            raise RuntimeError(
                f"request {r.rid} tokens diverged over {args.transport}: "
                f"{got.tokens} != oracle {oracle[r.rid]}")
    # only the written blocks crossed, never whole lanes
    lane_total = stats.sent * stats.lane_bytes_baseline
    if not stats.kv_wire_bytes < lane_total:
        raise RuntimeError(
            f"wire shipped {stats.kv_wire_bytes}B of KV, whole lanes would "
            f"be {lane_total}B: paged export is not saving bytes")
    print(f"[prefill-fleet] {stats.sent} prefills shipped, "
          f"{stats.wire_bytes}B on the wire in {stats.wire_seconds:.4f}s "
          f"({stats.kv_wire_bytes}B paged KV vs {lane_total}B whole-lane "
          f"baseline), {len(classes)} slot classes, {wall:.1f}s")
    # feedback edge: reprice the split from what the frames clocked
    split2 = recalibrated_split(graph, args.transport, stats,
                                cfg.vision_tokens)
    if split2 is not None:
        print(recalibrated_line(*split2))
    print(f"OK: disaggregated prefill/decode fleets over {args.transport}: "
          f"{len(reqs)} requests bit-identical to the single-process "
          f"oracle, weights digest {digest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
