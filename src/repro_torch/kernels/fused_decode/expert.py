"""Launcher of the routed experts' GEMV (``csrc/expert_gemv.cu``).

The MoE's decode (``models/moe._decode_moe``, through
``ops.fused_mlp_experts``): each valid cohort row's gated sum over its
top-k experts of the expert MLP, read from the packed stacked expert
weights in place, two device kernels a call (``expert_up_kernel``, then
``expert_down_kernel``).  ``expert_plan`` (pure Python, tested on the CPU
at every served width) sets each stage's grid: column tiles x routed
slots x K splits; the kernel checks it.  The library is its own
(``expert_gemv``), built on first use (``kernels/build.py``); nothing here
runs on the CPU, where ``ops.py`` takes the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels.build import load_library
from repro_torch.kernels.fused_decode.kernel import (
    ACTS, CTAS_AN_SM, DTYPES, SMS, _activation_dtype, _check,
    _counters, _int_array, _ptr_array, _require_cuda, _rows, _stream)

LIBRARY = "expert_gemv"
SOURCES = ("expert_gemv.cu",)
EXPERT_MAX_TOP_K = 8    # choices a row (kMaxPairs / kMaxRows)
EXPERT_THREADS = 128    # a CTA (kThreads)
EXPERT_RING = 16        # cp.async ring stages (kRing)
EXPERT_MAX_KC = 1024    # K rows a CTA (kMaxKc)
EXPERT_MAX_R = 4        # an expert's rows a pass (kMaxR)
EXPERT_MIN_ROWS = 48    # K rows each thread walks at the least
# device kernels a call: expert_up_kernel, expert_down_kernel
EXPERT_KERNELS = ("expert_up_kernel", "expert_down_kernel")

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    if not getattr(lib, "_typed", False):
        lib.rt_fused_mlp_experts.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
            _P, _P, _P, _P, _P, _P, _P, _I, _P]
        lib.rt_fused_mlp_experts.restype = _I
        lib._typed = True
    return lib


@dataclass(frozen=True)
class ExpertPlan:
    """How one stage of the routed experts' GEMV covers its work: a (rows,
    K) x (K, nseg * n) product per routed expert (nseg 2: up beside gate).

    ``vec`` outputs a 16-byte vector (one thread's column); ``slots``
    routed-expert slots of the grid (min(bc k, E): the most experts the
    cohort can route, CTAs of a slot past the routed count exit before
    any load); ``ts`` vector columns a CTA (``ts // nseg`` of each
    segment) and ``nsub`` K sub-rows; ``tiles`` CTAs along the outputs;
    ``k_chunk`` K rows a CTA and ``k_split`` CTAs along K, their sums
    added in split order by the last to arrive; ``scales`` scale loads
    a vector (1, or one a word where a group is narrower than a
    vector); ``smem`` dynamic shared-memory bytes a CTA."""
    vec: int
    nseg: int
    slots: int
    ts: int
    nsub: int
    tiles: int
    k_chunk: int
    k_split: int
    scales: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.slots * self.k_split

    def args(self) -> Tuple[int, int, int]:
        """The entry point's plan: {ts, kc, ks}."""
        return (self.ts, self.k_chunk, self.k_split)


def _smem(vec: int, ts: int, kc: int, scales: int) -> int:
    """``ExpSmem``'s total: the ring of vectors (after the K loop, the
    partial tile) and scales, and the activations (after the K loop, the
    sub-row reduction)."""
    nsub = EXPERT_THREADS // ts
    kcp = -(-kc // nsub) * nsub
    hs = max(EXPERT_MAX_R * kcp * 4, EXPERT_THREADS * (vec + 4) * 4)
    return EXPERT_RING * EXPERT_THREADS * (16 + 4 * scales) + -(-hs // 16) * 16


@functools.lru_cache(maxsize=512)
def expert_plan(bc: int, k: int, E: int, K: int, N: int, nseg: int,
                bits: int, elem_bytes: int, group: int = 0) -> ExpertPlan:
    """The plan of one stage (pure Python; the kernel checks it), from
    ``scripts/expert_gemv_bench.py --sweep`` at the three served widths:
    the up stage (nseg 2) in CTAs of 32 vector columns; the down stage in
    CTAs of 8 (more column tiles: each one's gated sum is read by one
    CTA) where its CTAs fit one wave, else of 16.  K is split so that
    the experts a cohort routes on average, E (1 - (1 - 1/E)^(bc k)) of
    the min(bc k, E) slots, put one wave of CTAS_AN_SM CTAs an SM on the
    card, each thread walking at least EXPERT_MIN_ROWS K rows and a CTA
    at most EXPERT_MAX_KC (the sweep's fastest split where the CTAs run
    in waves: the fewest)."""
    vec = 128 // bits if bits else 16 // elem_bytes
    if N % vec:
        raise ValueError(f"expert_plan: {N} outputs are not whole "
                         f"{vec}-output vectors")
    nvec = N // vec
    slots = min(bc * k, E)
    routed = E * (1.0 - (1.0 - 1.0 / E) ** (bc * k))
    scales = 0 if not bits else (1 if group % vec == 0 else 4)

    def split(ts):
        tiles = -(-nvec // (ts // nseg))
        nsub = EXPERT_THREADS // ts
        least = -(-K // EXPERT_MAX_KC)
        most = max(1, K // (nsub * EXPERT_MIN_ROWS))
        fit = max(1, int(CTAS_AN_SM * SMS // (routed * tiles)))
        return tiles, max(least, min(fit, most)), fit >= least
    ts = 32 if nseg == 2 else (8 if split(8)[2] else 16)
    tiles, ks = split(ts)[:2]
    kc = -(-K // ks)
    return ExpertPlan(vec=vec, nseg=nseg, slots=slots, ts=ts,
                      nsub=EXPERT_THREADS // ts, tiles=tiles, k_chunk=kc,
                      k_split=ks, scales=scales,
                      smem=_smem(vec, ts, kc, max(1, scales)))


def expert_plans(bc: int, k: int, E: int, D: int, F: int, gated: bool,
                 bits: Tuple[int, int], elem_bytes: int,
                 groups: Tuple[int, int] = (0, 0)
                 ) -> Tuple[ExpertPlan, ExpertPlan]:
    """The plans of the two stages: (rows, D) x (D, [up | gate]) with the
    activation into mid, then (rows, F) x (F, D) with the gated sum;
    ``bits`` and ``groups`` of up and down."""
    return (expert_plan(bc, k, E, D, F, 2 if gated else 1, bits[0],
                        elem_bytes, groups[0]),
            expert_plan(bc, k, E, F, D, 1, bits[1], elem_bytes, groups[1]))


def scratch_floats(plans: Tuple[ExpertPlan, ExpertPlan], pairs: int, D: int,
                   F: int) -> Tuple[int, int, int, int]:
    """fp32 scratch of a call of ``pairs`` (row, choice) pairs: y (pairs,
    D), each stage's split partials (one float where a stage has one
    split), and the arrival counters (max of the up stage's slots x
    tiles and the down stage's slots x tiles + tiles)."""
    p1, p2 = plans
    part1 = p1.k_split * pairs * p1.nseg * F if p1.k_split > 1 else 1
    part2 = p2.k_split * pairs * D if p2.k_split > 1 else 1
    counters = max(p1.slots * p1.tiles, p2.slots * p2.tiles + p2.tiles)
    return pairs * D, part1, part2, counters


class _ExpertWeight:
    """One stacked expert weight (E, K, N) as the routed experts' GEMV
    reads it in place: packed q4 / q8 codes along N with fp32 scales, or
    dense in the activations' dtype, contiguous (no copy is made: a
    full-width Jamba leaf is 3.2 G elements)."""

    def __init__(self, w, E: int, K: int, dtype: torch.dtype, name: str):
        if isinstance(w, QTensor):
            if w.padded or w.shape[-1] % w.spec.group_size:
                raise ValueError(f"{name}: padded packed weight {w.shape}")
            if w.spec.bits not in (4, 8) or w.spec.group_size % 8:
                raise ValueError(f"{name}: the experts' GEMV takes q4 or q8 "
                                 f"codes with groups of a multiple of 8, "
                                 f"got {w.spec}")
            ts = (w.codes, w.scales)
            if (w.codes.dtype != torch.int32
                    or w.scales.dtype != torch.float32):
                raise ValueError(f"{name}: codes must be int32 and scales "
                                 f"float32")
            self.bits, self.group = w.spec.bits, w.spec.group_size
        else:
            ts = (w,)
            self.bits, self.group = 0, 1
        _require_cuda(*ts)
        if tuple(w.shape[:2]) != (E, K) or len(w.shape) != 3:
            raise ValueError(f"{name}: expert weight {tuple(w.shape)} is not "
                             f"({E}, {K}, N)")
        if w.dtype != dtype:
            raise ValueError(f"{name}: weight dtype {w.dtype} != activation "
                             f"dtype {dtype}")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError(f"{name}: expert weight must be contiguous")
        self.n = int(w.shape[2])
        vec = 128 // (self.bits or torch.finfo(dtype).bits)
        if self.n % vec:
            raise ValueError(f"{name}: {self.n} outputs, not whole "
                             f"{vec}-output vectors")
        self.ptrs = (ts[0].data_ptr(), ts[1].data_ptr() if len(ts) > 1 else 0)


def launch_fused_mlp_experts(h, w_up, w_down, w_gate, idx, gates, valid,
                             act: str):
    """h (bc, D) -> (bc, D) on the card: each valid row's gated sum over
    its top-k experts ``idx`` (bc, k) of the expert MLP, reading only the
    routed experts' codes (two device kernels a call, ``expert_plans``);
    ``act`` is the activation of the gate (gated) or of up.  Rows go in
    launches of at most MAX_ROWS.  Returns (out, launches)."""
    dtype = _activation_dtype(h, "fused_mlp_experts")
    if act not in ACTS:
        raise ValueError(f"fused_mlp_experts: unsupported activation {act!r}")
    _require_cuda(h, idx, gates, valid)
    bc, D = h.shape
    k = int(idx.shape[1])
    E = int(w_up.shape[0])
    if k > EXPERT_MAX_TOP_K:
        raise ValueError(f"fused_mlp_experts: top-{k} is more than "
                         f"{EXPERT_MAX_TOP_K} choices")
    up = _ExpertWeight(w_up, E, D, dtype, "w_up")
    F = up.n
    gated = w_gate is not None
    gate = _ExpertWeight(w_gate, E, D, dtype, "w_gate") if gated else up
    if gate.n != F or (gate.bits, gate.group) != (up.bits, up.group):
        raise ValueError("fused_mlp_experts: w_gate and w_up differ")
    down = _ExpertWeight(w_down, E, F, dtype, "w_down")
    if down.n != D:
        raise ValueError(f"fused_mlp_experts: w_down gives {down.n} "
                         f"outputs, expected {D}")
    ws = (up, gate, down)
    x = h.contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    g32 = gates.to(torch.float32).contiguous()
    ok = valid.to(torch.int32).contiguous()
    out = torch.empty((bc, D), dtype=dtype, device=h.device)
    lib = library()
    launches = 0
    for r0, r1 in _rows(x):
        rows = r1 - r0
        P = rows * k
        plans = expert_plans(rows, k, E, D, F, gated, (up.bits, down.bits),
                             h.element_size(), (up.group, down.group))
        n_y, n_p1, n_p2, n_ctr = scratch_floats(plans, P, D, F)
        mid = torch.empty((P, F), dtype=dtype, device=h.device)
        y = torch.empty(n_y, dtype=torch.float32, device=h.device)
        s1 = torch.empty(n_p1, dtype=torch.float32, device=h.device)
        s2 = torch.empty(n_p2, dtype=torch.float32, device=h.device)
        counters = _counters(h.device, n_ctr)
        err = lib.rt_fused_mlp_experts(
            x[r0:r1].data_ptr(), idx32[r0:r1].data_ptr(),
            g32[r0:r1].data_ptr(), ok[r0:r1].data_ptr(), rows, k, E, D, F,
            int(gated), ACTS[act], _ptr_array([w.ptrs[0] for w in ws]),
            _ptr_array([w.ptrs[1] for w in ws]),
            _int_array([w.bits for w in ws]),
            _int_array([w.group for w in ws]), mid.data_ptr(), y.data_ptr(),
            out[r0:r1].data_ptr(), s1.data_ptr(), s2.data_ptr(),
            counters.data_ptr(), _int_array(plans[0].args()),
            _int_array(plans[1].args()), DTYPES[dtype], _stream())
        _check(err, "fused_mlp_experts")
        launches += 1
    return out, launches
