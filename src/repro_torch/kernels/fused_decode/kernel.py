"""Launchers of the Hopper fused-decode kernels (``csrc/fused_decode.cu``).

Each launcher takes CUDA tensors, checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches
on the current stream through the C entry point, and raises if the entry
returns a CUDA error.  The library is built on first use
(``kernels/build.py``).  These run on the card only; the CPU path is the
plain version in ``ref.py``, chosen by the wrappers in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels.build import load_library

LIBRARY = "fused_decode"
SOURCES = ("fused_decode.cu",)
MAX_ROWS = 8          # cohort rows per launch (kMaxRows)
ACTS = {"silu": 0, "gelu": 1, "relu": 2, "squared_relu": 3}
# the GEMV kernels' instances: activation dtype -> the entries' fp32 flag
DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    lib = load_library(LIBRARY, SOURCES)
    if not getattr(lib, "_typed", False):
        lib.rt_fused_qkv.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _I, _P]
        lib.rt_fused_mlp.argtypes = [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, _P, _P, _I, _I, _P]
        lib.rt_kv_row_scatter.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                          _I, _I, _P]
        for fn in (lib.rt_fused_qkv, lib.rt_fused_mlp, lib.rt_kv_row_scatter):
            fn.restype = _I
        lib._typed = True
    return lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr_array(ptrs: Sequence[int]):
    return (ctypes.c_void_p * len(ptrs))(*[p or None for p in ptrs])


def _int_array(vals: Sequence[int]):
    return (ctypes.c_int * len(vals))(*vals)


SMS = 132              # the H100's streaming multiprocessors
GEMV_THREADS = 128     # the GEMV's CTA (kGemvThreads)
MAX_CLUSTER = 8        # portable thread-block cluster size
MAX_K_CHUNK = 1024     # K rows a CTA (kMaxKChunk)
MIN_ROWS_A_THREAD = 8  # K rows each thread walks at the least
CTAS_AN_SM = 3         # the GEMV's occupancy (__launch_bounds__(128, 3))


@dataclass(frozen=True)
class GemvPlan:
    """How the split-K GEMV (``gemv_kernel``) covers one launch: a (bc, K)
    x (K, nseg * n) product whose segments are packed ``bits`` (or dense)
    weights of ``n`` outputs each (nseg 2: the MLP's up and gate), or
    (nseg 1) of weights side by side along ``n`` outputs (q | k | v).

    ``vec`` outputs a 16-byte vector (one thread's column); ``rows``
    cohort rows a pass (``passes`` of them); ``slots`` vector columns a
    CTA (``slots // nseg`` of each segment: up beside the matching gate
    columns); ``tiles`` CTAs along the outputs; ``k_chunk`` K rows a
    CTA and ``k_split`` CTAs along K, ``cluster`` of them a thread-block
    cluster (reduced over distributed shared memory) and ``clusters``
    clusters (each rank's slice of a tile reduced by the last of that
    rank's CTAs to arrive, through ``partial`` floats of scratch);
    ``counters`` arrival counters (one a tile and rank)."""
    vec: int
    rows: int
    passes: int
    slots: int
    tiles: int
    k_chunk: int
    k_split: int
    cluster: int
    clusters: int
    partial: int
    counters: int

    def args(self) -> Tuple[int, ...]:
        """The entry point's plan: {R, ts, kc, ck, nck}."""
        return (self.rows, self.slots, self.k_chunk, self.cluster,
                self.clusters)


def _plan(K: int, n: int, nseg: int, bits: int, elem_bytes: int, bc: int,
          slots: int, k_split: int, cluster: int) -> GemvPlan:
    """The plan of ``slots`` vector columns a CTA and ``k_split`` CTAs
    along K in clusters of ``cluster``."""
    vec = 128 // bits if bits else 16 // elem_bytes
    rows = min(4, 128 // vec, 1 << (bc - 1).bit_length())
    tiles = -(-(n // vec) // (slots // nseg))
    clusters = k_split // cluster
    return GemvPlan(vec=vec, rows=rows, passes=-(-bc // rows), slots=slots,
                    tiles=tiles, k_chunk=-(-K // k_split), k_split=k_split,
                    cluster=cluster, clusters=clusters,
                    partial=clusters * bc * nseg * n if clusters > 1 else 0,
                    counters=tiles * cluster)


def _slots(nvec: int, nseg: int) -> int:
    """Vector columns a CTA: 32, or 16 where that leaves fewer idle."""
    return min((32, 16), key=lambda ts: (-(-nvec // (ts // nseg)) * ts
                                         - nvec * nseg, -ts))


def gemv_plan(K: int, n: int, nseg: int, bits: int, elem_bytes: int,
              bc: int) -> GemvPlan:
    """The launch plan of one MLP GEMV stage (pure Python; the kernel
    checks it).  Vector columns a CTA: ``_slots``; CTAs along K: enough
    for one wave at CTAS_AN_SM CTAs an SM, each thread walking at least
    MIN_ROWS_A_THREAD rows and a CTA at most MAX_K_CHUNK; ``_cluster``
    sizes the cluster."""
    vec = 128 // bits if bits else 16 // elem_bytes
    nvec = n // vec
    slots = _slots(nvec, nseg)
    tiles = -(-nvec // (slots // nseg))
    nsub = GEMV_THREADS // slots
    fit = max(1, CTAS_AN_SM * SMS // tiles)
    least = -(-K // MAX_K_CHUNK)
    most = max(1, K // (nsub * MIN_ROWS_A_THREAD))
    ks = max(least, min(fit, most))
    if ks > MAX_CLUSTER and all(ks % c for c in range(2, MAX_CLUSTER + 1)):
        ks += 1 if ks - 1 < least else -1  # a prime split takes no cluster
    return _plan(K, n, nseg, bits, elem_bytes, bc, slots, ks,
                 _cluster(ks, bc, slots // nseg * vec))


GEMV_BATCH = 8         # items a thread reduces at once (kBatch)
MAX_ROUNDS = 8         # load rounds of a cross-cluster reduction


def _cluster(ks: int, bc: int, items: int) -> int:
    """The cluster size along K for a split of ``ks`` CTAs over column
    tiles of ``items`` items a row: the smallest of 2..MAX_CLUSTER that
    divides ``ks`` and leaves the last CTA of each slice at most
    MAX_ROUNDS rounds of loads (GEMV_BATCH items a thread, four clusters'
    sums a round), else the largest divisor up to MAX_CLUSTER.  Small
    clusters schedule better where many CTAs run (Qwen2-VL-7B's widths);
    one column tile with a long K (LLaVA-OneVision-0.5B's down
    projection) needs large ones, or the last CTAs' reduction dominates
    (``scripts/fused_mlp_plan_sweep.py``)."""
    def rounds(ck):
        per_thread = -(-bc * items // (ck * GEMV_THREADS))
        return -(-(ks // ck) // 4) * -(-per_thread // GEMV_BATCH)
    divisors = [c for c in range(1, MAX_CLUSTER + 1) if ks % c == 0]
    for c in divisors[1:]:
        if rounds(c) <= MAX_ROUNDS:
            return c
    return divisors[-1]


def mlp_plans(D: int, F: int, gated: bool, bits: Sequence[int],
              elem_bytes: int, bc: int) -> Tuple[GemvPlan, GemvPlan]:
    """The plans of the MLP's two stages: (bc, D) x (D, [up | gate]) with
    the GLU epilogue, then (bc, F) x (F, D); ``bits`` of up and down."""
    return (gemv_plan(D, F, 2 if gated else 1, bits[0], elem_bytes, bc),
            gemv_plan(F, D, 1, bits[1], elem_bytes, bc))


# vector columns a CTA of the fused QKV (scripts/fused_qkv_plan_sweep.py)
QKV_SLOTS = 8


def qkv_plan(K: int, n: int, bits: int, elem_bytes: int,
             bc: int) -> GemvPlan:
    """The plan of one fused-QKV launch over ``n`` outputs of weights side
    by side (``qkv_width``; pure Python, the kernel checks it): QKV_SLOTS
    vector columns a CTA (16 K sub-rows) and one cluster of MAX_CLUSTER
    CTAs along K (fewer where K has fewer rows than that many sub-rows),
    more only past MAX_K_CHUNK rows a CTA: no scratch at either served
    model's widths (the sweep's fastest at both)."""
    ck = max(1, min(MAX_CLUSTER, K // (GEMV_THREADS // QKV_SLOTS)))
    nck = -(-K // (ck * MAX_K_CHUNK))
    return _plan(K, n, 1, bits, elem_bytes, bc, QKV_SLOTS, ck * nck, ck)


def qkv_width(ns: Sequence[int], vec: int, slots: int) -> int:
    """The outputs of one fused-QKV launch over weights of ``ns`` outputs
    side by side: each weight in whole column tiles of ``slots`` vectors
    (its last padded), or one weight's own."""
    if len(ns) == 1:
        return ns[0]
    return sum(-(-(n // vec) // slots) for n in ns) * slots * vec


@functools.lru_cache(maxsize=256)
def qkv_plans(K: int, segs: Tuple[Tuple[int, int], ...], elem_bytes: int,
              bc: int) -> Tuple[GemvPlan, ...]:
    """The fused QKV's launches: one ``qkv_plan`` per distinct bit width
    among ``segs`` ((outputs, bits) of wq, wk, wv), in the order 0, 2, 4,
    8, each over its weights side by side in whole column tiles, so each
    CTA reads one weight (``qkv_width``)."""
    plans = []
    for bits in sorted({b for _, b in segs}):
        vec = 128 // bits if bits else 16 // elem_bytes
        ns = [n for n, b in segs if b == bits]
        plans.append(qkv_plan(K, qkv_width(ns, vec, QKV_SLOTS), bits,
                              elem_bytes, bc))
    return tuple(plans)


# arrival counters of the GEMV, one buffer a device, zero between
# calls (the last CTA of each tile and rank resets its counter); calls on
# one stream run one after another.  A buffer outgrown by a larger plan
# is kept, never freed: a captured CUDA graph (``serving/cohort_graph``)
# holds its address and finds it at zero at every replay
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_OUTGROWN: List[torch.Tensor] = []


def _counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


class _Weight:
    """One GEMM weight as the kernel reads it: a (K, n) matrix whose last
    logical axes are flattened, packed (int32 codes + fp32 scales) or
    dense (the activations' dtype)."""

    def __init__(self, w, K: int, dtype: torch.dtype, name: str):
        if isinstance(w, QTensor):
            if w.padded or w.shape[-1] % w.spec.group_size:
                raise ValueError(f"{name}: padded packed weight "
                                 f"{w.shape} is not supported")
            if w.dtype != dtype:
                raise ValueError(f"{name}: weight dtype {w.dtype} != "
                                 f"activation dtype {dtype}")
            if w.shape[0] != K:
                raise ValueError(f"{name}: K {w.shape[0]} != {K}")
            self.n = 1
            for s in w.shape[1:]:
                self.n *= s
            codes, scales = w.codes, w.scales
            _require_cuda(codes, scales)
            if codes.dtype != torch.int32 or scales.dtype != torch.float32:
                raise ValueError(f"{name}: codes must be int32 and scales "
                                 f"float32")
            self.bits, self.group = w.spec.bits, w.spec.group_size
            self.keep = (codes.contiguous(), scales.contiguous())
            self.ptrs = (self.keep[0].data_ptr(), self.keep[1].data_ptr())
        else:
            _require_cuda(w)
            if w.dtype != dtype or w.shape[0] != K:
                raise ValueError(f"{name}: dense weight {tuple(w.shape)} "
                                 f"{w.dtype} does not match K={K}, {dtype}")
            self.n = w[0].numel()
            if (self.n * w.element_size()) % 16:
                raise ValueError(f"{name}: dense rows must be 16-byte "
                                 f"multiples")
            self.bits, self.group = 0, 1
            self.keep = (w.contiguous(),)
            self.ptrs = (self.keep[0].data_ptr(), 0)


def _activation_dtype(h: torch.Tensor, what: str) -> torch.dtype:
    """The GEMV kernels' instances: bf16 or fp32 activations (and dense
    weights of the same dtype)."""
    if h.dtype not in DTYPES:
        raise ValueError(f"{what}: the kernel takes bfloat16 or float32 "
                         f"activations, got {h.dtype}")
    return h.dtype


def _require_cuda(*ts):
    for t in ts:
        if not t.is_cuda:
            raise ValueError("the fused-decode kernels take CUDA tensors")


def _rows(h: torch.Tensor) -> List[Tuple[int, int]]:
    bc = h.shape[0]
    return [(r, min(bc, r + MAX_ROWS)) for r in range(0, bc, MAX_ROWS)]


def launch_fused_qkv(h, wq, wk, wv, bq=None, bk=None, bv=None):
    """h (bc,1,D) -> q (bc,1,H,hd), k, v (bc,1,KV,hd) on the card: one
    split-K GEMV launch per distinct bit width among the three weights
    (``qkv_plans``), side by side along the outputs, per MAX_ROWS cohort
    rows.  Returns (outputs, calls into the library, device kernels)."""
    dtype = _activation_dtype(h, "fused_qkv")
    _require_cuda(h)
    bc, _, D = h.shape
    ws = [_Weight(w, D, dtype, nm) for w, nm in
          ((wq, "wq"), (wk, "wk"), (wv, "wv"))]
    for w, name in zip(ws, ("wq", "wk", "wv")):
        _gemv_takes(w, dtype, name, "fused_qkv")
    biases = (bq, bk, bv)
    if any(b is None for b in biases) and not all(b is None for b in biases):
        raise ValueError("fused_qkv: give all three biases or none")
    bias_t = [None if b is None else b.to(dtype).contiguous()
              for b in biases]
    tail = [tuple((wq, wk, wv)[i].shape[1:]) for i in range(3)]
    outs = [torch.empty((bc, 1) + tail[i], dtype=dtype, device=h.device)
            for i in range(3)]
    x = h.reshape(bc, D).contiguous()
    lib = library()
    calls = kernels = 0
    for r0, r1 in _rows(h):
        rows = r1 - r0
        plans = qkv_plans(D, tuple((w.n, w.bits) for w in ws),
                          h.element_size(), rows)
        partial = torch.empty(max(p.partial for p in plans),
                              dtype=torch.float32, device=h.device)
        counters = _counters(h.device, max(p.counters for p in plans))
        err = lib.rt_fused_qkv(
            x[r0:r1].data_ptr(), rows, D, 3,
            _ptr_array([w.ptrs[0] for w in ws]),
            _ptr_array([w.ptrs[1] for w in ws]),
            _int_array([w.n for w in ws]), _int_array([w.bits for w in ws]),
            _int_array([w.group for w in ws]),
            _ptr_array([0 if b is None else b.data_ptr() for b in bias_t]),
            _ptr_array([o[r0:r1].data_ptr() for o in outs]),
            _int_array([a for p in plans for a in p.args()]),
            partial.data_ptr(), counters.data_ptr(), DTYPES[dtype],
            _stream())
        _check(err, "fused_qkv")
        calls += 1
        kernels += len(plans)
    return tuple(outs), calls, kernels


def launch_fused_mlp(h, w_up, w_down, w_gate, act: str, gated: bool):
    """h (bc,1,D) -> (bc,1,D) on the card; ``act`` is the activation
    applied to the gate (gated) or to up.  Two device kernels a call (the
    split-K GEMV of each stage, ``mlp_plans``).  Returns (out, launches)."""
    dtype = _activation_dtype(h, "fused_mlp")
    if act not in ACTS:
        raise ValueError(f"fused_mlp: unsupported activation {act!r}")
    _require_cuda(h)
    bc, _, D = h.shape
    up = _Weight(w_up, D, dtype, "w_up")
    F = up.n
    gate = _Weight(w_gate, D, dtype, "w_gate") if gated else None
    if gate is not None and (gate.n != F or (gate.bits, gate.group)
                             != (up.bits, up.group)):
        raise ValueError("fused_mlp: w_gate and w_up differ in width, bits "
                         "or group")
    down = _Weight(w_down, F, dtype, "w_down")
    if down.n != D:
        raise ValueError(f"fused_mlp: w_down gives {down.n} outputs, "
                         f"expected {D}")
    for w, name in ((up, "w_up"), (down, "w_down")):
        _gemv_takes(w, dtype, name, "fused_mlp")
    ws = [up, gate if gate is not None else up, down]
    x = h.reshape(bc, D).contiguous()
    out = torch.empty((bc, 1, D), dtype=dtype, device=h.device)
    lib = library()
    launches = 0
    for r0, r1 in _rows(h):
        rows = r1 - r0
        p1, p2 = mlp_plans(D, F, gated, (up.bits, down.bits),
                           h.element_size(), rows)
        mid = torch.empty((rows, F), dtype=dtype, device=h.device)
        s1 = torch.empty(p1.partial, dtype=torch.float32, device=h.device)
        s2 = torch.empty(p2.partial, dtype=torch.float32, device=h.device)
        counters = _counters(h.device, p1.counters + p2.counters)
        err = lib.rt_fused_mlp(
            x[r0:r1].data_ptr(), rows, D, F, int(gated),
            ACTS[act], _ptr_array([w.ptrs[0] for w in ws]),
            _ptr_array([w.ptrs[1] for w in ws]),
            _int_array([w.bits for w in ws]),
            _int_array([w.group for w in ws]), mid.data_ptr(),
            out[r0:r1].data_ptr(), _int_array(p1.args()), s1.data_ptr(),
            _int_array(p2.args()), s2.data_ptr(), counters.data_ptr(),
            p1.counters, DTYPES[dtype], _stream())
        _check(err, "fused_mlp")
        launches += 1
    return out, launches


def _gemv_takes(w: "_Weight", dtype: torch.dtype, name: str, what: str):
    """Raise unless the GEMV takes weight ``w``: outputs a multiple of the
    16-byte vector's, and one scale group a vector (two for q2: the group
    a multiple of 32 outputs)."""
    vec = 128 // (w.bits or torch.finfo(dtype).bits)
    per_scale = vec // 2 if w.bits == 2 else vec
    if w.n % vec or (w.bits and w.group % per_scale):
        raise ValueError(f"{what}: {name} ({w.n} outputs, {w.bits} bits, "
                         f"group {w.group}) needs outputs a multiple of "
                         f"{vec} and a group a multiple of {per_scale}")


def launch_kv_row_scatter(blk, off, k_rows, v_rows, k_pool, v_pool):
    """In place: pool[g, blk[b], off[b]] = rows[g, b] on the card; rows
    with a sentinel block id (n_blocks) write nothing."""
    _require_cuda(blk, off, k_rows, v_rows, k_pool, v_pool)
    L, n_blocks, bs = k_pool.shape[:3]
    bc = k_rows.shape[1]
    for t in (k_pool, v_pool):
        if not t.is_contiguous():
            raise ValueError("kv_scatter: pools must be contiguous")
    if v_pool.shape != k_pool.shape:
        raise ValueError("kv_scatter: k/v pools differ in shape")
    if k_rows.dtype != k_pool.dtype or v_rows.dtype != v_pool.dtype:
        raise ValueError("kv_scatter: rows and pools differ in dtype")
    row_shape = tuple(k_pool.shape[3:])
    for r in (k_rows, v_rows):
        if tuple(r.shape) != (L, bc) + row_shape:
            raise ValueError(f"kv_scatter: rows {tuple(r.shape)} do not "
                             f"match pool {tuple(k_pool.shape)}")
    row_bytes = k_pool[0, 0, 0].numel() * k_pool.element_size()
    if row_bytes % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("kv_scatter: rows must be 16-byte multiples and "
                         "pools 16-byte aligned")
    blk = blk.to(torch.int32).contiguous()
    off = off.to(torch.int32).contiguous()
    k_rows, v_rows = k_rows.contiguous(), v_rows.contiguous()
    err = library().rt_kv_row_scatter(
        blk.data_ptr(), off.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), L, bc, n_blocks, bs,
        row_bytes, _stream())
    _check(err, "kv_row_scatter")
    return k_pool, v_pool
