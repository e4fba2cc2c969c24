"""The routed experts' GEMV of a decode step (``fused_mlp/experts``) on
the CPU: its launch plan and its arithmetic.

The kernel (``csrc/expert_gemv.cu``) runs only on the card
(``test_torch_cuda_kernels.py`` holds it there against its plain version
and against ``ref.emulate_fused_mlp_experts``).  Here:

* ``expert.expert_plans`` at every served MoE width (DeepSeek-MoE-16B,
  DBRX, Jamba-1.5-Large) and small widths, every cohort, packing and
  dtype: the column tiles cover each output vector of each segment once,
  the K splits and each CTA's thread rows each K row once, the grid's
  routed slots are min(bc k, E) and so hold every routing (a mirror of
  the kernel's routing covers each routed (row, expert) once), a CTA's
  shared memory leaves three CTAs an SM within 227 KB, and the served
  widths put at least 132 CTAs on the card from cohort 4 up;
* ``emulate_fused_mlp_experts`` (the kernel's order, the scale folded
  into x) against the plain version (``ref_fused_mlp_experts``), against
  the reference's composed ``ref_fused_mlp`` per (row, expert) under JAX,
  and against float64 of the dequantized weights: fp32 within 1e-5 of the
  largest output, bf16 within 2e-2 of each row's largest, and within
  twice the plain version's error against float64 (plus one output
  rounding), for q4 (groups of 32 and of 16: one scale a word), q8 and
  dense experts, a row choosing one expert twice, sentinel rows.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32, from_numpy_to_ref
from repro.kernels import fused_decode as RF
from repro_torch import bridge
from repro_torch.core import quantize as TQ
from repro_torch.kernels.fused_decode import expert as EK
from repro_torch.kernels.fused_decode import ref as FR

# (E, top_k, D, F) of each served MoE config, and small widths
SERVED = {"deepseek-moe-16b": (64, 6, 2048, 1408),
          "dbrx-132b": (16, 4, 6144, 10752),
          "jamba-1.5-large-398b": (16, 2, 8192, 24576)}
SMALL = {"small": (6, 2, 128, 192), "small-k8": (8, 8, 64, 96)}
# dynamic shared memory a CTA may take so three fit an SM beside the
# static routing table (227 KB of the SM's 228 KB)
SMEM_3_CTAS = 232448 // 3 - 1024
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ref_fused_mlp = jax.jit(RF.ref_fused_mlp, static_argnames=("act",))


def route_mirror(idx, valid, E):
    """The kernel's routing (``route`` in ``expert_gemv.cu``) in Python:
    the experts valid rows chose, in order of first choice, each with
    its rows in order and each row's canonical pair (its first choice of
    that expert)."""
    bc, k = idx.shape
    order = []
    for p in range(bc * k):
        e = int(idx[p // k, p % k])
        if valid[p // k] and e not in order:
            order.append(e)
    slots = []
    for e in order:
        rows = [(r, r * k + list(idx[r]).index(e)) for r in range(bc)
                if valid[r] and e in list(idx[r])]
        slots.append((e, rows))
    assert len(slots) <= min(bc * k, E)
    return slots


def _covers(plan, K, N):
    """Each output vector of each segment once over the column tiles and
    slots of a CTA; each K row once over the splits and a CTA's threads."""
    nvec = N // plan.vec
    sps = plan.ts // plan.nseg
    hits = np.zeros((plan.nseg, plan.tiles * sps), int)
    for tile in range(plan.tiles):
        for slot in range(plan.ts):
            hits[slot // sps, tile * sps + slot % sps] += 1
    assert (hits[:, :nvec] == 1).all() and hits.shape[1] - nvec < sps
    rows = np.zeros(K, int)
    steps = -(-plan.k_chunk // plan.nsub)
    for z in range(plan.k_split):
        k0 = z * plan.k_chunk
        kn = max(0, min(plan.k_chunk, K - k0))
        kk = (np.arange(plan.nsub)[:, None]
              + np.arange(steps)[None] * plan.nsub).reshape(-1)
        assert sorted(kk.tolist()) == list(range(steps * plan.nsub))
        np.add.at(rows, k0 + kk[kk < kn], 1)
    assert (rows == 1).all()


@pytest.mark.parametrize("bc", range(1, 9))
@pytest.mark.parametrize("bits", [0, 4, 8])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("arch", list(SERVED) + list(SMALL))
def test_expert_plan_covers_every_routed_item_once(arch, elem_bytes, bits,
                                                   bc):
    """Both stages' plans: each output vector and K row once, the grid's
    slots min(bc k, E) holding every routing of the cohort (a random
    routing's slots through the kernel's routing mirror: each routed
    (row, expert) once), the CTA's shared memory within a third of the
    SM, K rows a CTA within the activations' room, each thread at least
    EXPERT_MIN_ROWS rows unless that room sets the split; the served
    widths put at least 132 CTAs on the card from cohort 4 up and the
    scratch sizes match."""
    E, k, D, F = {**SERVED, **SMALL}[arch]
    group = 32 if bits else 0
    plans = EK.expert_plans(bc, k, E, D, F, True, (bits, bits), elem_bytes,
                            (group, group))
    for p, (K, N, nseg) in zip(plans, ((D, F, 2), (F, D, 1))):
        assert p.nseg == nseg and p.slots == min(bc * k, E)
        assert p.vec == (128 // bits if bits else 16 // elem_bytes)
        _covers(p, K, N)
        assert p.k_chunk <= EK.EXPERT_MAX_KC
        assert p.k_chunk * p.k_split >= K > p.k_chunk * (p.k_split - 1)
        assert p.smem == EK._smem(p.vec, p.ts, p.k_chunk, 1)
        assert p.smem <= SMEM_3_CTAS
        least = -(-K // EK.EXPERT_MAX_KC)
        assert (p.k_split == least
                or p.k_chunk >= p.nsub * EK.EXPERT_MIN_ROWS)
        if arch in SERVED and bc >= 4:
            assert p.blocks >= EK.SMS
    n_y, n1, n2, n_ctr = EK.scratch_floats(plans, bc * k, D, F)
    assert n_y == bc * k * D
    assert n1 == (plans[0].k_split * bc * k * 2 * F
                  if plans[0].k_split > 1 else 1)
    assert n2 == (plans[1].k_split * bc * k * D
                  if plans[1].k_split > 1 else 1)
    assert n_ctr == max(plans[0].slots * plans[0].tiles,
                        plans[1].slots * plans[1].tiles + plans[1].tiles)
    rng = np.random.default_rng(bc)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(bc)])
    if k > 1:
        idx[0, 1] = idx[0, 0]
    valid = np.ones(bc, bool)
    valid[1::3] = False
    slots = route_mirror(idx, valid, E)
    seen = {}
    for e, rows in slots:
        for r, c in rows:
            assert idx[r, c % k] == e and (r, e) not in seen
            seen[(r, e)] = c
    want = {(r, int(e)) for r in range(bc) if valid[r] for e in idx[r]}
    assert set(seen) == want


def test_expert_plan_scales_a_word_for_narrow_groups():
    """A group narrower than a 16-byte vector (q4 g8 / g16, q8 g8) takes
    one scale a word, a group of whole vectors one a vector; the plan's
    shared memory counts the scale ring either way."""
    p = EK.expert_plan(4, 2, 8, 256, 512, 2, 4, 2, 16)
    assert p.scales == 4 and p.smem == EK._smem(p.vec, p.ts, p.k_chunk, 4)
    assert EK.expert_plan(4, 2, 8, 256, 512, 2, 4, 2, 64).scales == 1
    assert EK.expert_plan(4, 2, 8, 256, 512, 2, 8, 2, 8).scales == 4
    assert EK.expert_plan(4, 2, 8, 256, 512, 2, 0, 2).scales == 0
    with pytest.raises(ValueError):
        EK.expert_plan(4, 2, 8, 256, 200, 2, 4, 2, 8)


# (bits, group) of each packing; None: dense
LABELS = {"q4": (4, 32), "q4g16": (4, 16), "q8": (8, 64), "dense": None}


def _experts(rng, E, D, F, label, dtype):
    """(up, gate, down) stacked (E, K, N) in the port's form: dense, or
    packed by the port's quantize, one expert at a time."""
    out = []
    for K, N in ((D, F), (D, F), (F, D)):
        w = torch.from_numpy((rng.standard_normal((E, K, N))
                              / np.sqrt(K)).astype(np.float32)).to(dtype)
        if LABELS[label] is not None:
            nbits, g = LABELS[label]
            w = TQ.quantize(w, TQ.QuantSpec(nbits, group_size=g))
        out.append(w)
    return out


def _routing(rng, bc, k, E, case):
    idx = np.stack([rng.permutation(E)[:k] for _ in range(bc)])
    if case == "twice":
        idx[0, 1] = idx[0, 0]
    gates = rng.random((bc, k)) + 0.1
    gates = (gates / gates.sum(1, keepdims=True)).astype(np.float32)
    valid = np.ones(bc, bool)
    if case == "sentinel":
        valid[1::2] = False
    return idx, gates, valid


def _f64(h, ws, idx, gates, valid):
    """float64 of the routed SwiGLU MLP on the dequantized weights (no
    rounding anywhere; gates as given)."""
    up, gate, down = (TQ.dequantize(w).double() if isinstance(w, TQ.QTensor)
                      else w.double() for w in ws)
    h = h.double()
    out = torch.zeros(h.shape, dtype=torch.float64)
    for r in range(h.shape[0]):
        if not valid[r]:
            continue
        for j, e in enumerate(idx[r]):
            g = h[r] @ gate[e]
            mid = g * torch.sigmoid(g) * (h[r] @ up[e])
            out[r] += float(gates[r, j]) * (mid @ down[e])
    return out


def _row_err(got, want, valid):
    """Each valid row's largest error over its largest |want|, the
    largest of those."""
    g, w = got[valid].double(), want[valid].double()
    return float(((g - w).abs().amax(1) / w.abs().amax(1)).max())


@pytest.mark.parametrize("case", ["top", "twice", "sentinel"])
@pytest.mark.parametrize("label", list(LABELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_matches_plain_reference_and_float64(dtype, label, case):
    """The kernel's arithmetic and order (the plan of these widths, and a
    plan with more K splits) against the plain version, the reference's
    ``ref_fused_mlp`` per (row, expert) under JAX, and float64; sentinel
    rows exactly 0."""
    E, k, D, F = SMALL["small"]
    bc = 5
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(zlib.crc32(f"{dtype}{label}{case}".encode()))
    ws = _experts(rng, E, D, F, label, dt)
    idx, gates, valid = _routing(rng, bc, k, E, case)
    h = torch.from_numpy(rng.standard_normal((bc, D)).astype(np.float32)
                         ).to(dt)
    bits = LABELS[label][0] if LABELS[label] else 0
    group = LABELS[label][1] if LABELS[label] else 0
    plans = EK.expert_plans(bc, k, E, D, F, True, (bits, bits),
                            h.element_size(), (group, group))
    split = (dataclasses.replace(plans[0], k_chunk=24, k_split=6),
             dataclasses.replace(plans[1], k_chunk=40, k_split=5))
    args = (torch.from_numpy(idx), torch.from_numpy(gates),
            torch.from_numpy(valid))
    plain = FR.ref_fused_mlp_experts(h, ws[0], ws[2], ws[1], *args,
                                     act="swiglu")
    f64 = _f64(h, ws, idx, gates, valid)
    plain_err = _row_err(plain, f64, valid)

    # the reference's composed oracle per (row, expert), summed in order
    jw = [from_numpy_to_ref(bridge.to_numpy(FR._expert(w, e)))
          for w in ws for e in range(E)]
    jh = jnp.asarray(f32(h)).astype(dtype)
    want = np.zeros((bc, D), np.float32)
    for r in range(bc):
        if not valid[r]:
            continue
        for j, e in enumerate(idx[r]):
            y = ref_fused_mlp(jh[r][None, None], jw[e], jw[2 * E + e],
                              jw[E + e], act="swiglu")
            g = np.float32(jnp.asarray(gates[r, j]).astype(dtype))
            want[r] += g * f32(y)[0, 0]

    for pl in (plans, split):
        got = FR.emulate_fused_mlp_experts(h, ws[0], ws[2], ws[1], *args,
                                           act="swiglu", plans=pl)
        assert got.dtype == dt and tuple(got.shape) == (bc, D)
        assert torch.count_nonzero(got[~torch.from_numpy(valid)]) == 0
        for ref in (plain, torch.from_numpy(want)):
            if dtype == "float32":
                m = float(ref.abs().max())
                assert float((got - ref).abs().max()) <= TOL[dtype] * m
            else:
                assert _row_err(got, ref.to(dt), valid) <= TOL[dtype]
        # within twice the plain version's error against float64, plus
        # one rounding of the output (2^-8 bf16, 2^-23 fp32)
        ulp = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -23
        assert _row_err(got, f64, valid) <= 2 * plain_err + ulp
