"""Hybrid per-brick quantization, in PyTorch.

The port of the reference's group-wise symmetric scheme, held to it bit
for bit: codes and scales of :func:`quantize` are array-equal to the
reference's on the same fp32 input, and :func:`dequantize` follows the
same cast chain (int -> fp32 -> x scale -> slice -> ``qt.dtype``).

Packing layout: codes are packed along the **last** axis, ``32 // bits``
two's-complement fields per int32 word (field ``i`` at bit ``i * bits``),
with one fp32 scale per contiguous group of ``group_size`` values of the
last axis.  The fused decode kernels (``kernels/fused_decode``) unpack
this layout on the card.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

__all__ = [
    "QuantSpec", "QTensor", "quantize", "dequantize", "unpack_codes",
    "quantize_tree", "dequantize_tree", "QuantPolicy", "PROFILES",
    "tree_bytes", "parse_label", "prune_weights",
]


@dataclass(frozen=True)
class QuantSpec:
    """Group-wise symmetric quantization spec (see the reference for the
    MSE scale search: ``scale_search`` candidates in ``[scale_shrink, 1]
    * amax/qmax``, the max-abs scale always among them)."""

    bits: int                  # 2 | 4 | 8
    group_size: int = 64
    scale_dtype: str = "float32"
    scale_search: int = 8
    scale_shrink: float = 0.75

    def __post_init__(self):
        if self.bits not in (2, 4, 8):
            raise ValueError(f"bits must be 2, 4 or 8, got {self.bits}")
        if not 0.0 < self.scale_shrink <= 1.0:
            raise ValueError(f"scale_shrink {self.scale_shrink} not in (0, 1]")

    @property
    def per_word(self) -> int:
        return 32 // self.bits

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))


@dataclass
class QTensor:
    """Packed quantized tensor: int32 ``codes`` (..., K // per_word) and
    fp32 ``scales`` (..., K // group_size) of a logical ``shape``."""

    codes: torch.Tensor
    scales: torch.Tensor
    spec: QuantSpec
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return int(self.codes.numel() * 4
                   + self.scales.numel() * self.scales.element_size())

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def padded(self) -> bool:
        """True when the last axis was padded up to the packing unit."""
        return self.codes.shape[-1] * self.spec.per_word != self.shape[-1]

    def layer(self, i: int) -> "QTensor":
        """Slice of the leading (stacked-layer) axis."""
        return QTensor(self.codes[i], self.scales[i], self.spec,
                       tuple(self.shape[1:]), self.dtype)

    def to(self, device, non_blocking: bool = False) -> "QTensor":
        return QTensor(self.codes.to(device, non_blocking=non_blocking),
                       self.scales.to(device, non_blocking=non_blocking),
                       self.spec, self.shape, self.dtype)

    def pin_memory(self) -> "QTensor":
        return QTensor(self.codes.pin_memory(), self.scales.pin_memory(),
                       self.spec, self.shape, self.dtype)

    def __repr__(self):
        return (f"QTensor(w{self.spec.bits}, shape={self.shape}, "
                f"g={self.spec.group_size})")


def _pad_last(x: torch.Tensor, multiple: int):
    k = x.shape[-1]
    pad = (-k) % multiple
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, k


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """The reference's float32 ``linspace`` bit for bit: step = iota *
    (1/div) in fp32, ``start*(1-step) + stop*step``, last = stop."""
    div = np.float32(num - 1)
    step = np.arange(num - 1, dtype=np.float32) * (np.float32(1) / div)
    out = (np.float32(start) * (np.float32(1) - step)
           + np.float32(stop) * step)
    return np.concatenate([out, [np.float32(stop)]]).astype(np.float32)


def _mse_scale(grp: torch.Tensor, scale: torch.Tensor,
               spec: QuantSpec) -> torch.Tensor:
    """Per-group MSE-optimal scale over the shrink grid; ties go to the
    LARGEST candidate (the reference's reversed-argmin order).

    grp (R, G, g) fp32; scale (R, G, 1) the max-abs scale."""
    fr = torch.from_numpy(_linspace_f32(spec.scale_shrink, 1.0,
                                        spec.scale_search)).to(grp.device)
    cand = scale[..., None] * fr                         # (R, G, 1, n)
    safe = torch.where(cand == 0, torch.ones_like(cand), cand)
    q = torch.clamp(torch.round(grp[..., None] / safe), spec.qmin, spec.qmax)
    d = q * cand - grp[..., None]
    err = (d * d).sum(dim=-2)                           # (R, G, n)
    n = fr.shape[0]
    best = (n - 1) - torch.argmin(torch.flip(err, dims=(-1,)), dim=-1)
    return torch.take_along_dim(cand[..., 0, :], best[..., None], dim=-1)


# rows of groups per MSE-search chunk: bounds the (rows, G, g, n) fp32
# temporaries to ~128 MB whatever the weight's size
_CHUNK_ELEMS = 1 << 22
# weight elements quantized at a time: rows are independent (groups lie
# along the last axis), so a large leaf packs in slices with the same
# codes while its fp32/int64 temporaries stay ~0.5 GB
_PACK_ELEMS = 1 << 24


def _quantize_rows(rows: torch.Tensor, spec: QuantSpec):
    """(R, K) -> int32 codes (R, kp / per_word), scales (R, kp / g)."""
    wf, _ = _pad_last(rows.to(torch.float32),
                      max(spec.group_size, spec.per_word))
    kp = wf.shape[-1]
    g = spec.group_size
    grp = wf.reshape(-1, kp // g, g)
    scales = []
    step = max(1, _CHUNK_ELEMS // max(1, kp * spec.scale_search))
    for r0 in range(0, grp.shape[0], step):
        chunk = grp[r0:r0 + step]
        amax = chunk.abs().amax(dim=-1, keepdim=True)
        sc = amax / spec.qmax
        if spec.scale_search > 1:
            sc = _mse_scale(chunk, sc, spec)
        scales.append(sc)
    scale = torch.cat(scales, dim=0)                     # (R, G, 1)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(grp / safe), spec.qmin, spec.qmax)
    q = q.to(torch.int64).reshape(-1, kp)
    pw = spec.per_word
    qu = (q & ((1 << spec.bits) - 1)).reshape(-1, kp // pw, pw)
    shifts = torch.arange(pw, device=rows.device,
                          dtype=torch.int64) * spec.bits
    words = (qu << shifts).sum(dim=-1)                   # in [0, 2^32)
    words = words - ((words >> 31) & 1) * (1 << 32)      # two's complement
    return words.to(torch.int32), scale[..., 0].reshape(-1, kp // g)


def quantize(w: torch.Tensor, spec: QuantSpec) -> QTensor:
    """Group-wise symmetric quantization along the last axis."""
    orig_shape, orig_dtype = tuple(w.shape), w.dtype
    rows = w.reshape(-1, orig_shape[-1])
    step = max(1, _PACK_ELEMS // max(1, orig_shape[-1]))
    parts = [_quantize_rows(rows[r0:r0 + step], spec)
             for r0 in range(0, rows.shape[0], step)]
    codes = torch.cat([c for c, _ in parts])
    scales = torch.cat([s for _, s in parts])
    lead = orig_shape[:-1]
    return QTensor(codes.reshape(*lead, codes.shape[-1]),
                   scales.reshape(*lead, scales.shape[-1]).to(
                       getattr(torch, spec.scale_dtype)),
                   spec, orig_shape, orig_dtype)


def unpack_codes(codes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """int32 words -> signed integer codes (..., K) in int32."""
    pw = spec.per_word
    shifts = torch.arange(pw, device=codes.device,
                          dtype=torch.int32) * spec.bits
    field = (codes[..., None] >> shifts) & ((1 << spec.bits) - 1)
    sign = 1 << (spec.bits - 1)
    q = torch.where(field >= sign, field - (1 << spec.bits), field)
    return q.reshape(*codes.shape[:-1], codes.shape[-1] * pw)


def dequantize(qt: QTensor) -> torch.Tensor:
    """int -> fp32 -> x scale -> slice -> ``qt.dtype``."""
    q = unpack_codes(qt.codes, qt.spec).to(torch.float32)
    g = qt.spec.group_size
    kp = q.shape[-1]
    q = q.reshape(*q.shape[:-1], kp // g, g)
    w = q * qt.scales.to(torch.float32)[..., None]
    w = w.reshape(*q.shape[:-2], kp)[..., :qt.shape[-1]]
    return w.to(qt.dtype)


# ---------------------------------------------------------------------------
# activation-aware magnitude pruning (EdgeMM-style semi-structured sparsity)
# ---------------------------------------------------------------------------

# elements sorted at once: bounds the sort's scratch (values and int64
# indices, 12 bytes an element) on a stacked full-width leaf
_PRUNE_SORT_CHUNK = 1 << 26


def _row_quantile(score: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row quantile of ``score`` (fp32) along its last axis, keepdims,
    in the reference's arithmetic: the linear method in fp32 (position
    ``q * (n - 1)``, then ``low * (1 - frac) + high * frac``), so ties
    thresholded against it flip exactly where the reference's do.  Rows
    are sorted in chunks (``torch.quantile`` refuses more than 2**24
    elements)."""
    n = score.shape[-1]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    hi_w = np.float32(pos - lo)
    lo_w = np.float32(1.0) - hi_w
    lo = int(min(max(lo, 0), n - 1))
    hi = int(min(max(hi, 0), n - 1))
    rows = score.reshape(-1, n)
    out = torch.empty(rows.shape[0], 2, dtype=torch.float32,
                      device=score.device)
    step = max(1, _PRUNE_SORT_CHUNK // n)
    for r in range(0, rows.shape[0], step):
        srt = torch.sort(rows[r:r + step], dim=-1).values
        out[r:r + step] = srt[:, [lo, hi]]
        del srt
    thresh = (out[:, 0] * torch.tensor(lo_w, device=score.device)
              + out[:, 1] * torch.tensor(hi_w, device=score.device))
    return thresh.reshape(*score.shape[:-1], 1)


def prune_weights(w: torch.Tensor, sparsity: float,
                  act_scale=None) -> torch.Tensor:
    """Zero the lowest-scoring ``sparsity`` fraction of each last-axis row.

    The score is Wanda-style ``|W| * |act_scale|`` in fp32 (plain
    magnitude without ``act_scale``, which broadcasts against ``w`` as the
    reference's does: sized to the last axis); each row's threshold is its
    fp32 linear quantile, and ``score > thresh`` survives, cast back to
    ``w.dtype``.  The repo's weights are ``[d_in, d_out]``, so a "row" is
    thresholded over outputs, as in the reference.  Prune first, then
    group-quantize the survivors."""
    if sparsity <= 0.0:
        return w
    if not 0.0 < sparsity < 1.0:
        raise ValueError(f"sparsity {sparsity} not in (0, 1)")
    wf = w.to(torch.float32)
    score = wf.abs()
    if act_scale is not None:
        score = score * torch.as_tensor(act_scale, dtype=torch.float32,
                                        device=w.device).abs()
    thresh = _row_quantile(score, sparsity)
    return torch.where(score > thresh, wf, wf.new_zeros(())).to(w.dtype)


# ---------------------------------------------------------------------------
# per-brick policies (the paper's Module-Quantization label format)
# ---------------------------------------------------------------------------

_LABEL_SPECS: Dict[str, Optional[QuantSpec]] = {
    "fp16": None,
    "bf16": None,
    "q8f16": QuantSpec(8),
    "q4f16": QuantSpec(4),
    "q2f16": QuantSpec(2),
    "q4f16-g32": QuantSpec(4, group_size=32),
}

_SP_RE = re.compile(r"^(?P<base>.+?)-sp(?P<pct>\d{1,2})$")


def parse_label(label: str) -> Tuple[Optional[QuantSpec], float]:
    """'q4f16-g32-sp50' -> (QuantSpec(4, 32), 0.50); plain -> (spec, 0.0)."""
    sparsity = 0.0
    m = _SP_RE.match(label)
    if m:
        sparsity = int(m.group("pct")) / 100.0
        label = m.group("base")
    return _LABEL_SPECS[label], sparsity


@dataclass(frozen=True)
class QuantPolicy:
    """Maps brick-name patterns to quantization labels (first match)."""

    name: str
    rules: Tuple[Tuple[str, str], ...]
    min_size: int = 1 << 14

    def label_for(self, path: str) -> str:
        for pat, label in self.rules:
            if re.search(pat, path):
                return label
        return "bf16"


PROFILES: Dict[str, QuantPolicy] = {
    "nanomind-default": QuantPolicy("nanomind-default", (
        (r"vis|projector", "fp16"),
        (r"embed", "fp16"),
        (r"layers|dec|lm_head", "q4f16"),
    )),
    "nanomind-serve": QuantPolicy("nanomind-serve", (
        (r"vis|projector", "fp16"),
        (r"embed", "fp16"),
        (r"layers|dec|lm_head", "q4f16-g32"),
    )),
    "all-fp16": QuantPolicy("all-fp16", ()),
    "all-q4": QuantPolicy("all-q4", ((r".", "q4f16"),)),
    "vis-q4": QuantPolicy("vis-q4", (
        (r"vis|projector", "q4f16"), (r"embed", "fp16"),
        (r"layers|dec|lm_head", "q4f16"),
    )),
    "dec-q2": QuantPolicy("dec-q2", (
        (r"vis|projector|embed", "fp16"),
        (r"layers|dec|lm_head", "q2f16"),
    )),
    "dec-q8": QuantPolicy("dec-q8", (
        (r"vis|projector|embed", "fp16"),
        (r"layers|dec|lm_head", "q8f16"),
    )),
    # EdgeMM-style activation-aware 50% sparsity stacked under W4A16
    "nanomind-sparse": QuantPolicy("nanomind-sparse", (
        (r"vis|projector|embed", "fp16"),
        (r"layers|dec|lm_head", "q4f16-g32-sp50"),
    )),
}


def quantize_tree(params, policy: QuantPolicy, act_scales=None):
    """Quantize (and optionally prune) eligible leaves per the policy:
    floating tensors of rank >= 2 and at least ``policy.min_size``
    elements whose path's label names a spec.  A label with an
    ``-sp<pct>`` suffix prunes the leaf first (:func:`prune_weights`);
    ``act_scales`` maps path substrings (of the ``/``-joined key path, the
    reference's form) to per-input activation magnitudes, the first whose
    substring the path contains applying (magnitude-only when none)."""
    def visit(path, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
            return leaf
        if leaf.numel() < policy.min_size or not leaf.is_floating_point():
            return leaf
        spec, sparsity = parse_label(policy.label_for(path))
        if sparsity > 0.0:
            act = None
            for pat, scale in (act_scales or {}).items():
                if pat in path:
                    act = scale
                    break
            leaf = prune_weights(leaf, sparsity, act)
        return leaf if spec is None else quantize(leaf, spec)

    return tree_map_with_path(visit, params)


def dequantize_tree(params):
    """Every :class:`QTensor` leaf dequantized; other leaves untouched."""
    return tree_map(lambda l: dequantize(l) if isinstance(l, QTensor) else l,
                    params)


def tree_bytes(params) -> int:
    """Weight bytes after quantization (packed codes + scales counted)."""
    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
