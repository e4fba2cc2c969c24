"""Mamba-2 mixer (SSD — state-space duality, arXiv:2405.21060).

Scalar-per-head decay A, per-token dt, grouped B/C projections, causal
depthwise conv on (x, B, C), gated RMSNorm, out projection: the
reference's ``models/mamba2.py`` in PyTorch, same layouts and dtypes.

The SSD sequence transform is the chunked dual form: intra-chunk
attention-like products plus an inter-chunk state-passing scan.
``ssd_reference`` is the sequential recurrence (the tests' oracle),
``ssd_chunked`` the plain chunked form (the SSD kernel's plain version,
``kernels/ssd/ref.py``).  ``mamba_forward`` runs the SSD through
``kernels/ssd/ops.ssd`` and packed in/out projections through
``kernels/dequant_gemm``: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors.  It trains as it serves: under grad the SSD
call is an autograd Function whose backward is the SSD backward kernel
on the card (``ref_ssd_backward`` on the CPU); the conv, the softplus on
dt, the gated norm and the D skip stay autograd in PyTorch, as the
reference's ``mamba_forward`` leaves them to ``jax.grad``.

One addition to the reference: ``mamba_forward(valid_len=...)`` for
right-padded prompts.  Positions at or past a row's ``valid_len`` get
``dt = 0`` (decay exp(0) = 1, no input), so the SSD's final state is
the state at the true prompt end, and the conv tail is gathered at the
true end.  The reference's engine pads prompts without it, which
corrupts every SSM decode step after the first (ROADMAP §3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.dequant_gemm import ops as dg
from repro_torch.models.common import dense_init

# ---------------------------------------------------------------------------
# SSD core: h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t ;  y_t = C_t . h_t
#   a_t = exp(dt_t * A)  (A < 0 scalar per head)
# shapes: x (B,S,H,P), dt (B,S,H), B/C (B,S,G,N) with H % G == 0
# ---------------------------------------------------------------------------


def _per_head(m: torch.Tensor, H: int, dim: int) -> torch.Tensor:
    """Groups -> heads along ``dim``: head h reads group h // (H / G)."""
    return torch.repeat_interleave(m, H // m.shape[dim], dim=dim)


def ssd_reference(x, dt, A, Bm, Cm):
    """Sequential recurrence oracle from h = 0.  Returns (y (B,S,H,P) in
    x's dtype, h_final (B,H,P,N) fp32)."""
    b, S, H, P = x.shape
    N = Bm.shape[3]
    Bh = _per_head(Bm, H, 2).to(torch.float32)
    Ch = _per_head(Cm, H, 2).to(torch.float32)
    dtf = dt.to(torch.float32)
    a = torch.exp(dtf * A[None, None, :])                   # (B,S,H)
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = a[:, t, :, None, None] * h + (
            dtf[:, t, :, None, None] * x[:, t].to(torch.float32)[..., None]
            * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 256
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked dual-form SSD from h = 0 (matches ``ssd_reference`` to
    fp32 tolerance), all arithmetic in fp32 — in float64 for float64
    inputs (an evaluation to hold the fp32 versions against)."""
    b, S, H, P = x.shape
    N = Bm.shape[3]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd: sequence {S} is not a multiple of the "
                         f"chunk {chunk}")
    nc = S // chunk
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32

    xf = x.to(acc).reshape(b, nc, chunk, H, P)
    dtf = dt.to(acc).reshape(b, nc, chunk, H)
    Bf = _per_head(Bm, H, 2).to(acc).reshape(b, nc, chunk, H, N)
    Cf = _per_head(Cm, H, 2).to(acc).reshape(b, nc, chunk, H, N)
    la = dtf * A.to(acc)[None, None, None, :]               # log a
    cum = torch.cumsum(la, dim=2)                           # within-chunk

    # intra-chunk: Y[i] = sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) dt_j x_j;
    # the mask goes INSIDE the exp (for j > i the argument is large and
    # positive, and exp overflows)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,i,j,H)
    dec = torch.exp(torch.where(mask[None, None, :, :, None], dec,
                                torch.full((), -1e30, device=x.device)))
    cb = torch.einsum("bkihn,bkjhn->bkijh", Cf, Bf)
    w = cb * dec * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", w, xf)

    # chunk states: s_k = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j,
    # the exponent summed from the chunk's end (sum_{k>j} la_k): taken as
    # a difference of two prefix sums, which reach thousands at A = -16,
    # it keeps only fp32's resolution at that size
    rev = torch.flip(torch.cumsum(torch.flip(la, [2]), dim=2), [2])
    after = torch.cat([rev[:, :, 1:], torch.zeros_like(rev[:, :, :1])], 2)
    decay_to_end = torch.exp(after)                         # (b,nc,c,H)
    sbx = torch.einsum("bkjhn,bkjhp->bkhnp",
                       Bf * (decay_to_end * dtf)[..., None], xf)

    # inter-chunk recurrence: the state *before* each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (b,nc,H)
    h = torch.zeros((b, H, N, P), dtype=acc, device=x.device)
    h_prevs = []
    for k in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, k, :, None, None] * h + sbx[:, k]
    h_prevs = torch.stack(h_prevs, dim=1)                   # (b,nc,H,N,P)

    # inter-chunk contribution: C_i . (exp(cum_i) * h_prev)
    y_inter = torch.einsum("bkihn,bkhnp->bkihp",
                           Cf * torch.exp(cum)[..., None], h_prevs)

    y = (y_intra + y_inter).reshape(b, S, H, P).to(x.dtype)
    return y, h.transpose(-1, -2).contiguous()              # (b,H,P,N)


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """One-token recurrence.  h (B,H,P,N) fp32; x (B,H,P); dt (B,H);
    B/C (B,G,N)."""
    H = x.shape[1]
    Bh = _per_head(Bm, H, 1).to(torch.float32)
    Ch = _per_head(Cm, H, 1).to(torch.float32)
    dtf = dt.to(torch.float32)
    a = torch.exp(dtf * A[None, :])
    h = a[..., None, None] * h + (dtf[..., None, None]
                                  * x.to(torch.float32)[..., :, None]
                                  * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# full Mamba-2 mixer layer
# ---------------------------------------------------------------------------

def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    d_conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, H, d_conv_ch


def init_mamba(generator, cfg, device, lead=()):
    """The reference's mixer leaves (A_log = log linspace(1, 16, H), D
    ones, dt_bias zeros, all fp32), each with the leading ``lead`` axes
    (the stacked layers)."""
    s = cfg.ssm
    d_inner, H, d_conv_ch = _dims(cfg)
    dt_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + H  # z,x,B,C,dt
    dt = cfg.torch_dtype
    lead = tuple(lead)

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=device))
    return {
        "in_proj": dense_init(generator, lead + (cfg.d_model, dt_proj), dt,
                              device, fan_in=cfg.d_model),
        "conv_w": dense_init(generator, lead + (s.d_conv, d_conv_ch), dt,
                             device, fan_in=s.d_conv),
        "conv_b": full((d_conv_ch,), 0.0, dt),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), 0.0, torch.float32),
        "norm_scale": full((d_inner,), 1.0, dt),
        "out_proj": dense_init(generator, lead + (d_inner, cfg.d_model), dt,
                               device, fan_in=d_inner),
    }


def _split_proj(cfg, proj):
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    gs = s.n_groups * s.d_state
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * gs, H], dim=-1)
    return z, xbc, dt                                        # dt: (..., H)


def _conv_mix(win, w, b):
    """The ONE depthwise-conv contraction both the full-sequence and the
    one-token decode path share: windows (..., K, C) against taps (K, C),
    accumulated in fp32 tap by tap in a fixed order, with bias + silu
    before the cast back.  Teacher forcing and decode must agree bit for
    bit per token, so the two paths may not each pick their own
    summation order."""
    winf, wf = win.to(torch.float32), w.to(torch.float32)
    out = winf[..., 0, :] * wf[0]
    for k in range(1, w.shape[0]):
        out = out + winf[..., k, :] * wf[k]
    return F.silu(out + b.to(torch.float32))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d.  xbc (B,S,C); w (K,C)."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    win = torch.stack([pad[:, i:i + S, :] for i in range(K)], dim=2)
    return _conv_mix(win, w, b).to(xbc.dtype)


def _conv_tail(xbc, n: int, valid_len: Optional[torch.Tensor]):
    """The last ``n`` pre-conv rows: of the sequence (``valid_len`` None,
    the reference's slice) or before each row's ``valid_len``, with zeros
    before position 0 (the causal conv's own left padding)."""
    if valid_len is None:
        return xbc[:, -n:, :]
    B, S, C = xbc.shape
    pos = (valid_len.to(torch.long)[:, None]
           - n + torch.arange(n, device=xbc.device)[None, :])   # (B, n)
    rows = xbc.gather(1, pos.clamp(0, S - 1)[..., None].expand(B, n, C))
    return torch.where((pos >= 0)[..., None], rows,
                       torch.zeros((), dtype=xbc.dtype, device=xbc.device))


def _gated_norm(y, z, scale, eps=1e-5):
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    var = y.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (y.to(torch.float32) * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(y.dtype)


def mamba_forward(p, cfg, x, valid_len: Optional[torch.Tensor] = None):
    """Full-sequence Mamba-2 from a zero state.  x (B,S,D) -> (y (B,S,D),
    (conv_tail (B,d_conv-1,C), h_final (B,H,P,N))).  The SSD runs through
    ``kernels/ssd/ops.ssd``.  ``valid_len`` (B,) marks right padding: see
    the module docstring."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    B_, S, _ = x.shape
    gs = s.n_groups * s.d_state

    proj = dg.quant_einsum("bsd,de->bse", x, p["in_proj"])
    z, xbc, dt = _split_proj(cfg, proj)
    conv_tail = _conv_tail(xbc, s.d_conv - 1, valid_len)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = torch.split(xbc, [d_inner, gs, gs], dim=-1)
    xs = xs.reshape(B_, S, H, s.head_dim)
    Bm = Bm.reshape(B_, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(B_, S, s.n_groups, s.d_state)
    dtv = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    if valid_len is not None:
        keep = (torch.arange(S, device=x.device)[None, :]
                < valid_len.to(x.device)[:, None])
        dtv = torch.where(keep[..., None], dtv,
                          torch.zeros((), dtype=dtv.dtype, device=x.device))
    A = -torch.exp(p["A_log"])

    # imported here: kernels/ssd/ref.py imports this module
    from repro_torch.kernels.ssd.ops import ssd
    y, h = ssd(xs, dtv, A, Bm, Cm, chunk=s.chunk_size)
    y = y + xs * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, d_inner)
    y = _gated_norm(y, z, p["norm_scale"])
    out = dg.quant_einsum("bse,ed->bsd", y, p["out_proj"])
    return out, (conv_tail, h)


def mamba_decode(p, cfg, x, conv_state, h):
    """One-token decode.  x (B,1,D); conv_state (B,d_conv-1,C); h
    (B,H,P,N) fp32."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    B_ = x.shape[0]
    gs = s.n_groups * s.d_state

    proj = dg.quant_einsum("bsd,de->bse", x, p["in_proj"])
    z, xbc, dt = _split_proj(cfg, proj)
    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B,K,C)
    conv_state_new = window[:, 1:, :]
    conv = _conv_mix(window, p["conv_w"], p["conv_b"]).to(xbc.dtype)
    xs, Bm, Cm = torch.split(conv, [d_inner, gs, gs], dim=-1)
    xs = xs.reshape(B_, H, s.head_dim)
    Bm = Bm.reshape(B_, s.n_groups, s.d_state)
    Cm = Cm.reshape(B_, s.n_groups, s.d_state)
    dtv = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, h = ssd_decode_step(h, xs, dtv, A, Bm, Cm)
    y = y + xs * p["D"][None, :, None].to(y.dtype)
    y = y.reshape(B_, 1, d_inner)
    y = _gated_norm(y, z, p["norm_scale"])
    out = dg.quant_einsum("bse,ed->bsd", y, p["out_proj"])
    return out, (conv_state_new, h)


def init_mamba_cache(cfg, batch: int, device, lead=()):
    """Zero decode state: conv tail (lead, batch, d_conv-1, C) in the
    compute dtype, SSD state (lead, batch, H, P, N) fp32."""
    s = cfg.ssm
    d_inner, H, d_conv_ch = _dims(cfg)
    lead = tuple(lead)
    return (torch.zeros(lead + (batch, s.d_conv - 1, d_conv_ch),
                        dtype=cfg.torch_dtype, device=device),
            torch.zeros(lead + (batch, H, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device))
