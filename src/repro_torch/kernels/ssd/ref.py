"""Plain PyTorch versions of the SSD kernels: the port's ``ssd_chunked``
(the function the forward kernel computes, all arithmetic in fp32),
``ssd_reference``, the sequential recurrence, as its oracle, and
``ref_ssd_backward``, the chunked form's derivative written out (the
function the backward kernel computes).

The wrapper in ``ops.py`` runs ``ref_ssd_chunked`` and
``ref_ssd_backward`` for CPU tensors; the tests hold them against the
reference package (``jax.vjp`` of its ``ssd_chunked`` for the backward),
and the card's checks hold the kernels against them.  ``split3`` and
``emulate_ssd_mma`` repeat the arithmetic of the forward kernel's bf16
("mma") route, ``emulate_ssd_bwd_mma`` that of the backward kernel's two
routes, for the tests to hold them against the reference.
"""
from __future__ import annotations

import torch

from repro_torch.models.mamba2 import _per_head
from repro_torch.models.mamba2 import ssd_chunked as ref_ssd_chunked
from repro_torch.models.mamba2 import ssd_reference as ref_ssd

__all__ = ["ref_ssd", "ref_ssd_chunked", "ref_ssd_backward", "split3",
           "emulate_ssd_mma", "emulate_ssd_bwd_mma"]

TILE = 64             # rows and keys of the backward kernel's tiles (kTile)


def _rev_cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.flip(torch.cumsum(torch.flip(t, [dim]), dim=dim), [dim])


def ref_ssd_backward(x, dt, A, Bm, Cm, dy, dh=None, *, chunk: int = 256):
    """The gradients (dx, ddt, dA, dB, dC) of ``ssd_chunked(x, dt, A, Bm,
    Cm, chunk)`` given dy, the gradient of y (B,S,H,P), and dh, that of
    h_final (B,H,P,N) (None: zero), each in its input's dtype.  All
    arithmetic in fp32 (float64 for float64 inputs), as ``ssd_chunked``'s.

    Per (batch, head) and chunk of L positions, with la = dt A, cum its
    inclusive cumsum within the chunk, after_j = sum_{k>j} la_k (summed
    from the chunk's end, as the forward's state weights), h_prev the
    state before the chunk and hn the gradient of the state after it:

    - the reverse state pass: hn of the last chunk is dh, and the state
      before chunk c gets exp(cum_last) hn + sum_i exp(cum_i) dy_i (x) C_i;
    - M_ij = dy_i . x_j, T_ij = exp(cum_i - cum_j) dt_j M_ij on j <= i
      (the gradient of C_i . B_j), G_ij = (C_i . B_j) exp(cum_i - cum_j)
      M_ij (that of dt_j through the weights);
    - dx_j = sum_{i>=j} (C_i . B_j) exp(cum_i - cum_j) dt_j dy_i
      + dt_j exp(after_j) hn B_j;
    - dC_i = sum_{j<=i} T_ij B_j + exp(cum_i) h_prev^T dy_i, and
      dB_j = sum_{i>=j} T_ij C_i + dt_j exp(after_j) hn^T x_j, each summed
      over the heads of a group;
    - the exponents' gradient d(cum_i): sum_j G_ij dt_j over the row less
      sum_i G_ij dt_j over the column i, plus exp(cum_i) dy_i .
      (h_prev C_i), less the state weight's dt_i exp(after_i) <hn, x_i (x)
      B_i>; the last position also takes every state weight's and
      exp(cum_last) <hn, h_prev>; d(la) is its reverse cumsum within the
      chunk, ddt = sum_i G_ij + exp(after_j) <hn, x_j (x) B_j> + d(la) A
      and dA = sum d(la) dt over the batch and the sequence."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"ssd: sequence {S} is not a multiple of the "
                         f"chunk {L}")
    nc = S // L
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc).reshape(b, nc, L, H, P)
    dyf = dy.to(acc).reshape(b, nc, L, H, P)
    dtf = dt.to(acc).reshape(b, nc, L, H)
    Bf = _per_head(Bm, H, 2).to(acc).reshape(b, nc, L, H, N)
    Cf = _per_head(Cm, H, 2).to(acc).reshape(b, nc, L, H, N)
    Af = A.to(acc)
    la = dtf * Af
    cum = torch.cumsum(la, dim=2)                            # (b,nc,L,H)
    after = torch.cat([_rev_cumsum(la, 2)[:, :, 1:],
                       torch.zeros_like(la[:, :, :1])], 2)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    dec = torch.exp(torch.where(
        mask[None, None, :, :, None],
        cum[:, :, :, None, :] - cum[:, :, None, :, :],
        torch.full((), -torch.inf, dtype=acc, device=x.device)))
    cb = torch.einsum("bkihn,bkjhn->bkijh", Cf, Bf)          # (b,nc,i,j,H)
    ecum = torch.exp(cum)
    ea = torch.exp(after)
    wgt = dtf * ea                                           # state weights

    # the forward's state before each chunk, and the reverse pass
    chunk_decay = torch.exp(cum[:, :, -1])                   # (b,nc,H)
    sbx = torch.einsum("bkjhp,bkjhn->bkhpn", xf, Bf * wgt[..., None])
    s_rev = torch.einsum("bkihp,bkihn->bkhpn", dyf * ecum[..., None], Cf)
    h = torch.zeros((b, H, P, N), dtype=acc, device=x.device)
    hp = []
    for k in range(nc):
        hp.append(h)
        h = chunk_decay[:, k, :, None, None] * h + sbx[:, k]
    g = (torch.zeros((b, H, P, N), dtype=acc, device=x.device)
         if dh is None else dh.to(acc))
    hn = [None] * nc
    for k in reversed(range(nc)):
        hn[k] = g
        g = chunk_decay[:, k, :, None, None] * g + s_rev[:, k]
    hp, hn = torch.stack(hp, 1), torch.stack(hn, 1)          # (b,nc,H,P,N)

    M = torch.einsum("bkihp,bkjhp->bkijh", dyf, xf)
    em = dec * M
    T = em * dtf[:, :, None]                                 # (b,nc,i,j,H)
    Gm = cb * em
    W = Gm * dtf[:, :, None]
    w = cb * dec * dtf[:, :, None]

    u = torch.einsum("bkhpn,bkjhp->bkjhn", hn, xf)           # hn^T x_j
    v = torch.einsum("bkhpn,bkihp->bkihn", hp, dyf)          # h_prev^T dy_i
    dx = (torch.einsum("bkijh,bkihp->bkjhp", w, dyf)
          + wgt[..., None] * torch.einsum("bkhpn,bkjhn->bkjhp", hn, Bf))
    dBh = (torch.einsum("bkijh,bkihn->bkjhn", T, Cf)
           + wgt[..., None] * u)
    dCh = (torch.einsum("bkijh,bkjhn->bkihn", T, Bf)
           + ecum[..., None] * v)

    Sd = ea * (Bf * u).sum(-1)                               # (b,nc,L,H)
    Sv = dtf * Sd
    E = ecum * (Cf * v).sum(-1)
    Dc = chunk_decay * (hn * hp).sum((-1, -2))               # (b,nc,H)
    dcum = W.sum(3) - W.sum(2) + E - Sv
    dcum[:, :, -1] += Sv.sum(2) + Dc
    dla = _rev_cumsum(dcum, 2)
    ddt = Gm.sum(2) + Sd + dla * Af
    dA = (dla * dtf).sum((0, 1, 2))

    def groups(t):
        return t.reshape(b, S, G, H // G, N).sum(3)
    return (dx.reshape(b, S, H, P).to(x.dtype), ddt.reshape(b, S, H).to(
        dt.dtype), dA.to(A.dtype), groups(dBh).to(Bm.dtype),
        groups(dCh).to(Cm.dtype))


def split3(v: torch.Tensor):
    """(hi, mid, lo) bf16 terms of fp32 ``v``, each the rounding to
    nearest of what the earlier ones leave: hi + mid + lo == v exactly
    for |v| >= 2^-110 and for 0 (below, lo may lose bits under 2^-133)."""
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _split_product(eq: str, a: torch.Tensor, b: torch.Tensor, split: int):
    """einsum(eq, a, b) with operand ``split`` (0 or 1) replaced by its
    three bf16 terms, the three products summed in fp32: what the tensor
    cores compute from an exact bf16 operand and a split fp32 one."""
    out = None
    for t in split3((a, b)[split]):
        y = torch.einsum(eq, *((t.float(), b) if split == 0 else (a, t.float())))
        out = y if out is None else out + y
    return out


def emulate_ssd_mma(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """The kernel's bf16 route in plain PyTorch, model layout as ``ssd``:
    C.B^T once per (batch, group, chunk) from the exact bf16 inputs (fp32
    sums); the weights w = C.B^T exp(cum_i - cum_j) dt_j (cum summed in
    double), the chunk states' B dt exp(sum after j) and the state before
    each chunk split into three bf16 terms (``split3``), each product of a
    term with the exact bf16 x or C summed in fp32.  Returns (y in x's
    dtype, h_final (B,H,P,N) fp32)."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    nc, rep = S // L, H // G
    xf = x.float().reshape(b, nc, L, H, P)
    dtf = dt.float().reshape(b, nc, L, H)
    Bg = Bm.float().reshape(b, nc, L, G, N)
    Cg = Cm.float().reshape(b, nc, L, G, N)
    la = dtf * A.float()
    cum = torch.cumsum(la.double(), dim=2)                   # (b,nc,L,H)
    rev = torch.flip(torch.cumsum(torch.flip(la, [2]), dim=2), [2])
    after = torch.cat([rev[:, :, 1:], torch.zeros_like(rev[:, :, :1])], 2)
    wgt = dtf * torch.exp(after)
    decay = torch.exp(cum[:, :, -1].float())                 # (b,nc,H)

    cb = torch.einsum("bkign,bkjgn->bkgij", Cg, Bg)         # once per group
    cb = cb.repeat_interleave(rep, dim=2)                    # (b,nc,H,i,j)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    dec = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).float()
    zero = torch.zeros((), device=x.device)
    dec = torch.exp(torch.where(mask[None, None, :, :, None], dec,
                                zero))                       # (b,nc,i,j,H)
    w = cb * dec.permute(0, 1, 4, 2, 3) * dtf.permute(0, 1, 3, 2)[
        :, :, :, None, :]
    w = torch.where(mask, w, zero)
    y_intra = _split_product("bkhij,bkjhp->bkihp", w, xf, 0)

    Bw = Bg.repeat_interleave(rep, dim=3) * wgt[..., None]   # (b,nc,L,H,N)
    s = _split_product("bkjhp,bkjhn->bkhpn", xf, Bw, 1)
    h = torch.zeros((b, H, P, N), device=x.device)
    prev = []
    for k in range(nc):
        prev.append(h)
        h = decay[:, k, :, None, None] * h + s[:, k]
    prev = torch.stack(prev, dim=1)                          # (b,nc,H,P,N)
    Ch = Cg.repeat_interleave(rep, dim=3)
    y_inter = (_split_product("bkihn,bkhpn->bkihp", Ch, prev, 1)
               * torch.exp(cum.float())[..., None])
    y = (y_inter + y_intra).reshape(b, S, H, P).to(x.dtype)
    return y, h


def _route_product(eq: str, a: torch.Tensor, b: torch.Tensor, route: str,
                   split=None):
    """einsum(eq, a, b) as the backward route computes it: ``mma``, with
    operand ``split`` (0 or 1) in three bf16 terms (``_split_product``)
    or, split None, both exact (one product); ``tf32x3``, both operands
    split TF32, lo.hi + hi.lo + hi.hi each summed in fp32."""
    if route == "tf32x3":
        from repro_torch.kernels.flash_attention.ref import \
            _split_product as tf32_product
        return tf32_product(eq, a, b)
    if split is None:
        return torch.einsum(eq, a, b)
    return _split_product(eq, a, b, split)


def emulate_ssd_bwd_mma(x, dt, A, Bm, Cm, dy, dh=None, *, chunk: int = 256,
                        route: str = "mma", heads_a_slice=None):
    """The backward kernel's arithmetic in plain PyTorch, with the
    arguments and results of ``ref_ssd_backward``: ``route`` "mma" (bf16
    inputs) or "tf32x3" (fp32).  The forward's states as the forward
    kernel leaves them (its mma route's split product, or fp32); cum
    summed in double, the state weights' exponent from the chunk's end;
    C.B^T once per group; M = dy x^T one exact product ("mma") or split
    TF32; e = exp(cum_i - cum_j) on j <= i, as exp(cum_i - cum_i0)
    exp(cum_i0 - cum_j) on TILE-tiles below the diagonal; T = e M dt_j, w
    = (C.B^T) e dt_j, the products with an fp32 operand split (T, w,
    exp(cum) dy, hn, h_prev; row scales wgt_j and exp(cum_i) applied after
    the product, in double, each term rounded once); per head dx = wgt
    (hn B) then += w^T dy tile by tile,
    dB += wgt u then T^T C tile by tile and dC += exp(cum) v then T B tile
    by tile, summed over ``heads_a_slice`` heads (default: the kernel's
    ``bwd_slice``) in order and the slices added in order; the row and
    column sums of (C.B^T) T and (C.B^T) e M in double, each product
    exact; ddt and dA as ``ref_ssd_backward`` in double."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    nc, rep = S // L, H // G
    if heads_a_slice is None:
        from repro_torch.kernels.ssd.kernel import bwd_slice
        heads_a_slice = bwd_slice(b, S, H, G, chunk)
    hs = heads_a_slice
    dev = x.device

    def prod(eq, a, bb, split=None):
        return _route_product(eq, a, bb, route, split)
    xf = x.float().reshape(b, nc, L, H, P)
    dyf = dy.float().reshape(b, nc, L, H, P)
    dtf = dt.float().reshape(b, nc, L, H)
    Bg = Bm.float().reshape(b, nc, L, G, N)
    Cg = Cm.float().reshape(b, nc, L, G, N)
    Bh, Ch = (t.repeat_interleave(rep, dim=3) for t in (Bg, Cg))
    la = dtf * A.float()
    cum = torch.cumsum(la.double(), dim=2)                   # (b,nc,L,H)
    rev = torch.flip(torch.cumsum(torch.flip(la, [2]), dim=2), [2])
    after = torch.cat([rev[:, :, 1:], torch.zeros_like(rev[:, :, :1])], 2)
    ea = torch.exp(after)
    wgt = dtf * ea
    ecum = torch.exp(cum.float())
    decay = torch.exp(cum[:, :, -1].float())                 # (b,nc,H)
    cb = torch.einsum("bkign,bkjgn->bkijg", Cg, Bg).repeat_interleave(
        rep, dim=4)                                          # (b,nc,i,j,H)

    # the forward kernel's states and the reverse pass
    Bw = Bh * wgt[..., None]
    sbx = (_split_product("bkjhp,bkjhn->bkhpn", xf, Bw, 1) if route == "mma"
           else torch.einsum("bkjhp,bkjhn->bkhpn", xf, Bw))
    s_rev = prod("bkihp,bkihn->bkhpn", dyf * ecum[..., None], Ch, 0)
    h = torch.zeros((b, H, P, N), device=dev)
    g = torch.zeros_like(h) if dh is None else dh.float()
    hp, hn = [], [None] * nc
    for k in range(nc):
        hp.append(h)
        h = decay[:, k, :, None, None] * h + sbx[:, k]
    for k in reversed(range(nc)):
        hn[k] = g
        g = decay[:, k, :, None, None] * g + s_rev[:, k]
    hp, hn = torch.stack(hp, 1), torch.stack(hn, 1)          # (b,nc,H,P,N)

    # the pair weights
    pos = torch.arange(L, device=dev)
    tile = pos // TILE
    keep = pos[:, None] >= pos[None, :]
    below = (tile[:, None] > tile[None, :])[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,i,j,H)
    zero = torch.zeros((), dtype=diff.dtype, device=dev)
    direct = torch.exp(torch.where(keep[None, None, :, :, None], diff,
                                   zero).float())
    c0 = cum[:, :, tile * TILE]                              # cum at i0(i)
    fa = torch.exp((cum - c0).float())                       # (b,nc,i,H)
    fb = torch.exp(torch.where(below, c0[:, :, :, None, :]
                               - cum[:, :, None, :, :], zero).float())
    e = torch.where(below, fa[:, :, :, None, :] * fb, direct)
    e = torch.where(keep[None, None, :, :, None], e, torch.zeros_like(e))
    M = prod("bkihp,bkjhp->bkijh", dyf, xf)
    em = e * M
    T = em * dtf[:, :, None]                                 # dt_j
    w = cb * e * dtf[:, :, None]
    # the sums' products exact in double
    row_w = (cb.double() * T.double()).sum(3)                # (b,nc,i,H)
    g_sum = (cb.double() * em.double()).sum(2)               # (b,nc,j,H)

    u = prod("bkhpn,bkjhp->bkjhn", hn, xf, 0)                # hn^T x_j
    v = prod("bkhpn,bkihp->bkihn", hp, dyf, 0)               # h_prev^T dy_i
    # the row scales in double, each scaled term rounded once
    ea_d = torch.exp(after.double())
    wgt_d = dtf.double() * ea_d
    ev_d = v.double() * torch.exp(cum)[..., None]
    ev = ev_d.float()
    Sd = ea_d * (u.double() * Bh.double()).sum(-1)
    Sv = dtf.double() * Sd
    E = (ev_d * Ch.double()).sum(-1)
    Dc = decay.double() * (hn * hp).sum((-1, -2)).double()

    n_t = -(-L // TILE)
    spans = [slice(t * TILE, min((t + 1) * TILE, L)) for t in range(n_t)]
    # row tile t's rows reach the keys before its end; key tile t's keys
    # the rows from its start
    reach = [(slice(0, s.stop), slice(s.start, L)) for s in spans]
    dx = (wgt_d[..., None] * prod("bkhpn,bkjhn->bkjhp", hn, Bh,
                                  0).double()).float()
    for t, s in enumerate(spans):
        keys = reach[t][0]
        dx[:, :, keys] = dx[:, :, keys] + prod(
            "bkijh,bkihp->bkjhp", w[:, :, s, keys], dyf[:, :, s], 0)
    db_tiles = [prod("bkijh,bkihn->bkjhn", T[:, :, s], Ch[:, :, s], 0)
                for s in spans]
    dc_tiles = [prod("bkijh,bkjhn->bkihn", T[:, :, :, s], Bh[:, :, s], 0)
                for s in spans]

    def slices(per_head, tiles, side):
        """Per head its state term, then each tile's product added in
        order over the positions it reaches; summed over a slice's heads
        in order, the slices added in order."""
        out = None
        for s0 in range(0, rep, hs):
            acc = torch.zeros_like(per_head[:, :, :, :G])
            for k in range(hs):
                heads = torch.arange(G, device=dev) * rep + s0 + k
                acc = acc + per_head[:, :, :, heads]
                for t in range(n_t):
                    r = reach[t][side]
                    acc[:, :, r] = acc[:, :, r] + tiles[t][:, :, r][:, :, :, heads]
            out = acc if out is None else out + acc
        return out
    dB = slices((wgt_d[..., None] * u.double()).float(), db_tiles, 0)
    dC = slices(ev, dc_tiles, 1)

    dcum = row_w - dtf.double() * g_sum + E - Sv
    dcum[:, :, -1] += Sv.sum(2) + Dc
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = (g_sum + Sd + dla * A.double()).float()
    dA = (dla * dtf.double()).sum(2).float().double().sum((0, 1)).float()
    return (dx.reshape(b, S, H, P).to(x.dtype), ddt.reshape(b, S, H),
            dA, dB.reshape(b, S, G, N).to(Bm.dtype),
            dC.reshape(b, S, G, N).to(Cm.dtype))
