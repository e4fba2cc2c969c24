"""Plain PyTorch versions of the SSD kernel: the port's ``ssd_chunked``
(the function the kernel computes, all arithmetic in fp32) and
``ssd_reference``, the sequential recurrence, as its oracle.

The wrapper in ``ops.py`` runs ``ref_ssd_chunked`` for CPU tensors; the
tests hold both against the reference package, and the card's checks
hold the kernel against ``ref_ssd_chunked``.  ``split3`` and
``emulate_ssd_mma`` repeat the arithmetic of the kernel's bf16 ("mma")
route, for the tests to hold it against the reference.
"""
from __future__ import annotations

import torch

from repro_torch.models.mamba2 import ssd_chunked as ref_ssd_chunked
from repro_torch.models.mamba2 import ssd_reference as ref_ssd

__all__ = ["ref_ssd", "ref_ssd_chunked", "split3", "emulate_ssd_mma"]


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
