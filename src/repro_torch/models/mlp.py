"""Dense FFN variants: SwiGLU / GeGLU (gated) and squared-ReLU / GELU."""
from __future__ import annotations

import torch

from repro_torch.kernels.dequant_gemm import ops as dg
from repro_torch.models.common import activation, dense_init

GATED = {"swiglu": "silu", "geglu": "gelu"}


def init_mlp(generator, cfg, d_model: int, d_ff: int, device, lead=()):
    dt = cfg.torch_dtype
    lead = tuple(lead)
    p = {"w_up": dense_init(generator, lead + (d_model, d_ff), dt, device,
                            fan_in=d_model),
         "w_down": dense_init(generator, lead + (d_ff, d_model), dt, device,
                              fan_in=d_ff)}
    if cfg.act in GATED:
        p["w_gate"] = dense_init(generator, lead + (d_model, d_ff), dt,
                                 device, fan_in=d_model)
    return p


def apply_mlp(p, act: str, x):
    """``act`` is the config's activation name (``cfg.act``).  Packed
    weights go through the packed-weight GEMM; the activation and the
    gate's product stay outside it, as on dense weights."""
    up = dg.quant_einsum("bsd,df->bsf", x, p["w_up"])
    if "w_gate" in p:
        gate = dg.quant_einsum("bsd,df->bsf", x, p["w_gate"])
        h = activation(GATED[act])(gate) * up
    else:
        h = activation(act)(up)
    return dg.quant_einsum("bsf,fd->bsd", h, p["w_down"])
