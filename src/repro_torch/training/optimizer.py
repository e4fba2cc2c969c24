"""AdamW, the reference's arithmetic in PyTorch (no ``torch.optim``).

* moments in ``state_dtype`` (float32, the default, or bfloat16);
* global-norm clipping, decoupled weight decay added to the update
  (``new_p = p - lr (adam + wd p)``, in fp32, cast back to the param's
  dtype), cosine / linear / constant schedules with linear warm-up;
* the decay mask on each leaf's path string: norms, scales, biases and
  Mamba-2's ``A_log``, ``dt_bias`` and ``D`` take no decay.

``torch.optim.AdamW`` is not this function: it scales the parameter by
``1 - lr wd`` before the Adam step (another rounding order) and has no
path mask.  The state is ``{"m": tree, "v": tree, "step": int32
scalar}``; the schedule and the bias corrections run in fp32, as the
reference's do.  ``adamw_update`` returns new trees and leaves its
inputs as they were, unless the caller donates the state
(``donate_state``: the moments are then updated in place).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.tree import tree_leaves, tree_leaves_with_path, \
    tree_map, tree_map_with_path


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"       # float32 | bfloat16
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"           # cosine | linear | constant
    min_lr_frac: float = 0.1


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (int or int tensor), an fp32 scalar
    tensor.  Python-float constants fold in double and meet the fp32 step
    as fp32 scalars, in the reference's order of operations."""
    step = _f32(step)
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1.0, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (1 - t)
    else:
        decay = _f32(1.0)
    return cfg.lr * warm * decay


def init_opt(params, cfg: OptConfig) -> Dict:
    """Zero moments in ``cfg.state_dtype`` on each leaf's device; step 0."""
    dt = torch_dtype(cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


_DECAY_EXEMPT = ("norm", "scale", "bias", "A_log", "dt_bias", "/D")


def _decay_mask(path: str) -> bool:
    """True if the leaf at ``path`` (``tree.key_path``'s string) decays."""
    return not any(t in path for t in _DECAY_EXEMPT)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig,
                 lr_override: Optional[torch.Tensor] = None,
                 donate_state: bool = False):
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    ``metrics`` {"grad_norm", "lr"} as fp32 scalar tensors.  With
    ``donate_state`` the caller hands over ``state``: each moment is
    written into its own tensor in place, which the new state holds (the
    same bits; a large model's step then holds one set of moments, not
    two: ``train_loop.fit`` owns its state and donates it)."""
    step = state["step"] + 1
    lr = (schedule_lr(cfg, step.cpu()) if lr_override is None
          else _f32(lr_override))
    b1, b2 = cfg.betas
    gnorm = global_norm(grads)
    dev = gnorm.device
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    stepf = step.to(torch.float32).cpu()
    bc1 = (1 - torch.pow(_f32(b1), stepf)).to(dev)
    bc2 = (1 - torch.pow(_f32(b2), stepf)).to(dev)
    lr_d = lr.to(dev)

    g_of = dict(tree_leaves_with_path(grads))
    m_of = dict(tree_leaves_with_path(state["m"]))
    v_of = dict(tree_leaves_with_path(state["v"]))
    out = {}
    for path, p in tree_leaves_with_path(params):
        g, m, v = g_of[path], m_of[path], v_of[path]
        gf = g.to(torch.float32) * clip
        mf = b1 * m.to(torch.float32) + (1 - b1) * gf
        vf = b2 * v.to(torch.float32) + (1 - b2) * torch.square(gf)
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path):
            update = update + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr_d * update).to(p.dtype)
        if donate_state:
            m.copy_(mf)                         # the rounding of .to()
            v.copy_(vf)
            mf, vf = m, v
        out[path] = (new_p, mf.to(m.dtype), vf.to(v.dtype))
        del gf, mf, vf, update
    pick = lambda i: tree_map_with_path(lambda path, _: out[path][i], params)
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}
