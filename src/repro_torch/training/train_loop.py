"""The train loop on one card: the train step with microbatch
accumulation, checkpoints every N steps (written in the background),
restore and resume from the latest step, a step-time tracker and the
recovery log.

``fit`` is the entry the train launcher uses: the reference's ``fit``
with the device in place of the mesh (the reference's explicit-DP step,
``build_ddp_train_step``, and its meshes are not ported: one H100).
Batches come from the data pipeline as numpy arrays and go to the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed.fault_tolerance import (RecoveryLog,
                                                     StragglerMitigator)
from repro_torch.launch import steps as st
from repro_torch.models.model import check_trainable
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt
from repro_torch.tree import tree_map


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (int32 tokens, fp32 feats)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def build_accum_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                           grad_accum: int = 1):
    """The train step with microbatch accumulation: the batch's leading
    dim (A * B) is split into A microbatches run in order, their gradients
    summed in fp32 (each divided by A) and cast to each param's dtype, the
    loss averaged likewise; metrics then hold no loss parts.  As
    ``build_train_step``, the step updates the optimizer's moments in
    place."""
    check_trainable(cfg)
    if grad_accum == 1:
        return st.build_train_step(cfg, opt_cfg)

    def train_step(params, opt_state, batch):
        micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                              *v.shape[1:]) for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        for a in range(grad_accum):
            loss, _, g = st.loss_and_grads(
                params, cfg, {k: v[a] for k, v in micro.items()})
            acc = tree_map(lambda s, gg: s + gg.to(torch.float32) / grad_accum,
                           acc, g)
            loss_acc = loss_acc + loss / grad_accum
            del g
        grads = tree_map(lambda p, g: g.to(p.dtype), params, acc)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg, donate_state=True)
        return params, opt_state, {"loss": loss_acc, **om}

    return train_step


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    grad_accum: int = 1
    log_every: int = 10


@dataclass
class TrainResult:
    final_step: int
    metrics_history: list
    recovery: RecoveryLog


def fit(cfg: ModelConfig, opt_cfg: OptConfig, tcfg: TrainConfig,
        data_iter: Iterator[Dict[str, np.ndarray]], params=None,
        log: Callable[[str], None] = print, device="cuda") -> TrainResult:
    """Train ``tcfg.steps`` steps on ``device``.  Params default to the
    port's ``init_params(cfg, seed 0)`` on the device; with a
    ``ckpt_dir`` holding a checkpoint, params and optimizer state are
    restored from its latest step and training resumes there (the data
    iterator is the caller's: seek it to match).  Each step's metrics go
    to the history as floats, with the step's wall seconds as ``dt``.
    The optimizer state is fit's own, its moments updated in place each
    step; the caller's params are left as they were."""
    check_trainable(cfg)
    device = torch.device(device)
    recovery = RecoveryLog()
    straggler = StragglerMitigator(n_workers=1)

    if params is None:
        params = st.init_params(cfg, device=device, seed=0)
    opt_state = init_opt(params, opt_cfg)
    start_step = 0

    checkpointer = None
    if tcfg.ckpt_dir:
        checkpointer = ckpt_lib.AsyncCheckpointer(tcfg.ckpt_dir, tcfg.keep)
        if ckpt_lib.latest_step(tcfg.ckpt_dir) is not None:
            state, start_step, _ = ckpt_lib.restore(
                tcfg.ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            recovery.record("restore", step=start_step)
            log(f"[fit] restored step {start_step} from {tcfg.ckpt_dir}")

    step_fn = build_accum_train_step(cfg, opt_cfg, tcfg.grad_accum)
    history = []
    for step in range(start_step, tcfg.steps):
        batch = batch_to(next(data_iter), device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        straggler.record(0, dt)
        history.append({"step": step + 1, "dt": dt, **metrics})
        if (step + 1) % tcfg.log_every == 0:
            log(f"[fit] step {step + 1} loss={metrics['loss']:.4f} "
                f"gnorm={metrics.get('grad_norm', 0):.3f} dt={dt:.2f}s")
        if checkpointer and (step + 1) % tcfg.ckpt_every == 0:
            checkpointer.save_async(step + 1,
                                    {"params": params, "opt": opt_state})
            recovery.record("checkpoint", step=step + 1)
    if checkpointer:
        checkpointer.wait()
    return TrainResult(tcfg.steps, history, recovery)
