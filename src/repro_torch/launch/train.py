"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 50 --batch 8 --seq 256 [--full] [--ckpt-dir ckpts/] \
        [--grad-accum 2] [--device cpu]

Without ``--full`` the arch's reduced config trains (the same family at
CPU-test widths); ``--full`` trains the published widths and depth, on
the card by default (``--device``, default ``cuda``).  The decoder-only
families train (``models.model.check_trainable``): dense and VLM softmax
attention, the mixture of experts (its load-balance aux loss in the
loss) and Mamba-2 (the SSD's forward and backward kernels on the card);
hybrid groups, linear attention and the encoder-decoder raise.  A config
with ``attn_q_chunk=0`` runs attention's forward and backward through the
flash kernels on the card (``chip_smoke.py`` phase 11 trains
LLaVA-OneVision-0.5B so, phase 12 DeepSeek-MoE-16B at 4 layers, phase 13
Mamba-2-1.3B).  ``--arch deepseek-moe-16b --full`` does not fit one
80 GB card: its 28 layers are 16.9 B parameters, ~203 GB at bf16 weights
and gradients plus fp32 AdamW moments (12 bytes a parameter), before any
activation.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, list_archs
from repro_torch.data import multimodal_batch_iter
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import TrainConfig, fit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="use the full (published) config, not the reduced")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    data = multimodal_batch_iter(cfg, args.batch, args.seq)
    opt = OptConfig(lr=args.lr, warmup_steps=max(1, args.steps // 10),
                    total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       grad_accum=args.grad_accum)
    res = fit(cfg, opt, tcfg, data, device=args.device)
    losses = [m["loss"] for m in res.metrics_history]
    print(f"[train] {args.arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"over {len(losses)} steps")


if __name__ == "__main__":
    main()
