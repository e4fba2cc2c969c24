"""Token sampling: greedy / temperature / top-k / top-p."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator, *,
           temperature: float = 1.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32, drawn with ``generator`` (on
    the logits' device).  The reference's ``jax.random`` draws differ, so
    the two agree in distribution only."""
    logits = logits.to(torch.float32) / max(float(temperature), 1e-4)
    if top_k:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1)
        cutoff = torch.gather(sorted_l, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
