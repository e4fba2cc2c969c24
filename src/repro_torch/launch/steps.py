"""Step builders: the prefill and serve steps of every family, and the
concrete initializers behind them.

* ``build_prefill_step(cfg, max_len)`` -> f(params, batch) -> (logits, cache)
* ``build_serve_step(cfg)``            -> f(params, tokens, cache) -> (logits, cache)
* ``init_params(cfg, ...)``, ``init_cache(cfg, batch, max_len, device=)``

A decoder-only ``batch`` holds ``tokens`` (B, S) and, for a VLM,
``vision_feats``; an encoder-decoder's holds ``src_embeds`` (B, T, D),
the audio-frontend stub's frames, and ``tgt_tokens`` (B, S).  The
encoder-decoder's serve step donates its self-caches (each layer's new
row is written in place); the decoder-only one leaves its cache as it
was (``lm_decode_step``'s default).  Everything runs on the device of
the params and inputs given.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import model as M
from repro_torch.models.model import init_params

__all__ = ["build_prefill_step", "build_serve_step", "init_params",
           "init_cache"]


def build_prefill_step(cfg: ModelConfig, max_len: int):
    """Prompt -> (last-token logits (B, V), cache padded to ``max_len``)."""
    if cfg.encdec:
        def prefill(params, batch):
            return ED.encdec_prefill(params, cfg, batch["src_embeds"],
                                     batch["tgt_tokens"], max_len)
    else:
        def prefill(params, batch):
            return M.lm_prefill(params, cfg, batch["tokens"], max_len,
                                vision_feats=batch.get("vision_feats"))
    return prefill


def build_serve_step(cfg: ModelConfig):
    """One-token decode against an existing cache (the serving hot loop)."""
    if cfg.encdec:
        def serve(params, tokens, cache):
            return ED.encdec_decode_step(params, cfg, tokens, cache)
    else:
        def serve(params, tokens, cache):
            return M.lm_decode_step(params, cfg, tokens, cache)
    return serve


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Zero decode state of ``max_len`` positions (index ``max_len - 1``)."""
    if cfg.encdec:
        return ED.init_encdec_decode_state(cfg, batch, max_len, device)
    return M.init_decode_state(cfg, batch, max_len, device=device)
