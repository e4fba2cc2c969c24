"""The step functions: the train step of the trainable families (the
decoder-only ones: dense and VLM softmax attention, the mixture of
experts, Mamba-2; ``models.model.check_trainable``), the prefill and
serve steps of every family, and the concrete initializers behind
them.

* ``build_train_step(cfg, opt_cfg)``  -> f(params, opt, batch) -> (params, opt, metrics)
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

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import model as M
from repro_torch.models.model import init_params
from repro_torch.training.optimizer import OptConfig, adamw_update
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

__all__ = ["build_train_step", "build_prefill_step", "build_serve_step",
           "init_params", "init_cache", "loss_and_grads"]


def loss_and_grads(params, cfg: ModelConfig, batch):
    """(loss, parts, grads): ``lm_loss`` and the gradient of the loss with
    respect to every leaf of ``params`` (a tree of the same structure, each
    leaf in its param's dtype).  The params are not modified; the leaves
    are differentiated through detached aliases of them."""
    M.check_trainable(cfg)
    leaves = {path: p.detach().requires_grad_(True)
              for path, p in tree_leaves_with_path(params)}
    live = tree_map_with_path(lambda path, _: leaves[path], params)
    with torch.enable_grad():
        loss, parts = M.lm_loss(live, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    by_path = dict(zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_map_with_path(lambda path, _: by_path[path], params))


def build_train_step(cfg: ModelConfig, opt_cfg: OptConfig):
    """One AdamW step on ``lm_loss``: f(params, opt_state, batch) ->
    (new params, new opt state, metrics {"loss", "nll", "z_loss",
    "aux_loss", "grad_norm", "lr"}, fp32 scalar tensors).  The caller
    hands ``opt_state`` over: the step updates its moments in place
    (``adamw_update(donate_state=True)``), and the new state holds them.
    Raises at build for the families the port does not train
    (``model.check_trainable``)."""
    M.check_trainable(cfg)

    def train_step(params, opt_state, batch):
        loss, parts, grads = loss_and_grads(params, cfg, batch)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg, donate_state=True)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


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
