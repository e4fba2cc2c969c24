"""Model decomposition into "bricks" (paper §3.1).

A :class:`Brick` is one independently executable module of the model: it
owns a subset of the parameter tree, exposes ``apply(params_slice, cfg,
ctx)`` over named ports, and carries the metadata the scheduler reads.
``decompose(cfg)`` builds the chain for every arch::

    vlm:    vision_frontend* -> projector -> embedding -> decoder -> head
    audio:  audio_frontend* -> audio_encoder -> embedding -> decoder -> head
    lm:     embedding -> decoder -> head        (*frontends are stubs)

The audio chain's decoder takes the target's hidden states and the
encoder's ``enc_out``, which the plan keeps bound across the embedding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class Port:
    """A typed dataflow endpoint: ``dtype_kind`` "float" | "int";
    ``optional`` ports may be absent (a text-only request has no
    ``vision_embeds``)."""

    name: str
    dtype_kind: str = "float"
    optional: bool = False


@dataclass(frozen=True)
class Brick:
    """One independently executable module."""

    name: str
    kind: str                       # frontend | encoder | projector | embed
                                    # | decoder | head
    param_keys: Tuple[str, ...]
    apply: Callable                 # (params_slice, cfg, ctx) -> tensor
    in_ports: Tuple[Port, ...] = ()
    out_port: Port = Port("out")
    static_shape: bool = False
    quant_label: str = "bf16"
    flops_per_token: float = 0.0
    param_bytes: int = 0

    def params_of(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return {k: params[k] for k in self.param_keys if k in params}


@dataclass
class BrickGraph:
    """Linear chain of bricks."""

    cfg: ModelConfig
    bricks: List[Brick]

    def brick(self, name: str) -> Brick:
        for b in self.bricks:
            if b.name == name:
                return b
        raise KeyError(name)

    def names(self) -> List[str]:
        return [b.name for b in self.bricks]


# ---------------------------------------------------------------------------
# brick apply functions (thin wrappers over the model substrate)
# ---------------------------------------------------------------------------

def _apply_vision_frontend(p, cfg, ctx):
    # stub: requests carry precomputed patch features
    return ctx["vision_feats"]


def _apply_projector(p, cfg, ctx):
    from repro_torch.models.model import project_vision
    return project_vision(p["vis_proj"], cfg, ctx["patches"])


def _apply_embed(p, cfg, ctx):
    x = p["embed"][ctx["tgt_tokens"] if cfg.encdec else ctx["tokens"]]
    vision_embeds = ctx.get("vision_embeds")
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype),
                       x[:, vision_embeds.shape[1]:]], dim=1)
    return x


def _apply_decoder(p, cfg, ctx):
    from repro_torch.models import decoder as dec
    from repro_torch.models.model import prompt_rope_fn
    x = ctx["hidden"]
    B, S, _ = x.shape
    rope_fn = prompt_rope_fn(cfg, B, S, x.device)
    x, _, _ = dec.stack_forward(p["layers"], cfg, x, rope_fn, causal=True)
    return x


def _apply_encdec_decoder(p, cfg, ctx):
    """The encoder-decoder's decoder layers over the target's hidden
    states against ``enc_out``; packed projections go to the packed-weight
    GEMM as they are."""
    from repro_torch.models.encdec import decode_layers
    return decode_layers(p["dec_layers"], cfg, ctx["hidden"],
                         ctx["enc_out"])[0]


def _apply_head(p, cfg, ctx):
    from repro_torch.models.model import _head
    return _head(p, cfg, ctx["hidden"])


def _apply_audio_frontend(p, cfg, ctx):
    # stub: requests carry precomputed frame embeddings
    return ctx["src_embeds"]


def _apply_audio_encoder(p, cfg, ctx):
    from repro_torch.models.encdec import encode
    return encode(p, cfg, ctx["audio_frames"])


def _brick_flops(cfg: ModelConfig, kind: str) -> float:
    """Per-token matmul FLOPs (2 * params touched: an MoE's routed
    experts at ``top_k``), the reference's scheduler cost input."""
    from repro_torch.models.model import count_params_analytic
    n = count_params_analytic(cfg, active_only=True)
    emb = cfg.padded_vocab * cfg.d_model
    body = n - emb * (1 if cfg.tie_embeddings else 2)
    return {"embed": 0.0,
            "head": 2.0 * emb,
            "decoder": 2.0 * body,
            "projector": 2.0 * (cfg.vision_feat_dim * cfg.d_model
                                + cfg.d_model * cfg.d_model),
            "encoder": 2.0 * body * (cfg.n_enc_layers
                                     / max(1, cfg.n_layers)),
            "frontend": 0.0}.get(kind, 0.0)


def decompose(cfg: ModelConfig) -> BrickGraph:
    """The paper's model decomposition for any arch."""
    bricks: List[Brick] = []

    def add(name, kind, keys, fn, ins, out, static=False, quant="bf16"):
        bricks.append(Brick(name, kind, tuple(keys), fn,
                            in_ports=tuple(ins), out_port=out,
                            static_shape=static, quant_label=quant,
                            flops_per_token=_brick_flops(cfg, kind)))

    if cfg.vlm:
        add("vision_frontend", "frontend", (), _apply_vision_frontend,
            ins=(Port("vision_feats"),), out=Port("patches"),
            static=True, quant="fp16")
        add("projector", "projector", ("vis_proj",), _apply_projector,
            ins=(Port("patches"),), out=Port("vision_embeds"),
            static=True, quant="fp16")
    if cfg.encdec:
        add("audio_frontend", "frontend", (), _apply_audio_frontend,
            ins=(Port("src_embeds"),), out=Port("audio_frames"),
            static=True, quant="fp16")
        add("audio_encoder", "encoder",
            ("enc_layers", "enc_final_norm"), _apply_audio_encoder,
            ins=(Port("audio_frames"),), out=Port("enc_out"),
            static=True, quant="fp16")
    embed_ins = [Port("tgt_tokens" if cfg.encdec else "tokens", "int")]
    if cfg.vlm:
        embed_ins.append(Port("vision_embeds", optional=True))
    add("embedding", "embed", ("embed",), _apply_embed,
        ins=embed_ins, out=Port("hidden"), quant="fp16")
    if cfg.encdec:
        add("decoder", "decoder", ("dec_layers",), _apply_encdec_decoder,
            ins=(Port("hidden"), Port("enc_out")), out=Port("hidden"),
            quant="q4f16")
    else:
        add("decoder", "decoder", ("layers",), _apply_decoder,
            ins=(Port("hidden"),), out=Port("hidden"), quant="q4f16")
    head_keys = ["final_norm", "embed" if cfg.tie_embeddings else "lm_head"]
    add("head", "head", head_keys, _apply_head,
        ins=(Port("hidden"),), out=Port("logits"), quant="q4f16")
    return BrickGraph(cfg, bricks)


def brick_param_bytes(graph: BrickGraph, params) -> Dict[str, int]:
    """Actual per-brick weight bytes (after any quantization); a table
    two bricks share (tied embeddings) counts in both."""
    from repro_torch.core.quantize import tree_bytes
    return {b.name: tree_bytes(b.params_of(params)) for b in graph.bricks}
