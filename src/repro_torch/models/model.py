"""Top-level language-model API: init / forward / loss / prefill / decode
(decoder-only dense, MoE, VLM and SSM families; softmax or linear
attention; the loss trains the dense and VLM softmax-attention families,
``check_trainable``).  The cache's
``layers`` are the decoder's: ``((k, v),)`` for softmax attention,
``((state, z),)`` for linear attention, ``((conv_tail, ssd_state),)``
for Mamba-2."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QTensor, dequantize, quantize_tree
from repro_torch.models import decoder as dec
from repro_torch.models.common import (apply_mrope, apply_norm,
                                       apply_rope, default_mrope_positions,
                                       default_positions, dense_init,
                                       embed_init, init_norm)


def init_lm(cfg: ModelConfig, generator: torch.Generator, device,
            policy=None):
    """Parameters with the reference's tree, shapes and scales (torch's
    own random numbers); with a ``policy`` the layers are packed as they
    are made (``decoder.init_stack``)."""
    dt = cfg.torch_dtype
    qkv_bias = cfg.family == "vlm"          # Qwen2 uses qkv biases
    params: Dict[str, Any] = {
        "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model), dt,
                            device),
        "layers": dec.init_stack(generator, cfg, device, qkv_bias, policy,
                                 path="layers"),
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), dt, device,
            fan_in=cfg.d_model)
    if cfg.vlm:
        params["vis_proj"] = {
            "w1": dense_init(generator, (cfg.vision_feat_dim, cfg.d_model),
                             dt, device),
            "w2": dense_init(generator, (cfg.d_model, cfg.d_model), dt,
                             device),
        }
    return params


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", seed: int = 0, policy=None):
    """The port's counterpart of the reference's ``init_params``: random
    weights made on ``device`` (the card by default) from ``generator``
    (or a fresh one seeded with ``seed``); the encoder-decoder's tree
    (``encdec.init_encdec``) for ``cfg.encdec``.  With a ``policy`` (a
    ``QuantPolicy``) the result is ``quantize_tree(init_params(...),
    policy)``, bit for bit, but each group position is packed as soon as
    it is made and each stacked expert leaf one expert at a time: a
    full-width model never holds more than one sublayer dense (one
    group of Jamba is 45 G parameters; its MoE sublayer's experts alone
    19 GB in bf16)."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    with torch.no_grad():
        if cfg.encdec:
            from repro_torch.models.encdec import init_encdec
            params = init_encdec(cfg, generator, device, policy)
        else:
            params = init_lm(cfg, generator, device, policy)
        return params if policy is None else quantize_tree(params, policy)


def make_rope_fn(cfg, positions, mrope_positions=None):
    """The rotary map of q/k: ``positions`` (B, S) for RoPE,
    ``mrope_positions`` (3, B, S) for M-RoPE."""
    if cfg.rope == "none":
        return lambda t: t
    if cfg.rope == "mrope":
        return lambda t: apply_mrope(t, mrope_positions, cfg.rope_theta)
    return lambda t: apply_rope(t, positions, cfg.rope_theta, cfg.rope_frac)


def prompt_rope_fn(cfg, batch: int, seq: int, device):
    """The rotary map of a prompt at positions 0..seq-1 (M-RoPE: three
    equal text streams)."""
    mrope = (default_mrope_positions(batch, seq, device)
             if cfg.rope == "mrope" else None)
    return make_rope_fn(cfg, default_positions(batch, seq, device), mrope)


def _vocab_bias(cfg, device) -> torch.Tensor:
    """-1e30 on padded vocab rows so they never receive probability."""
    v = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(v < cfg.vocab_size, 0.0, -1e30).to(torch.float32)


def project_vision(vis_proj, cfg, feats):
    """The projector: tanh-GELU(feats @ w1) @ w2."""
    v = F.gelu(torch.einsum("bnf,fd->bnd", feats.to(cfg.torch_dtype),
                            vis_proj["w1"]), approximate="tanh")
    return torch.einsum("bnd,de->bne", v, vis_proj["w2"])


def _embed(params, cfg, tokens, vision_feats=None):
    x = params["embed"][tokens]
    if cfg.vlm and vision_feats is not None:
        v = project_vision(params["vis_proj"], cfg, vision_feats)
        x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
    return x


def _head(params, cfg, x):
    """Final norm + LM head, accumulated AND returned in fp32 (bf16 logits
    would make exact top-1 ties)."""
    x = apply_norm(params["final_norm"], x)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if isinstance(w, QTensor):
        w = dequantize(w)
    w = w.to(torch.float32)
    w = w.t() if cfg.tie_embeddings else w
    logits = torch.matmul(x.to(torch.float32), w)
    return logits + _vocab_bias(cfg, x.device)[None, None, :]


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

Z_LOSS = 1e-4
AUX_LOSS = 1e-2


def check_trainable(cfg: ModelConfig) -> None:
    """The port trains the decoder-only families: dense and VLM softmax
    attention, the mixture of experts (its load-balance aux loss and
    routing gradients as the reference's) and Mamba-2 (through the SSD
    backward kernel).  The rest raise, naming the ROADMAP item that
    queues each: hybrid groups, linear attention's backward and the
    encoder-decoder's loss."""
    why = None
    if cfg.encdec:
        why = "the encoder-decoder's loss (encdec_loss, ROADMAP 11.4e)"
    elif cfg.hybrid_group:
        why = "hybrid groups (ROADMAP 11.4d)"
    elif cfg.attn_impl != "softmax":
        why = "linear attention's backward (ROADMAP 11.4c)"
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: training is not ported for "
                                  f"{why}")


def _rope_for(cfg, batch: int, seq: int, device, mrope_positions=None):
    """A full sequence's rotary map: ``mrope_positions`` (3, B, S) where
    given, else ``prompt_rope_fn``'s."""
    if mrope_positions is None:
        return prompt_rope_fn(cfg, batch, seq, device)
    return make_rope_fn(cfg, default_positions(batch, seq, device),
                        mrope_positions)


def lm_forward(params, cfg: ModelConfig, tokens, *, vision_feats=None,
               mrope_positions=None):
    """Full-sequence logits (B, S, V) fp32 (the serving head) and aux."""
    B, S = tokens.shape
    rope_fn = _rope_for(cfg, B, S, tokens.device, mrope_positions)
    x = _embed(params, cfg, tokens, vision_feats)
    x, _, aux = dec.stack_forward(params["layers"], cfg, x, rope_fn,
                                  causal=True)
    return _head(params, cfg, x), aux


def head_loss_chunked(params, cfg: ModelConfig, x, labels, mask,
                      chunk: int = 1024):
    """Cross-entropy over the vocab without materializing (B, S, V)
    logits: the final norm, head product, log-sum-exp and true logit a
    chunk of ``chunk`` positions at a time, each chunk under
    ``torch.utils.checkpoint`` (its logits are recomputed in the
    backward).  As the reference: the logits are computed in the param
    dtype and cast to fp32, then the padded-vocab bias.  x (B,S,D);
    labels (B,S) int; mask (B,S) {0,1}.  Returns (nll_sum, z_sum, n),
    each summed over the chunks in order."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"head_loss_chunked: chunk {chunk} does not "
                         f"divide {S}")
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    bias = _vocab_bias(cfg, x.device)
    maskf = mask.to(torch.float32)

    def body(xi, li, mi):
        xi = apply_norm(params["final_norm"], xi)
        logits = torch.matmul(xi, w).to(torch.float32) + bias
        lse = torch.logsumexp(logits, dim=-1)
        true = torch.gather(logits, -1, li[..., None].long())[..., 0]
        return (torch.sum((lse - true) * mi),
                torch.sum(torch.square(lse) * mi))

    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        args = (x[:, i:i + chunk], labels[:, i:i + chunk],
                maskf[:, i:i + chunk])
        nll, z = (checkpoint(body, *args, use_reentrant=False)
                  if torch.is_grad_enabled() else body(*args))
        nll_sum = nll_sum + nll
        z_sum = z_sum + z
    return nll_sum, z_sum, torch.sum(maskf)


def lm_loss(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy + Z_LOSS z-loss + AUX_LOSS aux.  ``batch``:
    ``tokens`` (B,S) and optionally ``loss_mask`` (B,S), ``vision_feats``
    and ``mrope_positions``.  The label of position i is token i + 1; the
    last position takes no loss.  Returns (loss, {"nll", "z_loss",
    "aux_loss"})."""
    check_trainable(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    rope_fn = _rope_for(cfg, B, S, dev, batch.get("mrope_positions"))
    x = _embed(params, cfg, tokens, batch.get("vision_feats"))
    x, _, aux = dec.stack_forward(params["layers"], cfg, x, rope_fn,
                                  causal=True)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = ((torch.arange(S, device=dev) < S - 1)[None, :].to(torch.int32)
            * torch.ones((B, 1), dtype=torch.int32, device=dev))
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"].to(torch.int32)
    nll_sum, z_sum, n = head_loss_chunked(params, cfg, x, labels, mask)
    nll = nll_sum / torch.clamp(n, min=1.0)
    z = z_sum / torch.clamp(n, min=1.0)
    # a tensor aux (the MoE's) is returned as it is, with its graph
    aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
    loss = nll + Z_LOSS * z + AUX_LOSS * aux
    return loss, {"nll": nll, "z_loss": z, "aux_loss": aux}


def lm_prefill(params, cfg: ModelConfig, tokens, max_len: int, *,
               vision_feats=None, mrope_positions=None, valid_len=None):
    """Run the prompt; caches padded to ``max_len``.  Returns
    (last-token logits (B, V), cache).  M-RoPE configs default to three
    equal text position streams.  ``valid_len`` (B,), as the engine
    passes it: an MoE routes in masked groups (``moe.apply_moe(valid=)``),
    as the engine's prefill does; None: the reference's routing."""
    B, S = tokens.shape
    rope_fn = _rope_for(cfg, B, S, tokens.device, mrope_positions)
    x = _embed(params, cfg, tokens, vision_feats)
    x, caches, _ = dec.stack_forward(params["layers"], cfg, x, rope_fn,
                                     causal=True, want_cache=True,
                                     decode_len=max_len,
                                     valid_len=valid_len)
    logits = _head(params, cfg, x[:, -1:])
    return logits[:, 0], {"layers": caches,
                          "index": torch.tensor(S, dtype=torch.int32,
                                                device=tokens.device)}


def decode_positions(index, batch: int, device) -> torch.Tensor:
    index = torch.as_tensor(index, device=device)
    if index.dim() == 0:
        return index.reshape(1, 1).expand(batch, 1).to(torch.int32)
    return index[:, None].to(torch.int32)


def decode_rope_fn(cfg, positions):
    """The rotary map of one decode step: M-RoPE repeats the (B, 1)
    positions on all three streams."""
    mrope = (torch.stack([positions] * 3) if cfg.rope == "mrope" else None)
    return make_rope_fn(cfg, positions, mrope)


def lm_decode_step(params, cfg: ModelConfig, tokens, cache, *,
                   donate: bool = False, valid=None):
    """One decode step: tokens (B,1) -> (logits (B,V), new cache).
    ``cache["index"]`` is a scalar or a (B,) vector of per-row lengths.
    ``donate`` hands the softmax caches over to be written in place
    (``decoder.stack_decode``); the default leaves them unmodified.
    ``valid`` (B,) bool: the rows that take part in the MoE's routing
    (None: all)."""
    B = tokens.shape[0]
    index = torch.as_tensor(cache["index"], device=tokens.device)
    rope_fn = decode_rope_fn(cfg, decode_positions(index, B, tokens.device))
    x = _embed(params, cfg, tokens)
    x, new_caches = dec.stack_decode(params["layers"], cfg, x,
                                     cache["layers"], index, rope_fn,
                                     donate=donate, valid=valid)
    logits = _head(params, cfg, x)
    return logits[:, 0], {"layers": new_caches, "index": index + 1}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      start_index: Optional[int] = None, device="cuda"):
    """Cache for a decode-only entry: zero caches of ``max_len`` positions
    (softmax attention) or zero state (linear attention, Mamba-2), index
    ``max_len - 1`` unless ``start_index`` is given."""
    idx = max_len - 1 if start_index is None else start_index
    return {"layers": dec.init_cache(cfg, batch, max_len, device),
            "index": torch.tensor(idx, dtype=torch.int32,
                                  device=torch.device(device))}


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count, the reference's formula for every
    layout (dense, MoE, SSM, hybrid groups, encoder-decoder), the MoE's
    routed experts counted at ``top_k`` with ``active_only`` (the
    parameters a token touches)."""
    D, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    total = 0
    for pos in range(dec.group_size(cfg)):
        mixer, ffn = dec.sublayer_spec(cfg, pos)
        if mixer == "attn":
            total += D * hd * (H + 2 * KV) + H * hd * D
        else:
            s = cfg.ssm
            d_inner = s.expand * D
            ch = d_inner + 2 * s.n_groups * s.d_state
            Hm = d_inner // s.head_dim
            total += (D * (2 * d_inner + 2 * s.n_groups * s.d_state + Hm)
                      + s.d_conv * ch + ch + 3 * Hm + d_inner + d_inner * D)
        if ffn == "mlp":
            n_mats = 3 if cfg.act in ("swiglu", "geglu") else 2
            total += n_mats * D * cfg.d_ff
        elif ffn == "moe":
            m = cfg.moe
            E = m.top_k if active_only else m.n_experts
            total += D * m.n_experts                  # router (always dense)
            total += E * 3 * D * m.d_ff_expert
            if m.n_shared:
                total += 3 * D * (m.d_ff_shared or m.d_ff_expert * m.n_shared)
        total += 2 * D                                # norms
    total *= cfg.n_layers // dec.group_size(cfg)
    total += cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
    if cfg.vlm:
        total += cfg.vision_feat_dim * D + D * D
    if cfg.encdec:
        enc_layer = (D * hd * (H + 2 * KV) + H * hd * D
                     + 2 * D * cfg.d_ff + 2 * D)
        cross = D * hd * (H + 2 * KV) + H * hd * D + D
        total += cfg.n_enc_layers * enc_layer + cfg.n_layers * cross
    return int(total)
