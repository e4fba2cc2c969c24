"""The port's own copy of the reference's module.

Request slot classes for the class-partitioned TABM pool.

The single-ring TABM (core/tabm.RingBuffer) sizes every slot to one
``max_tokens`` slab, so a 1-image thumbnail request pads into the same
slab as a 4-image full-resolution request and competes with it for the
same FIFO admission depth — exactly the modality-inflation cost the
multimodal-serving literature measures (vision token count varies by
orders of magnitude across requests, decode demand does not).

This module defines the *classes* that partition the pool:

* a **resolution bucket** is a per-image token count, taken from the
  arch's config (``ModelConfig.vision_token_buckets``; falls back to one
  bucket = ``vision_tokens``) — the paper's static-shape NPU discipline
  means resolutions are already quantized to a small bucket set;
* an **image-count bucket** is 1 or ``vision_max_images`` — single-image
  chat turns vs multi-image / tiled (anyres) requests;
* a :class:`SlotClass` is one (image bucket × resolution bucket) cell,
  owning its own ring capacity (``n_slots``) and admission depth
  (``max_ahead``; ``None`` = ring capacity, the
  ``core/scheduler.staging_budget`` default).

:func:`classify` maps a request's vision spec — total token count and
image count — to the smallest class that fits it, so every request pays
for exactly the slab shape it needs.  The pool wrapper that instantiates
one :class:`~repro.core.tabm.RingBuffer` per class lives in
``core/tabm.SlotClassPool``; battery-aware per-class depth scaling is
:meth:`~repro.core.tabm.SlotClassPool.admission_table` driven by
``core/power.Knobs.class_depth_scale``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig


class SlotClassError(ValueError):
    """A vision spec that no configured slot class can hold."""


@dataclass(frozen=True)
class SlotClass:
    """One request class of the partitioned TABM pool."""

    name: str
    n_images: int              # image-count bucket (inclusive upper bound)
    tokens_per_image: int      # resolution bucket (inclusive upper bound)
    n_slots: int               # ring capacity for this class
    max_ahead: Optional[int] = None    # admission depth; None = n_slots
                                       # (staging_budget's own default)

    @property
    def max_tokens(self) -> int:
        """The class-sized slab: what one ring slot of this class holds."""
        return self.n_images * self.tokens_per_image

    @property
    def sort_key(self) -> Tuple[int, int]:
        return (self.max_tokens, self.n_images)


def resolution_buckets(cfg: ModelConfig) -> Tuple[int, ...]:
    """Per-image token counts of the arch's resolution buckets, ascending.
    Falls back to a single full-resolution bucket (``vision_tokens``)."""
    if cfg.vision_token_buckets:
        return tuple(sorted(set(cfg.vision_token_buckets)))
    return (max(1, cfg.vision_tokens),)


def image_buckets(cfg: ModelConfig) -> Tuple[int, ...]:
    """Image-count buckets: single-image, plus the arch's multi-image cap."""
    if cfg.vision_max_images <= 1:
        return (1,)
    return (1, cfg.vision_max_images)


def build_slot_classes(cfg: ModelConfig, slots_per_class: int = 2
                       ) -> Dict[str, SlotClass]:
    """The arch's class table: image buckets × resolution buckets, ordered
    smallest slab first (the ordering battery-aware depth scaling uses —
    high-resolution classes shrink first)."""
    if not cfg.vlm:
        raise SlotClassError(f"{cfg.name}: slot classes are a vlm concept")
    classes = [
        SlotClass(name=f"{ni}img-{tpi}tok", n_images=ni,
                  tokens_per_image=tpi, n_slots=max(1, slots_per_class))
        for ni in image_buckets(cfg)
        for tpi in resolution_buckets(cfg)
    ]
    classes.sort(key=lambda c: c.sort_key)
    return {c.name: c for c in classes}


def shed_scales(names_ascending, scale: float) -> Dict[str, float]:
    """Per-class effective scale factors under one battery scale in [0, 1]:
    ``names_ascending`` is the class table in ascending slab order, the
    largest class shrinks fully by ``scale``, the smallest keeps 1.0, and
    intermediate classes interpolate linearly — high-resolution sheds
    first.  This is THE shed ordering, shared by staged-ahead depth
    scaling (``core/tabm.SlotClassPool.admission_table`` driven by
    ``Knobs.class_depth_scale``) and paged-KV block budgeting
    (``core/scheduler.kv_block_budgets`` driven by
    ``Knobs.class_kv_scale``), so battery pressure degrades staging and
    decode memory in the same class order."""
    s = min(1.0, max(0.0, scale))
    names = list(names_ascending)
    K = len(names)
    return {name: 1.0 - (1.0 - s) * (rank / (K - 1) if K > 1 else 0.0)
            for rank, name in enumerate(names)}


def classify(classes: Dict[str, SlotClass], n_tokens: int,
             n_images: int = 1) -> SlotClass:
    """Map a request's vision spec to the smallest class that holds it.

    ``n_tokens`` is the request's total vision token count; the per-image
    resolution is ``ceil(n_tokens / n_images)``.  Raises
    :class:`SlotClassError` when no class fits (more images or higher
    resolution than the config declares)."""
    if n_tokens <= 0 or n_images <= 0:
        raise SlotClassError(
            f"vision spec needs positive tokens/images, got "
            f"{n_tokens} tokens x {n_images} images")
    tpi = -(-n_tokens // n_images)             # ceil division
    fits = [c for c in classes.values()
            if c.n_images >= n_images and c.tokens_per_image >= tpi
            and c.max_tokens >= n_tokens]
    if not fits:
        raise SlotClassError(
            f"no slot class holds {n_tokens} tokens across {n_images} "
            f"image(s) (per-image {tpi}); classes: "
            f"{[c.name for c in classes.values()]}")
    return min(fits, key=lambda c: c.sort_key)


def classify_total(classes: Dict[str, SlotClass], n_tokens: int) -> SlotClass:
    """Class lookup by total token count only (image count unknown — the
    synchronous ``plan.run`` path, which sees the embeds after the fact)."""
    fits = [c for c in classes.values() if c.max_tokens >= n_tokens]
    if not fits:
        raise SlotClassError(
            f"no slot class holds {n_tokens} tokens; classes: "
            f"{[c.name for c in classes.values()]}")
    return min(fits, key=lambda c: c.sort_key)
