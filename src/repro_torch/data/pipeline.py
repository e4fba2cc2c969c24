"""Data pipeline: synthetic corpora -> packing -> sharded host batches
(the port's own copy of the reference's numpy pipeline: the same seed
gives the same stream, bit for bit).

Everything is deterministic in (seed, host_id) so a restarted / re-meshed
job replays the same stream from a step counter — the data-side half of
fault tolerance (a restarted job seeks its loader to the restored step;
this module guarantees the stream is reproducible across it).

Synthetic documents use a Zipf unigram model with EOS-terminated variable
lengths — enough structure for loss curves to move and packing code paths
(document boundaries, loss masks) to be exercised for real.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_documents(seed: int, vocab_size: int, mean_len: int = 512,
                        eos_id: int = 1) -> Iterator[np.ndarray]:
    """Endless stream of variable-length token documents (Zipf unigrams)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    while True:
        n = max(8, int(rng.exponential(mean_len)))
        doc = rng.choice(ranks, size=n, p=probs).astype(np.int32)
        doc[-1] = eos_id
        yield doc


@dataclass
class PackedLMDataset:
    """Packs documents into fixed (seq_len,) rows with loss masks.

    Fixed shapes are a *feature*, not a limitation: the paper's NPU section
    makes the same choice (pre-resize all inputs; never recompile)."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    eos_id: int = 1

    def __post_init__(self):
        self._docs = synthetic_documents(self.seed, self.vocab_size,
                                         eos_id=self.eos_id)
        self._buf = np.empty((0,), np.int32)

    def next_row(self) -> Dict[str, np.ndarray]:
        while self._buf.shape[0] < self.seq_len + 1:
            self._buf = np.concatenate([self._buf, next(self._docs)])
        row = self._buf[: self.seq_len]
        self._buf = self._buf[self.seq_len:]
        mask = (row != self.eos_id).astype(np.int32)
        return {"tokens": row.copy(), "loss_mask": mask}


@dataclass
class ShardedLoader:
    """Per-host batch loader: host h of H draws rows [h::H] of the global
    batch, so the concatenation across hosts is the deterministic global
    stream regardless of topology."""

    dataset: PackedLMDataset
    global_batch: int
    host_id: int = 0
    n_hosts: int = 1
    step: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def seek(self, step: int):
        """Replay determinism: rebuild the stream and skip to `step`."""
        self.dataset.__post_init__()
        self.step = 0
        for _ in range(step * self.global_batch):
            self.dataset.next_row()
        self.step = step

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rows = []
        for i in range(self.global_batch):
            row = self.dataset.next_row()
            if i % self.n_hosts == self.host_id:
                rows.append(row)
        self.step += 1
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def multimodal_batch_iter(cfg, global_batch: int, seq_len: int,
                          seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Adds the stub modality frontends' outputs (precomputed patch/frame
    embeddings per the assignment) to the token stream."""
    ds = PackedLMDataset(cfg.vocab_size, seq_len, seed=seed)
    loader = ShardedLoader(ds, global_batch)
    rng = np.random.default_rng(seed + 1)
    for batch in loader:
        if cfg.vlm:
            batch["vision_feats"] = rng.standard_normal(
                (global_batch, cfg.vision_tokens, cfg.vision_feat_dim)
            ).astype(np.float32) * 0.02
        if cfg.encdec:
            batch["src_embeds"] = rng.standard_normal(
                (global_batch, seq_len, cfg.d_model)).astype(np.float32) * 0.02
            batch["tgt_tokens"] = batch.pop("tokens")
            batch.pop("loss_mask", None)
        yield batch
