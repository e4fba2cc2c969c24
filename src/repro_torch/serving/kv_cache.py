"""Block-paged KV cache for continuous batching.

Attention K/V live as fixed-size blocks ``(L, n_blocks, block_size, KV,
hd)`` (``L``: the stack's groups, ``decoder.n_groups``, one entry a group
position); every admitted request owns a block table (host-side list of
granted block ids) and decode gathers its context through it.  Mamba-2
state (conv tail + SSD state) and linear-attention state (the running
summary and normalizer) have no length axis: they are fixed-size per
request, so those group positions stay slot-indexed, leaves ``(L,
n_slots, ...)``, and a config with no paged position has no block
pool.  Admission grants a request the blocks its lifetime needs,
charged per slot class, and retirement returns them to the free deque
at once.  Padded cohort rows carry the out-of-range sentinels slot
``n_slots`` and block ``n_blocks``: gathers read zeros for them and
scatters drop them.

Prefilled caches land with ONE in-place indexed write per leaf
(``insert_many``): into the granted blocks (attention) or by slot
(slot state).  The disaggregation seam pulls one request's written
blocks (or its slot-state row) off the card for the wire
(``export_blocks``) and lands such a payload in another pool
(``import_blocks``) by the same in-place writes, so a pool that a cohort
graph captured keeps its addresses.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder as dec


def paged_positions(cfg: ModelConfig) -> Tuple[bool, ...]:
    """Which group positions carry a length-indexed attention K/V cache —
    the positions the pool blocks.  Mamba-2 and linear-attention state is
    fixed-size per request, so it stays slot-indexed."""
    dec.check_supported(cfg)
    return tuple(dec.mixer_of(cfg, pos) == "attn"
                 for pos in range(dec.group_size(cfg)))


def _insert_blocks(pool_leaf: torch.Tensor, batch_leaf: torch.Tensor,
                   block_ids: torch.Tensor, block_size: int):
    """In place: a batch-K prefilled leaf (L, K, S, ...) with S =
    nb*block_size lands in each request's granted blocks — ``block_ids``
    (K, nb) — of the (L, n_blocks, block_size, ...) pool.  Sentinel ids
    (>= n_blocks) are dropped."""
    L, K, S = batch_leaf.shape[:3]
    nb = S // block_size
    resh = batch_leaf.reshape((L, K * nb, block_size)
                              + tuple(batch_leaf.shape[3:]))
    ids = block_ids.reshape(-1).to(torch.long)
    ok = ids < pool_leaf.shape[1]
    pool_leaf[:, ids[ok]] = resh[:, ok].to(pool_leaf.dtype)


def _insert_slots(pool_leaf: torch.Tensor, batch_leaf: torch.Tensor,
                  slots: torch.Tensor):
    """In place: a batch-K slot-state leaf (L, K, ...) lands in rows
    ``slots`` of the (L, n_slots, ...) pool."""
    pool_leaf[:, slots.to(torch.long)] = batch_leaf.to(pool_leaf.dtype)


class PagedKVCache:
    """Block-paged decode state: the device pools plus the host-side block
    allocator (free deques, per-request block tables, per-class block
    accounting, per-slot lengths as a host numpy vector).

    One pool entry per group position (``paged_positions``): paged
    attention leaves ``(L, n_blocks, block_size, KV, hd)``, slot-state
    leaves ``(L, n_slots, ...)`` as ``decoder.init_cache`` builds them."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 block_size: int = 64, total_blocks: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.device = torch.device(device)
        self.paged = paged_positions(cfg)
        # with no paged position (Mamba-2, linear attention) a request
        # needs no block: the pool has none, and admission grants empty
        # tables
        self.blocks_per_slot = (-(-max_len // block_size)
                                if any(self.paged) else 0)
        self.n_blocks = (n_slots * self.blocks_per_slot
                         if total_blocks is None else int(total_blocks))
        pool = []
        for pos, paged in enumerate(self.paged):
            if paged:
                shape = (dec.n_groups(cfg), self.n_blocks, block_size,
                         cfg.n_kv_heads, cfg.hd)
                pool.append(tuple(
                    torch.zeros(shape, dtype=cfg.torch_dtype,
                                device=self.device) for _ in range(2)))
            else:
                pool.append(dec.init_cache(cfg, n_slots, max_len,
                                           self.device)[pos])
        self.pool: Tuple[Tuple[torch.Tensor, torch.Tensor], ...] = tuple(pool)
        self.free: Deque[int] = deque(range(n_slots))
        self.free_blocks: Deque[int] = deque(range(self.n_blocks))
        self.block_tables: Dict[int, List[int]] = {}
        self.slot_class_of: Dict[int, Optional[str]] = {}
        self.used_blocks: Dict[Optional[str], int] = {}
        self.lengths = np.zeros((n_slots,), np.int32)

    # -- admission ----------------------------------------------------------
    @property
    def free_block_count(self) -> int:
        return len(self.free_blocks)

    def take_slot(self) -> Optional[int]:
        return self.free.popleft() if self.free else None

    def grant_blocks(self, slot: int, n: int,
                     slot_class: Optional[str] = None) -> List[int]:
        """Grant ``n`` blocks to ``slot``, charged to ``slot_class``; an
        unfulfillable or double grant raises."""
        if slot in self.block_tables:
            raise RuntimeError(f"slot {slot} already holds a block grant")
        if n > len(self.free_blocks):
            raise RuntimeError(
                f"grant of {n} blocks with only {len(self.free_blocks)} "
                f"free (admission must check first)")
        blocks = [self.free_blocks.popleft() for _ in range(n)]
        self.block_tables[slot] = blocks
        self.slot_class_of[slot] = slot_class
        self.used_blocks[slot_class] = \
            self.used_blocks.get(slot_class, 0) + n
        return blocks

    def insert_many(self, slots: List[int], prefill_cache,
                    prompt_lens: List[int]):
        """Land a batch-K prefilled cache, one indexed write per leaf:
        attention leaves — prefilled at a block-aligned width S =
        nb*block_size — in each request's first nb granted blocks;
        slot-state leaves by slot."""
        layers = prefill_cache["layers"]
        bs = self.block_size
        idx = torch.tensor(slots, dtype=torch.int32, device=self.device)
        ids = None
        for pos, paged in enumerate(self.paged):
            if not paged:
                for pool_leaf, leaf in zip(self.pool[pos], layers[pos]):
                    _insert_slots(pool_leaf, leaf, idx)
                continue
            if ids is None:
                S = layers[pos][0].shape[2]
                if S % bs:
                    raise RuntimeError(f"prefill width {S} is not "
                                       f"block-aligned (block_size {bs})")
                nb = S // bs
                host = np.full((len(slots), nb), self.n_blocks, np.int32)
                for b, slot in enumerate(slots):
                    tbl = self.block_tables.get(slot, [])
                    if len(tbl) < nb:
                        raise RuntimeError(f"slot {slot} holds {len(tbl)} "
                                           f"blocks, prefill needs {nb}")
                    host[b] = tbl[:nb]
                ids = torch.from_numpy(host).to(self.device)
            for pool_leaf, leaf in zip(self.pool[pos], layers[pos]):
                _insert_blocks(pool_leaf, leaf, ids, bs)
        for slot, n in zip(slots, prompt_lens):
            self.lengths[slot] = int(n)

    def release(self, slot: int):
        """Retire a request: its blocks return to the free deque now."""
        blocks = self.block_tables.pop(slot, None)
        cls = self.slot_class_of.pop(slot, None)
        if blocks:
            self.used_blocks[cls] = \
                self.used_blocks.get(cls, 0) - len(blocks)
            self.free_blocks.extend(blocks)
        self.lengths[slot] = 0
        self.free.append(slot)

    # -- decode-cohort views ------------------------------------------------
    def bump(self, slot: int):
        self.lengths[slot] += 1

    def gather_tables(self, slots: Sequence[int]) -> np.ndarray:
        """Block tables of ``slots`` as one (len(slots), blocks_per_slot)
        int32 array padded with the sentinel ``n_blocks``."""
        out = np.full((len(slots), self.blocks_per_slot), self.n_blocks,
                      np.int32)
        for i, slot in enumerate(slots):
            tbl = self.block_tables.get(slot, ())
            out[i, :len(tbl)] = tbl
        return out

    # -- fleet wire (disaggregated prefill -> decode hand-off) ---------------
    @property
    def slot_lane_bytes(self) -> int:
        """Paged bytes of one whole ``max_len`` lane (``blocks_per_slot``
        blocks across every paged position): the baseline a hand-off's
        ``RemotePrefill.kv_wire_bytes`` is held against, since it ships
        only the written blocks."""
        per_block = sum(
            t.numel() * t.element_size() // self.n_blocks
            for pos, paged in enumerate(self.paged) if paged
            for t in self.pool[pos])
        return per_block * self.blocks_per_slot

    def export_blocks(self, slot: int, n_blocks: int
                      ) -> List[List[torch.Tensor]]:
        """One request's prefill-written state as CPU tensors for the
        wire, per group position in the pool's leaf order: paged
        positions the first ``n_blocks`` granted blocks, ``(L, n_blocks,
        block_size, KV, hd)``; slot-state positions the request's ``(L,
        1, ...)`` row.  The copies to the host are the serialization
        boundary: the data leaves the process."""
        tbl = self.block_tables.get(slot, [])
        if n_blocks > len(tbl):
            raise RuntimeError(
                f"export of {n_blocks} blocks from slot {slot} which "
                f"holds {len(tbl)}")
        ids = torch.tensor(tbl[:n_blocks], dtype=torch.long,
                           device=self.device)
        out: List[List[torch.Tensor]] = []
        for pos, paged in enumerate(self.paged):
            if paged:
                out.append([leaf.index_select(1, ids).to("cpu", copy=True)
                            for leaf in self.pool[pos]])
            else:
                out.append([leaf[:, slot:slot + 1].to("cpu", copy=True)
                            for leaf in self.pool[pos]])
        return out

    def import_blocks(self, slot: int, payload) -> None:
        """Land an :meth:`export_blocks` payload (CPU tensors or numpy
        arrays, bf16 as ``torch.bfloat16``) at ``slot``, which must hold
        a block grant at least as long as the payload: paged leaves go
        into the slot's first granted blocks by ``_insert_blocks``,
        slot-state leaves into its row by ``_insert_slots``.  Both write
        the pool in place (it is never reassigned, so a captured cohort
        graph stays valid) on the current stream, so the next step on it
        reads the imported state.  Bit for bit: export -> wire -> import
        preserves every leaf."""
        bs = self.block_size
        tbl = self.block_tables.get(slot, [])
        for pos, paged in enumerate(self.paged):
            pool_leaves = self.pool[pos]
            if len(payload[pos]) != len(pool_leaves):
                raise RuntimeError(
                    f"import into slot {slot}: position {pos} carries "
                    f"{len(payload[pos])} leaves, the pool {len(pool_leaves)}")
            leaves = [torch.as_tensor(l).to(self.device)
                      for l in payload[pos]]
            for pool_leaf, leaf in zip(pool_leaves, leaves):
                want = (pool_leaf.shape[:1] + (leaf.shape[1],)
                        + pool_leaf.shape[2:])
                if leaf.shape != want or leaf.dtype != pool_leaf.dtype:
                    raise RuntimeError(
                        f"import into slot {slot}: a {leaf.dtype} leaf of "
                        f"{tuple(leaf.shape)} does not fit the pool's "
                        f"{pool_leaf.dtype} {tuple(pool_leaf.shape)}")
            if paged:
                nb = int(leaves[0].shape[1])
                if len(tbl) < nb:
                    raise RuntimeError(
                        f"import of {nb} blocks into slot {slot} which "
                        f"holds {len(tbl)}")
                ids = torch.tensor([tbl[:nb]], dtype=torch.int32,
                                   device=self.device)
                for pool_leaf, leaf in zip(pool_leaves, leaves):
                    _insert_blocks(pool_leaf, leaf.reshape(
                        (leaf.shape[0], 1, nb * bs) + tuple(leaf.shape[3:])),
                        ids, bs)
            else:
                if leaves[0].shape[1] != 1:
                    raise RuntimeError(f"import into slot {slot}: a slot-"
                                       f"state row of {leaves[0].shape[1]}")
                idx = torch.tensor([slot], dtype=torch.int32,
                                   device=self.device)
                for pool_leaf, leaf in zip(pool_leaves, leaves):
                    _insert_slots(pool_leaf, leaf, idx)

    # -- invariants / reporting ---------------------------------------------
    def check_block_invariants(self):
        """Raise unless every block is free xor granted to exactly one
        slot and the per-class charge matches the tables."""
        granted = [b for t in self.block_tables.values() for b in t]
        if len(granted) != len(set(granted)):
            raise AssertionError(f"double-granted block in "
                                 f"{self.block_tables}")
        free = list(self.free_blocks)
        if len(free) != len(set(free)):
            raise AssertionError(f"duplicate free block in {free}")
        if set(granted) & set(free):
            raise AssertionError("block both granted and free")
        if len(granted) + len(free) != self.n_blocks:
            raise AssertionError(
                f"block leak: {len(granted)} granted + {len(free)} free "
                f"!= {self.n_blocks}")
        by_class: Dict[Optional[str], int] = {}
        for slot, tbl in self.block_tables.items():
            cls = self.slot_class_of.get(slot)
            by_class[cls] = by_class.get(cls, 0) + len(tbl)
        used = {c: n for c, n in self.used_blocks.items() if n}
        if by_class != used:
            raise AssertionError(f"class charge drift: tables say "
                                 f"{by_class}, used_blocks says {used}")

    @property
    def nbytes(self) -> int:
        """Device bytes of every pool leaf, paged blocks and slot state."""
        return sum(t.numel() * t.element_size()
                   for pos in self.pool for t in pos)


def bucket_length(n: int, buckets=(128, 256, 512, 1024, 2048, 4096)) -> int:
    """Static-shape prompt bucketing: the nearest bucket at or above n."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
