"""The cohort decode step as one CUDA graph per cohort bucket: the port's
counterpart of the reference engine's ``jax.jit`` per bucket
(``_cohort_fn``), which compiles the step once and reuses it.

A :class:`CohortGraph` holds one bucket's static inputs (tokens (bc, 1),
lengths, slot ids (bc,) and block tables (bc, W), int32 views of one
device buffer, filled from one pinned host buffer by one non-blocking
copy), the graph that replays the step on them and on the engine's pool,
the step's static logits, and the kernel launches its capture counted.

Capture: one eager warm-up of the step on the capture stream with every
row a sentinel (slot ``n_slots``, block ``n_blocks``: it writes nothing
to the pool), so that what happens at a kernel's first use (building and
loading its library, setting its function attributes, allocating the
GEMV's arrival counters) happens outside the graph; then the capture on
the same stream, in ``thread_local`` error mode, since the staging
worker's threads go on using the card meanwhile.  The graphs of one
engine share one memory pool: they replay one at a time on one stream,
and none reads another's temporaries.  The registry's launch counts are
left as they were (a capture launches nothing, and the all-sentinel
warm-up is no decode step); each replay adds the launches the capture
counted (``kernels.launches_of`` / ``kernels.count_launches``).

The graph bakes in every address it touches: the weights, the pool, the
static buffers.  A call takes the step's host arrays, checks that the pool
it is given is the captured one and raises if it is not; a failed capture
raises too.  There is no
eager fallback on the card.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import count_launches, launches_of

# int32 elements each input starts on: 16-byte aligned views
_ALIGN = 4


def pool_ptrs(pool) -> Tuple[int, ...]:
    """The device addresses of every pool leaf, in order."""
    return tuple(t.data_ptr() for pos in pool for t in pos)


def _offsets(bc: int, width: int) -> Tuple[int, ...]:
    """Start of each input (tokens, lengths, slot ids, tables) in the flat
    buffer, and its end."""
    sizes = (bc, bc, bc, bc * width)
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // _ALIGN) * _ALIGN)
    return tuple(starts)


def _views(buf, bc: int, width: int):
    """(tokens (bc, 1), lengths (bc,), slot ids (bc,), tables (bc, W))
    views of a flat buffer (a tensor or a numpy array)."""
    o = _offsets(bc, width)
    return (buf[o[0]:o[0] + bc].reshape(bc, 1), buf[o[1]:o[1] + bc],
            buf[o[2]:o[2] + bc], buf[o[3]:o[3] + bc * width].reshape(
                bc, width))


class CohortGraph:
    """The cohort step ``step(tokens, lengths, slot_ids, tables, pool) ->
    (logits, pool)`` of bucket ``bc`` captured once on ``pool`` and
    replayed by each call.  ``width`` is the block tables' width;
    ``n_slots`` and ``n_blocks`` the sentinel ids of the warm-up;
    ``mempool`` the graphs' shared memory pool and ``stream`` the capture
    stream."""

    def __init__(self, step: Callable, pool, bc: int, width: int,
                 n_slots: int, n_blocks: int, device: torch.device,
                 mempool, stream: torch.cuda.Stream):
        self.bc = bc
        self._pool = pool                  # kept alive with the graph
        self._ptrs = pool_ptrs(pool)
        n = _offsets(bc, width)[-1]
        self._host = torch.zeros(n, dtype=torch.int32, pin_memory=True)
        self._dev = torch.zeros(n, dtype=torch.int32, device=device)
        self._host_views = _views(self._host.numpy(), bc, width)
        self.inputs = _views(self._dev, bc, width)
        self._copied = torch.cuda.Event()
        self.load(np.zeros((bc, 1), np.int32), np.zeros(bc, np.int32),
                  np.full(bc, n_slots, np.int32),
                  np.full((bc, width), n_blocks, np.int32))
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            _, warm = launches_of(step, *self.inputs, pool)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(self.graph, pool=mempool, stream=stream,
                                  capture_error_mode="thread_local"):
                return step(*self.inputs, pool)
        (self.logits, out), self.launches = launches_of(capture)
        if self.launches != warm:
            raise RuntimeError(f"cohort graph bc={bc}: the capture counted "
                               f"{self.launches}, the warm-up {warm}")
        if pool_ptrs(out) != self._ptrs:
            raise RuntimeError(f"cohort graph bc={bc}: the captured step "
                               f"did not write the pool in place")

    def load(self, tokens, lengths, slot_ids, tables):
        """Copy a step's host arrays into the static inputs: into the
        pinned buffer (once the previous copy out of it has finished),
        then one non-blocking copy to the card.  Returns the inputs."""
        self._copied.synchronize()
        for view, a in zip(self._host_views,
                           (tokens, lengths, slot_ids, tables)):
            view[...] = a
        self._dev.copy_(self._host, non_blocking=True)
        self._copied.record()
        return self.inputs

    def __call__(self, tokens, lengths, slot_ids, tables,
                 pool) -> Tuple[torch.Tensor, Sequence]:
        """Replay the step on a step's host arrays (:meth:`load`) and
        ``pool``, which must be the captured pool.  Returns (logits, pool):
        the logits are the graph's static buffer, which the next replay of
        any bucket of this engine may overwrite (the buckets share one
        memory pool), so a caller that keeps them clones them."""
        if pool_ptrs(pool) != self._ptrs:
            raise RuntimeError(f"cohort graph bc={self.bc}: the pool is not "
                               f"the one the graph was captured on")
        self.load(tokens, lengths, slot_ids, tables)
        self.graph.replay()
        count_launches(self.launches)
        return self.logits, pool
