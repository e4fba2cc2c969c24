"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``),
each beside its plain PyTorch version.

Every kernel wrapper counts its calls into the compiled libraries in one
registry, so a run can show that it went through the kernels: reset the
counts just before the run with :func:`reset_launch_counts` and read them
just after with :func:`launch_counts`.  The counts, one per wrapper:
``fused_qkv``, ``fused_mlp``, ``kv_scatter`` (``fused_decode``),
``flash_attention``, ``ssd``, ``linear_attention``, ``dequant_gemm`` and
``cache_row_update`` (``cache_update``), each registered when its
``ops`` module is imported.  A wrapper with more than one kernel behind
it also counts each launch under ``<wrapper>/<route>``:
``flash_attention/wgmma`` (bf16) and ``flash_attention/tf32x3`` (fp32,
split TF32 on mma.sync), and the backward kernel's launches under
``flash_attention/bwd`` and ``flash_attention/bwd_bf16`` or
``flash_attention/bwd_f32``;
``dequant_gemm/wgmma`` (the warp-specialised bf16 kernel),
``dequant_gemm/tile`` (bf16 calls outside the wgmma kernel's rule) and
``dequant_gemm/tf32x3`` (fp32, split TF32 on mma.sync;
``dequant_gemm.kernel.route``); ``ssd/mma`` (bf16, tensor-core
products) and ``ssd/simt`` (fp32, FFMA); ``fused_mlp/gemv`` (the split-K
GEMV of both MLP stages, one a call) and ``fused_qkv/gemv`` (the same
GEMV, one a device kernel: one a distinct bit width of wq, wk, wv);
``fused_mlp/experts`` counts the routed experts' GEMV of an MoE's decode
(``fused_decode.ops.fused_mlp_experts``, its only count).

The counts are the launches the card ran, CUDA-graph replays included: a
replay runs no Python, so the code that captures a graph takes the
launches its capture counted with :func:`launches_of` (which leaves the
registry as it was: a capture launches nothing) and adds them back with
:func:`count_launches` at each replay (``serving/cohort_graph.py``).

The registry is safe across threads: two engines on one card (the
disaggregated fleets of ``serving/disagg.py``) count into it from two
threads.  A :func:`launches_of` in one thread collects that thread's
launches apart from the registry, so another thread's launches meanwhile
are counted, never taken into the delta nor lost.

Only flash attention has a backward kernel.  Every other wrapper calls
:func:`refuse_grad` before it launches on the card, so a CUDA input that
requires grad under grad mode raises instead of leaving the kernel's
output silently detached from the graph.

:func:`captured_nodes` reads the device kernels of a call from a CUDA
graph that captures it, node by node, so a check can count them without
a profiler, whose activity records can miss launches of a burst.
"""
import os
import re
import tempfile
import threading
import warnings
from typing import Callable, Dict, List, Tuple

import torch

_LAUNCHES: Dict[str, int] = {}
_LOCK = threading.Lock()
_LOCAL = threading.local()          # .deltas: this thread's open launches_of


def register_kernels(*names: str) -> None:
    """Give each wrapper ``name`` a count (0) in the registry."""
    with _LOCK:
        for name in names:
            _LAUNCHES.setdefault(name, 0)


def count_launch(name: str, n: int = 1) -> None:
    """Count ``n`` launches of ``name``: into the innermost open
    :func:`launches_of` of this thread, else into the registry."""
    if name not in _LAUNCHES:
        raise KeyError(name)
    deltas = getattr(_LOCAL, "deltas", None)
    if deltas:
        deltas[-1][name] = deltas[-1].get(name, 0) + n
        return
    with _LOCK:
        _LAUNCHES[name] += n


def launch_counts() -> Dict[str, int]:
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def launches_of(fn: Callable, *args, **kwargs) -> Tuple[object, Dict[str,
                                                                       int]]:
    """(``fn(*args, **kwargs)``, the launches it counted in this thread);
    the registry does not see them, whether ``fn`` returns or raises."""
    deltas = _LOCAL.__dict__.setdefault("deltas", [])
    deltas.append({})
    try:
        out = fn(*args, **kwargs)
    finally:
        delta = deltas.pop()
    return out, {k: n for k, n in delta.items() if n}


def captured_nodes(fn: Callable, *args, **kwargs) -> List[str]:
    """The nodes of a CUDA graph that captures one call ``fn(*args,
    **kwargs)``: each node's label in the graph's ``debug_dump`` (a kernel
    node's names its kernel), in the dump's order.  A kernel's launches a
    call are the labels that hold its name.  The graph is never replayed,
    and the launches the capture counts stay out of the registry
    (:func:`launches_of`).  ``fn`` must be capturable."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # kept for the dump

    def capture():
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn(*args, **kwargs)
    launches_of(capture)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # its DEBUG notes
            graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    del graph
    # a node's definition starts a line: "graph_<g>_node_<n>"[...]
    return [" ".join(part.split()) for part in re.split(
        r'(?m)^\s*"graph_\d+_node_\d+"\s*\[', text)[1:]]


def count_launches(delta: Dict[str, int]) -> None:
    """Add a recorded delta (:func:`launches_of`) to the counts."""
    for name, n in delta.items():
        count_launch(name, n)


def refuse_grad(name: str, *inputs) -> None:
    """Raise if grad mode is on and any of ``inputs`` (tensors, or packed
    weights holding tensors) requires grad: the kernel ``name`` has no
    backward, and its output would carry no gradient."""
    if not torch.is_grad_enabled():
        return
    for t in inputs:
        parts = (t,) if isinstance(t, torch.Tensor) else (
            getattr(t, "codes", None), getattr(t, "scales", None))
        if any(isinstance(x, torch.Tensor) and x.requires_grad
               for x in parts):
            raise RuntimeError(
                f"{name}: the kernel has no backward, and an input requires "
                f"grad; run it under torch.no_grad(), or train through a "
                f"path with a backward (ROADMAP 11.4)")
