"""Backend lowering — one brick graph, several substrates (paper §3.2).

A :class:`Backend` owns the substrate-specific decisions of plan
lowering: where a brick's weights live (``bind_params``), its executable
(``compile_fn``), and one-brick residency (``load`` / ``unload``; a
*transient* backend materializes params per execution — the On-Demand
Cascade policy).

=============== ============================== ==========================
backend          stands in for                  lowering
=============== ============================== ==========================
DeviceBackend    the GPU of the paper's SoC     weights on one torch
                                                device (``cuda`` unless
                                                the caller names another)
HostBackend      an NPU/DSP unit emulated on    weights on the CPU, load
                 a pinned CPU thread            -> execute -> release
=============== ============================== ==========================

Which kernels run follows from where the tensors are: a brick on the
host backend sees CPU tensors, so every kernel wrapper takes its plain
version there.  The pod-scale ``SubmeshBackend`` of the reference has no
counterpart on one card.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core.bricks import Brick
from repro_torch.core.quantize import QTensor
from repro_torch.tree import tree_map


class BackendError(RuntimeError):
    pass


def _to(tree, device):
    return tree_map(lambda l: l.to(device)
                    if isinstance(l, (torch.Tensor, QTensor)) else l, tree)


class Backend:
    """Protocol: the hooks plan lowering calls (see the module table)."""

    name: str = "base"
    #: params stay bound between executions; False = load->execute->release
    resident: bool = True
    device: torch.device = torch.device("cpu")

    def bind_params(self, brick: Brick, params):
        """Placement-time binding of the brick's param slice."""
        return _to(brick.params_of(params), self.device)

    def compile_fn(self, brick: Brick, cfg) -> Callable:
        """The brick's executable: inputs moved to this backend's device,
        run without autograd."""
        dev = self.device

        def fn(p, ctx, _b=brick):
            with torch.no_grad():
                return _b.apply(p, cfg, _to(ctx, dev))
        return fn

    def load(self, brick: Brick, bound):
        """Materialize params for one execution (transient backends)."""
        return bound

    def unload(self, dev_params) -> None:
        """Release what :meth:`load` materialized (transient backends)."""


class DeviceBackend(Backend):
    """Brick weights resident on one torch device."""

    name = "device"

    def __init__(self, device="cuda"):
        self.device = torch.device(device)


class HostBackend(Backend):
    """CPU execution pinned to one dedicated thread per instance — the
    emulated compute unit — with transient params: bound host-side,
    copied in per execution (``load``) and dropped after (``unload``)."""

    name = "host"
    resident = False

    def __init__(self, pin_thread: bool = True):
        self.device = torch.device("cpu")
        self._pin = pin_thread
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self._pool_tids: set = set()

    def _executor(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="host-backend",
                    initializer=lambda: self._pool_tids.add(
                        threading.get_ident()))
            return self._pool

    def compile_fn(self, brick, cfg):
        fn = super().compile_fn(brick, cfg)
        if not self._pin:
            return fn

        def pinned(p, ctx, _fn=fn):
            if threading.get_ident() in self._pool_tids:
                return _fn(p, ctx)
            return self._executor().submit(_fn, p, ctx).result()
        return pinned

    def load(self, brick, bound):
        return tree_map(lambda l: l.clone() if isinstance(l, torch.Tensor)
                        else l, bound)

    def unload(self, dev_params) -> None:
        del dev_params


BACKENDS: Dict[str, Backend] = {
    "device": DeviceBackend(),
    "host": HostBackend(),
}


def resolve_backend(spec: Union[str, Backend, None]) -> Backend:
    """A Backend instance, a registry name, or None (the ``device``
    backend)."""
    if isinstance(spec, Backend):
        return spec
    if spec is None:
        return BACKENDS["device"]
    try:
        return BACKENDS[spec]
    except KeyError:
        raise BackendError(f"unknown backend {spec!r}; registered: "
                           f"{sorted(BACKENDS)}") from None
