"""Backend lowering — one brick graph, several substrates (paper §3.2).

The paper's core claim is that each brick runs on its *best-suited*
compute unit.  A :class:`Backend` owns the substrate-specific decisions
of plan lowering: where a brick's weights live (``bind_params``), its
executable (``compile_fn``), the inbound transfer for values produced on
another unit (``make_edge``), and one-brick residency (``load`` /
``unload``; a *transient* backend materializes params per execution —
the On-Demand Cascade policy).

=============== ============================== ==========================
backend          stands in for                  lowering
=============== ============================== ==========================
DeviceBackend    the GPU of the paper's SoC     weights on one torch
                                                device (``cuda`` unless
                                                the caller names another)
HostBackend      an NPU/DSP unit emulated on    weights host-side, load
                 a pinned CPU thread            -> execute -> release on
                                                its execution device (the
                                                registry's row: the CPU)
=============== ============================== ==========================

Which kernels run follows from where the tensors are: a brick on the
registry's host backend sees CPU tensors, so every kernel wrapper takes
its plain version there.  A ``HostBackend("cuda")`` is the reference's
transient backend on an accelerator (its ``load`` materializes the
host-side params on the default device): params pinned host-side, copied
to the card per execution, the card's kernels, released after.

The substrate table (:data:`SUBSTRATES`) ties each energy profile of the
scheduler's cost model (``core/scheduler``) to the backend it lowers
through and its relative throughput per quant label, so the scheduler
never prices a unit the lowering contradicts.  ``Accelerator.backend``
or the table row names a backend; ``schedule()`` carries it into
``Placement.backends``; ``compile_plan`` resolves each brick through
:func:`resolve_backend`.  The pod-scale ``SubmeshBackend`` of the
reference has no counterpart on one card: its ``tpu-v5e`` row stays as
data, and an accelerator on it resolves to ``host``.
"""
from __future__ import annotations

import re
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.bricks import Brick
from repro_torch.core.quantize import QTensor
from repro_torch.tree import tree_map


class BackendError(RuntimeError):
    pass


def _to(tree, device, non_blocking: bool = False):
    return tree_map(lambda l: l.to(device, non_blocking=non_blocking)
                    if isinstance(l, (QTensor, torch.Tensor)) else l, tree)


def _pinned(tree):
    return tree_map(lambda l: l.pin_memory()
                    if isinstance(l, (QTensor, torch.Tensor)) else l, tree)


def _clear(tree) -> None:
    """Empty every container of ``tree`` in place, dropping its leaves."""
    if isinstance(tree, dict):
        for v in tree.values():
            _clear(v)
        tree.clear()
    elif isinstance(tree, list):
        for v in tree:
            _clear(v)
        tree.clear()
    elif isinstance(tree, tuple):
        for v in tree:
            _clear(v)


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

    def make_edge(self, src_accel, dst_accel) -> Callable:
        """Inbound transfer for values produced on a different accelerator
        (``src_accel`` may be None: an external input): a copy onto this
        backend's device."""
        return lambda v, _d=self.device: v.to(_d)

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
    """Transient params, executed on one dedicated thread per instance —
    the emulated compute unit, so its bricks serialize against each other
    whichever thread drives the plan.

    The params are bound host-side (in pinned memory when the execution
    ``device`` is a card), materialized on ``device`` per execution
    (``load``: a clone on the CPU, a copy to the card, complete when
    ``load`` returns) and dropped after (``unload`` empties the loaded
    tree, so nothing of it outlives the execution but what the brick
    returned)."""

    name = "host"
    resident = False

    def __init__(self, pin_thread: bool = True, device="cpu"):
        self.device = torch.device(device)
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

    def bind_params(self, brick, params):
        host = _to(brick.params_of(params), "cpu")
        return _pinned(host) if self.device.type == "cuda" else host

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
        if self.device.type == "cpu":
            return tree_map(lambda l: l.clone()
                            if isinstance(l, torch.Tensor) else l, bound)
        out = _to(bound, self.device, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def unload(self, dev_params) -> None:
        _clear(dev_params)


# ---------------------------------------------------------------------------
# registry — the backend table compile_plan consults
# ---------------------------------------------------------------------------

BACKENDS: Dict[str, Backend] = {
    "device": DeviceBackend(),
    "host": HostBackend(),
}


def register_backend(backend: Backend) -> Backend:
    """Add a custom substrate to the lowering table."""
    BACKENDS[backend.name] = backend
    return backend


# per-ordinal DeviceBackends ("device:N" specs) — cached so two plans
# naming the same ordinal share one backend instance, and thus one edge
# identity in compile_plan's edge cache
_DEVICE_BACKENDS: Dict[int, DeviceBackend] = {}
# the generic "device" row on another torch device (compile_plan's
# ``device=``), one instance a device for the same reason
_DEVICE_ROWS: Dict[str, DeviceBackend] = {}
_DEVICE_LOCK = threading.Lock()


def device_backend(ordinal: int) -> DeviceBackend:
    """The DeviceBackend of card ``ordinal`` (``cuda:N``), named
    ``"device:N"``; raises :class:`BackendError` when this machine has no
    such card (never falls back to another)."""
    with _DEVICE_LOCK:
        be = _DEVICE_BACKENDS.get(ordinal)
        if be is None:
            n = torch.cuda.device_count()
            if not 0 <= ordinal < n:
                raise BackendError(
                    f"device ordinal {ordinal} out of range ({n} visible "
                    f"card(s))")
            be = DeviceBackend(f"cuda:{ordinal}")
            be.name = f"device:{ordinal}"
            _DEVICE_BACKENDS[ordinal] = be
        return be


def _device_row(device) -> DeviceBackend:
    """The ``device`` row lowering to ``device``: the registry's own when
    it already does, else one cached instance of that name a device."""
    dev = torch.device(device)
    row = BACKENDS["device"]
    if row.device == dev:
        return row
    with _DEVICE_LOCK:
        be = _DEVICE_ROWS.get(str(dev))
        if be is None:
            be = _DEVICE_ROWS[str(dev)] = DeviceBackend(dev)
        return be


# ---------------------------------------------------------------------------
# substrate table — one row per energy profile: the backend it lowers
# through and its relative matmul efficiency per quant label; the
# scheduler's cost model (``Accelerator.throughput_scale`` ->
# :func:`bit_efficiency`) and backend resolution (:func:`substrate_backend`)
# read the same rows
# ---------------------------------------------------------------------------

_SPARSE_RE = re.compile(r"^(?P<base>.+?)-sp(?P<pct>\d{1,2})$")
_GROUP_RE = re.compile(r"^(?P<base>.+?)-g\d+$")


@dataclass(frozen=True)
class Substrate:
    """One compute-unit row: lowering backend + per-quant-label relative
    matmul throughput (fraction of the unit's peak at its preferred
    width).

    ``sparse_gain`` is the fraction of pruned MACs the unit actually
    skips: a label like ``q4f16-g32-sp50`` prices as the base row sped up
    by ``1 / (1 - sparsity * sparse_gain)``; a unit whose kernels cannot
    skip zeros keeps gain 0."""

    backend: str                            # BACKENDS registry name
    bit_efficiency: Tuple[Tuple[str, float], ...]
    sparse_gain: float = 0.0

    def efficiency(self, quant_label: str, default: float = 1.0) -> float:
        table = dict(self.bit_efficiency)
        if quant_label in table:
            return table[quant_label]
        sparsity = 0.0
        m = _SPARSE_RE.match(quant_label)
        if m:
            sparsity = int(m.group("pct")) / 100.0
            quant_label = m.group("base")
        g = _GROUP_RE.match(quant_label)     # "q4f16-g32" -> "q4f16" row
        if g:
            quant_label = g.group("base")
        base = table.get(quant_label, default)
        if sparsity <= 0.0:
            return base
        return base / max(1.0 - sparsity * self.sparse_gain, 1e-6)


SUBSTRATES: Dict[str, Substrate] = {
    # the reference's rows, verbatim: NPU fp16 at 0.6 (the paper's
    # static-graph NPU keeps fp16 encoders fast), the npu/cpu rows on the
    # host backend, the gpu row on the device backend, the pod profile on
    # submeshes (no counterpart on one card)
    "rk-npu": Substrate("host", (("q8f16", 1.0), ("q4f16", 1.0),
                                 ("q2f16", 1.0), ("fp16", 0.6),
                                 ("bf16", 0.6)), sparse_gain=0.9),
    "rk-gpu": Substrate("device", (("q8f16", 0.9), ("q4f16", 0.9),
                                   ("q2f16", 0.9), ("fp16", 1.0),
                                   ("bf16", 1.0)), sparse_gain=0.5),
    "rk-cpu": Substrate("host", (("q8f16", 0.8), ("q4f16", 0.6),
                                 ("q2f16", 0.5), ("fp16", 0.3),
                                 ("bf16", 0.3))),
    "tpu-v5e": Substrate("submesh", (("q8f16", 1.0), ("q4f16", 1.0),
                                     ("q2f16", 1.0), ("fp16", 1.0),
                                     ("bf16", 1.0))),
}


def bit_efficiency(profile_name: str, quant_label: str,
                   default: float = 1.0) -> float:
    """The cost model's throughput scale for one unit at one quant width,
    from the substrate table (``default`` for unknown units)."""
    sub = SUBSTRATES.get(profile_name)
    return default if sub is None else sub.efficiency(quant_label, default)


def substrate_backend(profile_name: str) -> Optional[str]:
    """The backend registry name a unit's profile lowers through, or None
    for profiles the table does not know."""
    sub = SUBSTRATES.get(profile_name)
    return None if sub is None else sub.backend


def _resolve(spec, accel) -> Backend:
    if isinstance(spec, Backend):
        return spec
    if spec is not None:
        if isinstance(spec, str) and spec.startswith("device:"):
            tail = spec.split(":", 1)[1]
            if not tail.isdigit():
                raise BackendError(
                    f"bad device ordinal in backend spec {spec!r} "
                    f"(want 'device:<int>')")
            return device_backend(int(tail))
        try:
            return BACKENDS[spec]
        except KeyError:
            raise BackendError(
                f"unknown backend {spec!r}; registered: "
                f"{sorted(BACKENDS)}") from None
    if accel is not None:
        name = getattr(accel, "backend", None)
        if name:
            return _resolve(name, None)
        profile = getattr(accel, "profile", None)
        sub = substrate_backend(getattr(profile, "name", ""))
        # the table row binds unless it names the submesh lowering, which
        # needs a mesh the port never carries
        if sub is not None and sub != "submesh":
            return _resolve(sub, None)
        return BACKENDS["host"]
    return BACKENDS["device"]


def resolve_backend(spec: Union[str, Backend, None], accel=None,
                    device=None) -> Backend:
    """Resolve a backend spec to a concrete Backend.

    Priority, as the reference's: an explicit ``spec`` (a Backend, a
    registry name, or ``"device:N"``, the card of :func:`device_backend`)
    > the accelerator's ``backend`` field > the :data:`SUBSTRATES` row of
    its energy profile > ``host`` (an accelerator outside the table or on
    its ``submesh`` row) > ``device``.
    ``device``: the torch device the generic ``device`` row lowers to in
    this call (None: the registry row's, ``cuda``); it changes nothing
    else."""
    be = _resolve(spec, accel)
    if device is not None and be is BACKENDS["device"]:
        return _device_row(device)
    return be
