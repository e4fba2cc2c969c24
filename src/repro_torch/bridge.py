"""Parameter bridge: numpy trees in, the port's parameter trees out (and
back), so one set of weights can run through both packages.

A tree is nested ``dict`` / ``tuple`` / ``list`` with numpy-array leaves.
A packed weight arrives as a plain mapping::

    {"codes": int32 array, "scales": float array, "bits": int,
     "group_size": int, "shape": tuple, "dtype": "bfloat16"}

so the bridge needs no class of the reference package.  bfloat16 has no
numpy dtype of its own: an array whose dtype is named ``bfloat16`` (the
``ml_dtypes`` type) crosses as its ``uint16`` bit pattern and is viewed
back as ``torch.bfloat16``; :func:`to_numpy` returns bf16 tensors as
``uint16`` arrays of the same bits.

Like every entry point of the port, the bridge puts tensors on the card
unless the caller passes ``device="cpu"`` (as the CPU tests do).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core.quantize import QTensor, QuantSpec

_PACKED_KEYS = frozenset({"codes", "scales", "bits", "group_size", "shape",
                          "dtype"})


def _is_packed(x) -> bool:
    return isinstance(x, dict) and set(x) == _PACKED_KEYS


def array_to_tensor(a, device="cuda") -> torch.Tensor:
    """One numpy array -> tensor, bf16 through its ``uint16`` bits."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy; bf16 comes back as ``uint16`` bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(tree, device="cuda"):
    """numpy tree (packed weights as mappings) -> the port's tree."""
    if _is_packed(tree):
        spec = QuantSpec(int(tree["bits"]), group_size=int(tree["group_size"]))
        return QTensor(array_to_tensor(tree["codes"], device),
                       array_to_tensor(tree["scales"], device), spec,
                       tuple(int(s) for s in tree["shape"]),
                       torch_dtype(str(tree["dtype"])))
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device) for v in tree)
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return array_to_tensor(tree, device)
    return tree


def to_numpy(tree) -> Any:
    """The port's tree -> numpy tree (the inverse of :func:`from_numpy`,
    with bf16 as ``uint16`` bits and QTensors as packed mappings)."""
    if isinstance(tree, QTensor):
        return {"codes": tensor_to_array(tree.codes),
                "scales": tensor_to_array(tree.scales),
                "bits": tree.spec.bits, "group_size": tree.spec.group_size,
                "shape": tuple(tree.shape),
                "dtype": str(tree.dtype).replace("torch.", "")}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tensor_to_array(tree)
    return tree
