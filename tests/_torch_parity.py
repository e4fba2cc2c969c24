"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
flatten a reference parameter tree into the bridge's numpy form, and
build the port's tree from it."""
import functools

import numpy as np
import jax

from repro.core.quantize import QTensor
from repro_torch import bridge


def jax_to_numpy(tree):
    """Reference pytree -> numpy tree; QTensors become the bridge's packed
    mappings (bf16 stays an ml_dtypes array, which the bridge views as
    uint16 bits)."""
    if isinstance(tree, QTensor):
        return {"codes": np.asarray(tree.codes),
                "scales": np.asarray(tree.scales),
                "bits": tree.spec.bits, "group_size": tree.spec.group_size,
                "shape": tuple(tree.shape),
                "dtype": np.dtype(tree.dtype).name}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(jax_to_numpy(v) for v in tree)
    return np.asarray(tree)


def to_port(tree, device="cpu"):
    return bridge.from_numpy(jax_to_numpy(tree), device=device)


def bits(a):
    """Array -> integer view of its bits (bf16/fp32 compared exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def f32(x):
    """Reference array or port tensor -> float32 numpy."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def flat(tree, path=()):
    """Nested dict/tuple/list -> {path tuple: leaf} (dict key order does
    not matter: the reference's pytrees sort dict keys)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, path + (str(i),)))
        return out
    return {path: tree}


def from_numpy_to_ref(tree):
    """Bridge-form numpy tree -> reference pytree (packed mappings become
    reference QTensors; uint16 bf16 bits become bf16 arrays)."""
    import jax.numpy as jnp
    from repro.core.quantize import QTensor as RQTensor, QuantSpec

    def arr(a, dtype=None):
        a = np.asarray(a)
        if dtype == "bfloat16" or (dtype is None and a.dtype == np.uint16):
            a = a.view(jnp.bfloat16)
        return jnp.asarray(a)
    if isinstance(tree, dict) and "codes" in tree and "bits" in tree:
        return RQTensor(arr(tree["codes"], "int32"),
                        arr(tree["scales"], "float32"),
                        QuantSpec(tree["bits"], group_size=tree["group_size"]),
                        tuple(tree["shape"]), jnp.dtype(tree["dtype"]))
    if isinstance(tree, dict):
        return {k: from_numpy_to_ref(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy_to_ref(v) for v in tree)
    return arr(tree)


@functools.lru_cache(maxsize=None)
def shared_params(arch: str, dtype: str = "bfloat16", policy=None):
    """One set of reduced weights for both packages: the port's init
    (seed 0, CPU), optionally quantized by the port's policy (bit-equal to
    the reference's quantize_tree, see test_torch_quantize_bridge.py),
    handed to the reference through numpy.  Returns (reference cfg,
    reference params, port cfg, port params); callers must not mutate
    them."""
    import torch
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models.model import init_params
    tcfg = get_config(arch).reduced(dtype=dtype)
    with torch.no_grad():
        tparams = init_params(tcfg, device="cpu", seed=0)
        # the encoder-decoder's tree has no ``layers`` and no biases
        mix = tparams["layers"][0]["mixer"] if "layers" in tparams else {}
        gen = torch.Generator().manual_seed(1)
        for name in ("bq", "bk", "bv"):       # exercise the bias adds
            if name in mix:
                mix[name] = (0.1 * torch.randn(mix[name].shape, generator=gen)
                             ).to(mix[name].dtype)
        if policy is not None:
            tparams = quantize_tree(tparams, PROFILES[policy])
    rparams = from_numpy_to_ref(bridge.to_numpy(tparams))
    return ref_config(arch).reduced(dtype=dtype), rparams, tcfg, tparams
