"""Plain PyTorch versions of the linear-attention kernel: the port's
chunked form with GQA by kv-head indexing and ``valid_len`` (the function
the kernel computes, all arithmetic in fp32) and the sequential
recurrence over expanded k/v as its oracle.

The wrapper in ``ops.py`` runs ``ref_linear_attention_chunked`` for CPU
tensors; the tests hold both against the reference package, and the
card's checks hold the kernel against ``ref_linear_attention_chunked``.
"""
from __future__ import annotations

from repro_torch.models.linear_attention import (
    linear_attention_chunked as ref_linear_attention_chunked)
from repro_torch.models.linear_attention import (
    linear_attention_sequential as ref_linear_attention)

__all__ = ["ref_linear_attention", "ref_linear_attention_chunked"]
