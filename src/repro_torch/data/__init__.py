"""Data substrate: synthetic corpora, packing, sharded host loading."""
from repro_torch.data.pipeline import (PackedLMDataset, ShardedLoader,
                                       multimodal_batch_iter,
                                       synthetic_documents)

__all__ = ["PackedLMDataset", "ShardedLoader", "multimodal_batch_iter",
           "synthetic_documents"]
