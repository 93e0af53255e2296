"""Data of the port (``src/repro/data``): the synthetic token stream, its
prefetcher and the vector datasets of the kNN workloads."""
from repro_torch.data.pipeline import (
    Prefetcher,
    SyntheticTokenSource,
    make_vector_dataset,
)

__all__ = ["Prefetcher", "SyntheticTokenSource", "make_vector_dataset"]
