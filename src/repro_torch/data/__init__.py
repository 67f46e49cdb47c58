"""Synthetic data for the port (twin of ``repro.data``): the retrieval
corpus only."""
from repro_torch.data.pipeline import build_corpus, sample_queries

__all__ = ["build_corpus", "sample_queries"]
