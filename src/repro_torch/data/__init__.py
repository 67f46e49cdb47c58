"""Synthetic data for the port (twin of ``repro.data``): the training token
stream, document packing and the retrieval corpus."""
from repro_torch.data.pipeline import (TokenStream, build_corpus,
                                       pack_documents, sample_queries)

__all__ = ["TokenStream", "build_corpus", "pack_documents", "sample_queries"]
