"""The memory-processing pipeline's placement policy and methods (twin of
``repro.core``)."""
