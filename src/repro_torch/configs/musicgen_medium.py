"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens.

The EnCodec frontend is a STUB: ``input_specs()`` provides precomputed frame
token ids over the 2048-entry codebook vocabulary; the transformer backbone is
real. 24 heads pad to 32 under 16-way TP. [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    frontend="audio_stub",
    rope_theta=10000.0,
)
