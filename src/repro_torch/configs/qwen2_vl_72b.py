"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.

The vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings and 3-section M-RoPE position ids; the LM backbone (with M-RoPE)
is real. [arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_style="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
)
