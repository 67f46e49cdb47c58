"""zamba2-7b [hybrid] — 81L d_model=3584 32H (MHA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks.

Mapping: 81 Mamba2 layers; a single weight-shared attention+MLP block is
applied after every 6th Mamba2 layer (13 applications), mirroring Zamba2's
shared-block design. The shared block owns one KV cache per application site.
[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    shared_attn_every=6,
    rope_theta=10000.0,
)
