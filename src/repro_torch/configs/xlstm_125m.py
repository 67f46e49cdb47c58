"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks (no FFN; projections live inside the blocks).

Attention-free: the memory pipeline's relevancy/retrieval stages are
inapplicable (see DESIGN.md §4); the matrix memory itself plays the
prepare/apply roles (paper's TTT row). [arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    xlstm_pattern="ms",  # repeat (mLSTM, sLSTM) pairs across the 12 layers
    rope_style="none",
)
