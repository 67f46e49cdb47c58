"""Config system: architectures, input shapes, memory-pipeline methods.

The port's own copy of ``repro.configs.base`` (field for field, so a config
built on either side describes the same model). Every architecture is a
frozen, hashable ``ArchConfig``. ``MemoryConfig`` configures the paper's
four-stage memory processing pipeline (method + hyperparameters from the
paper's Appendix D).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# ---------------------------------------------------------------------------
# Memory-processing pipeline configuration (the paper's contribution).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Hyperparameters of the four-stage memory processing pipeline.

    Defaults follow the paper's Appendix D:
      * DeepSeek Attention: 64 index heads, top-k = 2048.
      * SeerAttention-R: block size 64, token budget 4096, threshold 5e-4.
      * LServe: logical page 64, physical page = 4 logical pages.
    """

    method: str = "dsa"  # dsa | seer | lserve | mac | memagent | rag | ttt | none
    # --- DeepSeek sparse attention (lightning indexer) ---
    index_heads: int = 64
    index_dim: int = 128
    top_k: int = 2048
    # --- SeerAttention-R / LServe (block-sparse) ---
    block_size: int = 64
    token_budget: int = 4096
    threshold: float = 5e-4
    pages_per_physical: int = 4
    # --- retrieval/selection mode ---
    selection: str = "topk"  # topk | threshold
    # --- sparsity activation point: below this many cached tokens the
    #     placement policy falls back to dense attention (paper §5.2 / F). ---
    min_context: int = 4096
    # --- dynamic fallback: above this many cached tokens the paper's system
    #     falls back to the dense engine (index spills out of fast SRAM). ---
    fallback_context: int = 1 << 20

    def replace(self, **kw) -> "MemoryConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Architecture configuration.
# ---------------------------------------------------------------------------

VOCAB_PAD = 256  # Megatron-style: pad vocab to a multiple of this.


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | audio | hybrid | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_style: str = "rope"  # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: int = 0  # 0 -> disabled
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid (Mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    shared_attn_every: int = 0  # zamba2: shared attention block period
    # xLSTM
    xlstm_pattern: str = ""  # e.g. "ms" repeated; empty -> not xlstm
    # frontends (audio/vlm): backbone consumes precomputed embeddings + tokens
    frontend: str = "none"  # none | audio_stub | vision_stub
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # memory-processing pipeline applied to this arch
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def padded_heads(self, tp: int = 16) -> int:
        """Q heads padded to a multiple of the TP axis (Megatron dead heads)."""
        if self.n_heads % tp == 0:
            return self.n_heads
        return _round_up(self.n_heads, tp)

    def kv_shardable(self, tp: int = 16) -> bool:
        return self.n_kv_heads % tp == 0

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, VOCAB_PAD)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def ssm_groups(self) -> int:
        return 1

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.n_layers > 0 and self.d_ff == 0

    def n_params(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        emb = V * d * 2  # embed + lm_head
        if self.xlstm_pattern:
            per = 0
            for kind in self.xlstm_pattern:
                if kind == "m":  # mLSTM: qkv + gates + out over d_inner = 2d
                    di = 2 * d
                    per += d * di * 3 + d * di + di * d + 3 * d * di
                else:  # sLSTM: 4 gates input + recurrent + out
                    per += 4 * d * d + 4 * d * d + d * d
            return emb + per * (self.n_layers // max(len(self.xlstm_pattern), 1))
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        if self.n_experts:
            mlp = self.n_experts * 3 * d * ff + d * self.n_experts
        else:
            mlp = 3 * d * ff
        if self.family == "hybrid":
            di = self.d_inner
            g, N, H = self.ssm_groups, self.ssm_state, self.ssm_heads
            mamba = d * (2 * di + 2 * g * N + H) + di * d + di
            n_shared = self.n_layers // max(self.shared_attn_every, 1)
            return emb + self.n_layers * (mamba + 3 * d * ff if ff else mamba) + attn + 3 * d * ff
        return emb + self.n_layers * (attn + mlp)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        dense_mlp = self.n_experts * 3 * d * ff
        active_mlp = self.experts_per_token * 3 * d * ff
        return self.n_params() - self.n_layers * (dense_mlp - active_mlp)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """A reduced same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            head_dim=32,
        )
        if self.n_experts:
            kw.update(n_experts=4, experts_per_token=2)
        if self.family == "hybrid":
            kw.update(ssm_state=16, ssm_head_dim=32, shared_attn_every=1, n_layers=2, ssm_chunk=16)
        if self.xlstm_pattern:
            kw.update(xlstm_pattern="ms", n_layers=2, head_dim=32, n_heads=2, n_kv_heads=2)
        if self.sliding_window:
            kw.update(sliding_window=64)
        if self.rope_style == "mrope":
            hd2 = kw["head_dim"] // 2
            s1 = hd2 // 4
            s2 = (hd2 - s1) // 2
            kw.update(mrope_sections=(s1, s2, hd2 - s1 - s2))
        mem = self.memory.replace(
            index_heads=4, index_dim=32, top_k=16, token_budget=32, block_size=8,
            min_context=0,
        )
        kw["memory"] = mem
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every arch pairs with all four cells.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_shape(kind: str = "train") -> ShapeConfig:
    return {
        "train": ShapeConfig("smoke_train", 64, 2, "train"),
        "prefill": ShapeConfig("smoke_prefill", 64, 2, "prefill"),
        "decode": ShapeConfig("smoke_decode", 64, 2, "decode"),
    }[kind]
