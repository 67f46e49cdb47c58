"""GQA attention (twin of ``repro.models.attention``), in plain PyTorch.

The reference computes these in XLA, outside any Pallas kernel; so does the
port, but for ``attention_full`` on the card, which runs the flash kernel
(the twin of ``repro.kernels.flash_attention``: the same function). Query
heads are padded to a multiple of ``tp`` with dead heads whose q rows and
o-proj columns are zero (``head_mask`` zeroes their outputs).

  * ``attention_full``         causal attention over a prompt (query chunks);
  * ``attention_decode``       one query token vs a KV view (dense decode);
  * ``attention_decode_chunk`` C new query tokens vs a KV view (chunked
                               prefill);
  * ``attention_decode_partial`` one query token vs a sequence slice of
                               the cache -> (out, lse), for the decode
                               split's merge.

A model shard of the tensor-parallel split (``shard=(m, n)``: shard m of n
over the mesh's ``model`` axis) holds q heads ``[m Hp/n, (m+1) Hp/n)``;
when ``kv_shardable(n)`` it holds kv heads ``[m KV/n, (m+1) KV/n)``, else
replicated ``wk`` / ``wv``, from which it projects the kv heads its q heads
read (all of them where a prefill's caches hold them: ``shard_kv_heads``);
it attends with the kv heads its q heads map to (``shard_kv``). Dead
padded heads fall on the last shards.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def attn_init(gen, cfg: ArchConfig, tp: int = 16, n: int = 1) -> Params:
    """Stacked [n, ...] attention weights (dead-head slices zeroed)."""
    d, hd, kv = cfg.d_model, cfg.hd, cfg.n_kv_heads
    hp = cfg.padded_heads(tp)
    dt = L.dtype_of(cfg)
    lead = (n,)
    p: Params = {
        "wq": L.dense_init(gen, d, hp * hd, dt, lead=lead),
        "wk": L.dense_init(gen, d, kv * hd, dt, lead=lead),
        "wv": L.dense_init(gen, d, kv * hd, dt, lead=lead),
        "wo": L.dense_init(gen, hp * hd, d, dt, lead=lead,
                           scale=1.0 / np.sqrt(2 * cfg.n_layers * hp * hd)),
    }
    if hp != cfg.n_heads:
        p["wq"].view(n, d, hp, hd)[:, :, cfg.n_heads:] = 0
        p["wo"].view(n, hp, hd, d)[:, cfg.n_heads:] = 0
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (hp * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros(lead + (kv * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros(lead + (kv * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=torch.float32, device=dev)
    return p


def head_mask(cfg: ArchConfig, tp: int = 16, device=None, shard=None
              ) -> torch.Tensor:
    """[Hp] fp32: 1 for live heads, 0 for the TP padding (a model shard's
    ``shard=(m, n)``: its heads' slice). Made once per (width, device) and
    shared: callers only read it (a copy from the host per layer would
    stall decode and cannot be captured in a CUDA graph)."""
    if device is None or type(device) is str:   # a name: one cache key
        device = torch.device(device or "cpu")
    mask = _head_mask_on(cfg.padded_heads(tp), cfg.n_heads, device)
    return mask if shard is None else mask[shard_heads(cfg, tp, shard)]


@functools.lru_cache(maxsize=16)
def _head_mask_on(hp: int, n_heads: int, device) -> torch.Tensor:
    return torch.as_tensor((np.arange(hp) < n_heads).astype(np.float32),
                           device=device)


def head_to_kv(cfg: ArchConfig, tp: int = 16) -> np.ndarray:
    """Static map padded-query-head -> kv head (dead heads map to kv 0)."""
    hp, h, kv = cfg.padded_heads(tp), cfg.n_heads, cfg.n_kv_heads
    g = max(h // kv, 1)
    m = np.minimum(np.arange(hp) // g, kv - 1)
    m[h:] = 0
    return m.astype(np.int32)


@functools.lru_cache(maxsize=16)
def _head_to_kv_on(cfg: ArchConfig, tp: int, device) -> torch.Tensor:
    """``head_to_kv`` as a long tensor on ``device``, made once."""
    return torch.as_tensor(head_to_kv(cfg, tp), device=device).long()


def project_qkv(p: Params, x, cos, sin, cfg: ArchConfig, tp: int = 16):
    """x [B, S, d] -> q [B, S, Hp, hd], k/v [B, S, KV, hd] (rope applied);
    a model shard's weights give its heads."""
    B, S, _ = x.shape
    hd = cfg.hd
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # a model shard's weights hold its slice of the heads
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = L.rms_norm({"w": p["q_norm"]}, q, cfg.norm_eps)
        k = L.rms_norm({"w": p["k_norm"]}, k, cfg.norm_eps)
    if cfg.rope_style != "none":
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    return q, k, v


def shard_heads(cfg: ArchConfig, tp: int, shard) -> slice:
    """The padded q heads model shard ``shard = (m, n)`` holds."""
    m, n = shard
    hp = cfg.padded_heads(tp)
    if hp % n:
        raise ValueError(f"{cfg.name}: {hp} padded heads do not split "
                         f"{n} ways")
    return slice(m * hp // n, (m + 1) * hp // n)


def _kv_of(cfg: ArchConfig, tp: int) -> np.ndarray:
    """The kv head each padded q head reads: ``expand_kv``'s map (groups of
    Hp // KV when KV divides Hp, else ``head_to_kv``)."""
    hp, kv = cfg.padded_heads(tp), cfg.n_kv_heads
    return (np.arange(hp) // (hp // kv) if hp % kv == 0
            else head_to_kv(cfg, tp))


def shard_kv_heads(cfg: ArchConfig, tp: int, shard, all_kv: bool = False):
    """[lo, hi): the kv heads shard ``(m, n)`` projects. Its own slice when
    ``kv_shardable(n)``; else the span of those its q heads read, or, with
    ``all_kv`` (a prefill's caches hold them), every one."""
    m, n = shard
    kv = cfg.n_kv_heads
    if cfg.kv_shardable(n):
        return m * kv // n, (m + 1) * kv // n
    if all_kv:
        return 0, kv
    need = _kv_of(cfg, tp)[shard_heads(cfg, tp, shard)]
    return int(need.min()), int(need.max()) + 1


def shard_kv_params(p: Params, cfg: ArchConfig, tp: int, shard,
                    all_kv: bool = False) -> Params:
    """A shard's attention weights with replicated ``wk`` / ``wv`` (and
    ``bk`` / ``bv``) narrowed to the columns of the kv heads it projects
    (``shard_kv_heads``): a view, so the gradient reaches those columns of
    its copy."""
    lo, hi = shard_kv_heads(cfg, tp, shard, all_kv)
    if cfg.kv_shardable(shard[1]) or (lo, hi) == (0, cfg.n_kv_heads):
        return p
    hd = cfg.hd
    out = dict(p)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            out[name] = p[name][..., lo * hd:hi * hd]
    return out


@functools.lru_cache(maxsize=256)
def _shard_kv_plan(cfg: ArchConfig, tp: int, shard, lo: int):
    """The kv heads shard ``(m, n)``'s q heads read (``_kv_of``), as
    positions in the kv heads it projects (from ``lo``): ("slice", a, b)
    when its q heads read heads a..b-1 in equal groups, as the flash
    kernel's GQA reads them, else ("index", one kv head per q head)."""
    need = _kv_of(cfg, tp)[shard_heads(cfg, tp, shard)] - lo
    u = np.unique(need)
    if (u[-1] - u[0] + 1 == len(u) and len(need) % len(u) == 0
            and np.array_equal(need, np.repeat(u, len(need) // len(u)))):
        return ("slice", int(u[0]), int(u[-1]) + 1)
    return ("index", need)


@functools.lru_cache(maxsize=256)
def _index_on(idx: tuple, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), device=device).long()


def project_qkv_shard(p: Params, x, cos, sin, cfg: ArchConfig, tp: int,
                      shard):
    """``project_qkv`` on model shard ``shard = (m, n)``'s head slice: its
    q heads, and its kv heads when ``kv_shardable(n)``, else all of them
    (the decode split's every shard then holds the whole new k / v)."""
    return project_qkv(shard_kv_params(p, cfg, tp, shard, all_kv=True), x,
                       cos, sin, cfg, tp)


def shard_kv(k, v, cfg: ArchConfig, tp: int, shard, lo: int = 0):
    """A shard's k / v [B, S, held, hd] (kv heads from ``lo``) -> the kv
    heads its q heads read, [B, S, kv, hd] with q heads % kv == 0 (q head i
    reads kv head i // G)."""
    plan = _shard_kv_plan(cfg, tp, tuple(shard), lo)
    if plan[0] == "slice":
        _, a, b = plan
        if b - a == k.shape[2]:
            return k, v
        return k[:, :, a:b], v[:, :, a:b]
    idx = _index_on(tuple(int(i) for i in plan[1]), k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def expand_kv(kv_arr: torch.Tensor, cfg: ArchConfig, tp: int = 16):
    """[..., KV, hd] -> [..., Hp, hd] by group broadcast (or gather)."""
    hp, kv = cfg.padded_heads(tp), cfg.n_kv_heads
    if hp % kv == 0:
        return kv_arr.repeat_interleave(hp // kv, dim=-2)
    return kv_arr.index_select(-2, _head_to_kv_on(cfg, tp, kv_arr.device))


def _softmax_attend(sc, mask, vexp):
    """sc [B,H,Q,K] fp32 with mask [B|1,1|.,Q,K] -> out [B,Q,H,hd] fp32."""
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vexp)


def attend_causal(q, kexp, vexp, *, window: Optional[int] = None,
                  q_chunk: int = 256):
    """Plain causal attention over expanded heads: q [B,S,H,hd], kexp/vexp
    [B,S,H,hd] -> [B,S,H,hd] in q's dtype, fp32 math. Query chunks of
    ``q_chunk`` bound the score tile to [B,H,q_chunk,S]. Differentiable: the
    flash kernel's backward (``kernels.flash_attention.FlashAttention``)
    recomputes through it."""
    S, hd = q.shape[1], q.shape[-1]
    kexp, vexp = kexp.float(), vexp.float()
    bq = min(q_chunk, S)
    q32 = q.float() * (1.0 / np.sqrt(hd))
    kpos = torch.arange(S, device=q.device)
    outs = []
    for s0 in range(0, S, bq):
        qc = q32[:, s0:s0 + bq]
        qpos = s0 + torch.arange(qc.shape[1], device=q.device)
        sc = torch.einsum("bqhd,bkhd->bhqk", qc, kexp)
        mask = qpos[:, None] >= kpos[None, :]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        outs.append(_softmax_attend(sc, mask[None, None], vexp))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_full(q, k, v, cfg: ArchConfig, *, q_chunk: int = 256,
                   window: Optional[int] = None, tp: int = 16, shard=None,
                   kv_lo: int = 0):
    """Causal attention; q [B,S,Hp,hd], k/v [B,S,KV,hd] -> [B,S,Hp,hd]; a
    model shard's (``shard=(m, n)``, its k / v holding kv heads from
    ``kv_lo``) over its heads (``shard_kv``). A CUDA tensor with kernels on
    goes through the flash kernel (``attention_full_flash``: one launch
    over the shard's heads), anything else through the plain chunked
    ``attend_causal``."""
    window = window if window is not None else (cfg.sliding_window or None)
    if shard is not None:
        k, v = shard_kv(k, v, cfg, tp, shard, kv_lo)
        if q.is_cuda and ops.kernels_enabled():
            return FlashAttention.apply(q, k, v, window or 0)
        g = q.shape[2] // k.shape[2]
        return attend_causal(q, k.repeat_interleave(g, dim=2),
                             v.repeat_interleave(g, dim=2), window=window,
                             q_chunk=q_chunk)
    if q.is_cuda and ops.kernels_enabled():
        return attention_full_flash(q, k, v, cfg, window=window, tp=tp)
    return attend_causal(q, expand_kv(k, cfg, tp), expand_kv(v, cfg, tp),
                         window=window, q_chunk=q_chunk)


def attention_full_flash(q, k, v, cfg: ArchConfig, *,
                         window: Optional[int] = None, tp: int = 16):
    """``attention_full`` through ``FlashAttention`` (the kernel on the card,
    its plain version on the CPU), with ``expand_kv``'s head mapping: G = Hp
    // KV when KV divides Hp, else k/v gathered to Hp heads first and G = 1.
    Dead padded heads need no care: their zero q rows average v uniformly,
    and ``head_mask`` zeroes them after, as on the plain path."""
    hp, kv = cfg.padded_heads(tp), cfg.n_kv_heads
    if hp % kv:
        idx = _head_to_kv_on(cfg, tp, k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return FlashAttention.apply(q, k, v, window or 0)


def attention_decode(q, k_cache, v_cache, length, cfg: ArchConfig, *,
                     window: Optional[int] = None, tp: int = 16):
    """q [B,1,Hp,hd]; caches [B,Smax,KV,hd]; length [] or [B] -> [B,1,Hp,hd]."""
    B, Smax = k_cache.shape[0], k_cache.shape[1]
    hd = q.shape[-1]
    window = window if window is not None else (cfg.sliding_window or None)
    kexp = expand_kv(k_cache, cfg, tp).float()
    vexp = expand_kv(v_cache, cfg, tp).float()
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / np.sqrt(hd)),
                      kexp)
    pos = torch.arange(Smax, device=q.device)
    lb = torch.as_tensor(length, device=q.device).reshape(-1).expand(B)
    mask = pos[None, :] < lb[:, None]
    if window:
        mask &= pos[None, :] >= (lb[:, None] - window)
    return _softmax_attend(sc, mask[:, None, None, :], vexp).to(q.dtype)


def attention_decode_partial(q, k_cache, v_cache, length, offset: int,
                             cfg: ArchConfig, *, window: Optional[int] = None,
                             tp: int = 16):
    """``attention_decode`` over one sequence slice of the cache, for the
    decode split's LSE merge: q [B,1,Hp,hd]; k/v [B,S_l,KV,hd] holding
    positions ``offset .. offset + S_l - 1``; ``length`` [] or [B] the
    context's global length -> (out [B,Hp,hd] fp32, lse [B,Hp] fp32). A
    slice with no live position (every score masked) gives an lse near
    -1e30, which ``ops.lse_merge`` weighs zero."""
    B, Sl = k_cache.shape[0], k_cache.shape[1]
    hd = q.shape[-1]
    window = window if window is not None else (cfg.sliding_window or None)
    kexp = expand_kv(k_cache, cfg, tp).float()
    vexp = expand_kv(v_cache, cfg, tp).float()
    sc = torch.einsum("bhd,bkhd->bhk", q[:, 0].float() * (1.0 / np.sqrt(hd)),
                      kexp)
    pos = offset + torch.arange(Sl, device=q.device)
    lb = torch.as_tensor(length, device=q.device).reshape(-1).expand(B)
    mask = pos[None, :] < lb[:, None]
    if window:
        mask &= pos[None, :] >= (lb[:, None] - window)
    sc = torch.where(mask[:, None, :], sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    den = p.sum(-1)
    out = torch.einsum("bhk,bkhd->bhd", p, vexp) / den[..., None]
    return out, m + torch.log(den)


def attention_decode_chunk(q, k_cache, v_cache, start, cfg: ArchConfig, *,
                           window: Optional[int] = None, tp: int = 16):
    """Chunked-prefill attention: q [B,C,Hp,hd] vs caches [B,Smax,KV,hd] that
    already hold the C new keys at start[b]..start[b]+C-1; query i of row b
    sits at start[b]+i and attends causally -> [B,C,Hp,hd]. Rows past a
    slot's real span are garbage the caller ignores."""
    B, C = q.shape[:2]
    Smax = k_cache.shape[1]
    hd = q.shape[-1]
    window = window if window is not None else (cfg.sliding_window or None)
    kexp = expand_kv(k_cache, cfg, tp).float()
    vexp = expand_kv(v_cache, cfg, tp).float()
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / np.sqrt(hd)),
                      kexp)
    kpos = torch.arange(Smax, device=q.device)
    qpos = start.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    mask = kpos[None, None, :] <= qpos[:, :, None]               # [B, C, Smax]
    if window:
        mask &= kpos[None, None, :] > (qpos[:, :, None] - window)
    return _softmax_attend(sc, mask[:, None], vexp).to(q.dtype)
