"""Train a Memory-as-Context (Titans/HMT-style) model (twin of
``examples/train_mac_100m.py``): the backbone consumes [retrieved memory
embeddings; segment], then pushes a compressed segment summary into the
FIFO memory bank (paper Table 1 row 8, Fig. 6c).

The default config is small; ``--full`` selects the ~100M-parameter setup
(d=768, 12L, vocab 32000, 256-token segments, B 4). On the card the
backbone's attention is the flash kernel; its backward recomputes the plain
attention (``FlashAttention``).

    PYTHONPATH=src python -m repro_torch.examples.train_mac_100m --steps 30
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.methods import mac
from repro_torch.data import TokenStream
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import OptConfig, adamw_update, init_opt_state
from repro_torch.train.optimizer import leaves, tree_map

TP = 4


def setup(full: bool):
    """(cfg, MacConfig, batch) of the small or the ``--full`` run."""
    base = get_arch("llama3.2-1b")
    if full:
        cfg = base.replace(name="mac-100m", n_layers=12, d_model=768,
                           n_heads=12, n_kv_heads=12, head_dim=64,
                           d_ff=3072, vocab_size=32000)
        seg_len, B = 256, 4
    else:
        cfg = base.smoke()
        seg_len, B = 32, 2
    return cfg, mac.MacConfig(segment_len=seg_len, memory_slots=16,
                              retrieve_k=2), B


def mac_loss(params, cfg, mc, tokens, labels, segments: int):
    """Mean next-token loss over ``segments`` segments of ``tokens [B,
    segments * segment_len]``: each segment's embeddings get the bank's
    retrieved memories prepended (``mac.segment_step``), the backbone runs
    on that context (``forward(img_embeds=)``), the segment's positions are
    scored, and the segment's summary is pushed into the bank. The gradient
    flows through the gathered bank values and ``prepare_memory``, not
    through the top-k indices."""
    B, seg_len = tokens.shape[0], mc.segment_len
    bank = mac.bank_init(cfg, mc, B, device=tokens.device)
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for s in range(segments):
        seg = tokens[:, s * seg_len:(s + 1) * seg_len]
        lab = labels[:, s * seg_len:(s + 1) * seg_len]
        emb = L.embed(params["backbone"]["embed"], seg)
        ctx, _ = mac.segment_step(params["mac"], bank, emb, mc)
        # run the backbone on [memory; segment] (embeds injected)
        h, _, _ = M.forward(params["backbone"], cfg,
                            torch.zeros(ctx.shape[:2], dtype=torch.int32,
                                        device=ctx.device),
                            img_embeds=ctx, tp=TP)
        h_seg = h[:, mc.retrieve_k:]
        logits = L.lm_head(params["backbone"]["lm_head"], h_seg, cfg)
        total = total + L.cross_entropy(logits, lab)
        bank = mac.push(bank, mac.prepare_memory(params["mac"], h_seg))
    return total / segments


def train_step(params, opt, oc: OptConfig, cfg, mc, tokens, labels,
               segments: int):
    """One AdamW step on ``mac_loss`` (params and moments updated in
    place) -> (params, opt, loss). A leaf the loss does not reach (the
    query projection under top-k retrieval) gets a zero gradient, as
    ``jax.grad`` gives it."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = mac_loss(params, cfg, mc, tokens, labels, segments)
        got = torch.autograd.grad(loss, ps, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, got)}
    grads = tree_map(lambda p: by_id[id(p)], params)
    params, opt, _ = adamw_update(grads, opt, params, oc)
    return params, opt, loss.detach()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config (slow on a CPU)")
    ap.add_argument("--segments", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, mc, B = setup(args.full)
    params = {"backbone": M.init_params(cfg, 0, tp=TP, device=args.device),
              "mac": mac.mac_init(cfg, 1, device=args.device)}
    n_params = sum(x.numel() for x in leaves(params))
    print(f"params: {n_params / 1e6:.1f}M  segments/step: {args.segments}")

    opt = init_opt_state(params)
    oc = OptConfig(lr=3e-3, warmup_steps=5, total_steps=max(args.steps, 10))
    ds = TokenStream(cfg.vocab_size, mc.segment_len * args.segments, B,
                     seed=0)
    losses, step_s = [], []
    for i, batch in zip(range(args.steps), ds):
        t0 = time.perf_counter()
        params, opt, loss = train_step(
            params, opt, oc, cfg, mc,
            torch.from_numpy(batch["tokens"]).to(args.device),
            torch.from_numpy(batch["labels"]).to(args.device), args.segments)
        losses.append(float(loss))        # waits for the step
        step_s.append(time.perf_counter() - t0)
        if i % 5 == 0:
            print(f"step {i:4d} loss {losses[-1]:.3f}")
    first, last = losses[0], losses[-1]
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'OK' if last < first else 'no improvement'})")
    return {"losses": losses, "step_s": step_s, "params": n_params}


if __name__ == "__main__":
    main()
