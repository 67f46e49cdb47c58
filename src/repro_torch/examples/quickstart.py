"""Quickstart (twin of ``examples/quickstart.py``): build a small model,
train briefly, serve with the memory-processing pipeline (DSA sparse
attention).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data import TokenStream
from repro_torch.models import init_params
from repro_torch.serving import Engine, ServeConfig
from repro_torch.train import OptConfig, TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1) an assigned architecture, reduced for a quick run
    cfg = get_arch("llama3.2-1b").smoke()
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab_size} (padded {cfg.padded_vocab})")

    # 2) train a few steps (loss must drop on the structured synthetic data)
    params = init_params(cfg, 0, tp=4, device=args.device)
    tr = Trainer(cfg, TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5,
                                                total_steps=100), tp=4),
                 params)
    ds = TokenStream(cfg.vocab_size, 64, 4, seed=0)
    for i, batch in zip(range(20), ds):
        stats = tr.train_step({k: torch.from_numpy(v).to(args.device)
                               for k, v in batch.items()})
        if i % 5 == 0:
            print(f"step {i:3d} loss {stats['loss']:.3f} "
                  f"lr {stats['lr']:.2e} |g| {stats['grad_norm']:.2f}")

    # 3) serve with the paper's memory pipeline (DeepSeek-style sparse
    #    attention with dynamic dense fallback below min_context)
    eng = Engine(cfg, tr.params,
                 ServeConfig(max_len=128, n_slots=4, method="dsa", tp=4,
                             page=8),
                 seed=1, device=args.device)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 32))
    out = eng.generate(prompts, max_new=8)
    print("generated tokens:\n", out)
    print(f"prefill {eng.stats['prefill_s']*1e3:.1f}ms, "
          f"decode {eng.stats['decode_s']*1e3:.1f}ms "
          f"({eng.stats['tokens']} tokens)")
    return out


if __name__ == "__main__":
    main()
