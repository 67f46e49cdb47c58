"""Training launcher of the port (twin of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --steps 20 --ckpt-dir /tmp/ck --device cuda

Runs single-process on one device (``--device cpu`` runs the plain PyTorch
path). Fault tolerance: checkpoints every ``--ckpt-every`` steps (atomic),
auto-resume from the latest with the data stream fast-forwarded past the
restored steps, emergency save on SIGTERM (preemption), straggler monitor
wired to the elastic session.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data import TokenStream
from repro_torch.distributed.elastic import ElasticSession
from repro_torch.models import init_params
from repro_torch.train import OptConfig, TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    tc = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps),
        accum=args.accum, compress=args.compress, tp=args.tp,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    params = init_params(cfg, 0, tp=args.tp, device=dev)
    tr = Trainer(cfg, tc, params)
    elastic = ElasticSession(args.ckpt_dir, model_parallel=args.tp)

    signal.signal(signal.SIGTERM, lambda *_: (tr.emergency_save(),
                                              sys.exit(143)))

    ds = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=0)
    it = iter(ds)
    for _ in range(tr.step):  # fast-forward the stream after restore
        next(it)
    t_start = time.time()
    while tr.step < args.steps:
        t0 = time.time()
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(it).items()}
        if args.accum > 1:
            batch = {k: v.reshape((args.accum, v.shape[0] // args.accum)
                                  + v.shape[1:]) for k, v in batch.items()}
        stats = tr.train_step(batch)
        dt = time.time() - t0
        elastic.on_step("host0", dt)
        if tr.step % 5 == 0 or tr.step == args.steps:
            print(f"step {tr.step:5d} loss {stats['loss']:.4f} "
                  f"lr {stats['lr']:.2e} |g| {stats['grad_norm']:.2f} "
                  f"{dt*1e3:.0f}ms")
    if args.ckpt_dir:
        tr.save()
    print(f"done: {args.steps} steps in {time.time()-t_start:.1f}s; "
          f"stragglers={elastic.monitor.stragglers()}")


if __name__ == "__main__":
    main()
