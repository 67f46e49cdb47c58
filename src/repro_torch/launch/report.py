"""Aggregate the dry run's JSON records into a roofline table (twin of
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh 16x16]
        [--variant baseline]

Reads ``build/dryrun/`` (``launch.dryrun``). Beside the walk's terms each
row gets the "ideal" ones: the memory term from the analytic
``ideal_memory_bytes`` (perfect fusion, a lower bound; the walk's bytes are
eager execution's upper bound), the bottleneck, step and MFU they give.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import OUT_DIR


def load(mesh: str, variant: str, out_dir: str = OUT_DIR):
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.core.placement import HBM_BW, PEAK_FLOPS
    from repro_torch.launch import roofline as RL

    tag = "pod" + mesh if mesh.count("x") == 2 else mesh
    rows = []
    for f in sorted(glob.glob(os.path.join(out_dir,
                                           f"*__{tag}__{variant}.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("ok") and r["shape"] in SHAPES:
            rl = r["roofline"]
            cfg, shape = get_arch(r["arch"]), SHAPES[r["shape"]]
            chips = rl["chips"]
            rl["ideal_memory_s"] = (RL.ideal_memory_bytes(cfg, shape, chips)
                                    / HBM_BW)
            terms = {"compute": rl["compute_s"],
                     "memory": rl["ideal_memory_s"],
                     "collective": rl["collective_s"]}
            rl["bottleneck_ideal"] = max(terms, key=terms.get)
            step = max(terms.values())
            rl["step_s_ideal"] = step
            rl["mfu_ideal"] = (rl["model_flops"] / (step * chips * PEAK_FLOPS)
                               if step else 0.0)
        rows.append(r)
    return rows


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def table(rows):
    hdr = ("| arch | shape | compute | memory lo..hi | collective | "
           "bottleneck | useful | MFU | dominant collective | peak live "
           "(fits 80 GB) |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    for r in rows:
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | FAILED: "
                       f"{r.get('error', '?')[:60]} |" + " |" * 7)
            continue
        rl = r["roofline"]
        per = rl.get("per_collective", {})
        dom = max(per, key=per.get) if any(per.values()) else "-"
        dom_s = f"{dom} {per.get(dom, 0)/2**30:.2f}GiB" if dom != "-" else "-"
        ma = r.get("memory_analysis", {})
        peak = ma.get("max_peak_live_bytes", 0)
        fits = "yes" if ma.get("max_fits") else "no"
        ideal = rl.get("ideal_memory_s", 0.0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rl['compute_s'])} | "
            f"{fmt_s(ideal)}..{fmt_s(rl['memory_s'])} | "
            f"{fmt_s(rl['collective_s'])} | "
            f"{rl.get('bottleneck_ideal', rl['bottleneck'])} | "
            f"{rl['useful_ratio']:.2f} | "
            f"{rl.get('mfu_ideal', rl['mfu']):.3f} | {dom_s} | "
            f"{peak/2**30:.1f}GiB ({fits}) |")
    return "\n".join(out)


def pick_hillclimb(rows):
    """The three cells to work on: the worst-MFU train cell, the most
    collective-bound cell, the most paper-representative one (long-context
    sparse decode); None where no cell qualifies."""
    ok = [r for r in rows if r.get("ok")]
    ratio = lambda r: (r["roofline"]["collective_s"]  # noqa: E731
                       / max(r["roofline"]["compute_s"], 1e-12))
    mfu = lambda r: r["roofline"].get("mfu_ideal",  # noqa: E731
                                      r["roofline"]["mfu"])
    train = [r for r in ok if r["shape"] == "train_4k"]
    longs = [r for r in ok if r["shape"] == "long_500k"
             and r["arch"] not in ("xlstm-125m", "zamba2-7b")]
    worst = min(train, key=mfu) if train else None
    collective = max(ok, key=ratio) if ok else None
    paperish = max(longs, key=ratio) if longs else None
    return worst, collective, paperish


def summary(rows):
    ok = [r for r in rows if r.get("ok")]
    fail = [r for r in rows if not r.get("ok")]
    bn = {}
    for r in ok:
        bn[r["roofline"]["bottleneck"]] = bn.get(r["roofline"]["bottleneck"], 0) + 1
    return (f"{len(ok)} ok / {len(fail)} failed; bottleneck histogram: {bn}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    rows = load(args.mesh, args.variant, args.dir)
    print(f"## Dry-run roofline — mesh {args.mesh}, variant {args.variant}")
    print(summary(rows))
    print()
    print(table(rows))


if __name__ == "__main__":
    main()
