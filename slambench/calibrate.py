"""Readings for the limits on ``correct``: one process, many seeds.

    python3 -m slambench.calibrate --workload <name> --seeds 1,2,3 \
        --seconds <s>

runs the cell's window once per seed (set-up repeated, the kernels and
the CUDA context shared) and prints, per seed, a JSON line with the
numbers the reference compares, each episode's lost frames and ATE, and
the end-to-end readings; then the same numbers for the controls
(:mod:`slambench.reference`) over the same episodes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from slambench import reference
from slambench import run as bench_run


def control_numbers(episodes) -> dict:
    """The reference's numbers for each control, and for a 10% scale
    error, over the episodes the run returned."""
    out = {}
    for name, make in (
            ("inverted", reference.inverted_control),
            ("skipping", reference.skipping_control),
            ("scale_1.1", lambda sc, n: reference.scale_control(sc, n, 1.1))):
        out[name] = reference.judge([dict(ep, poses=make(ep["scene"],
                                                         len(ep["poses"])))
                                     for ep in episodes])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dump", default="",
                    help="write every seed's returned poses to this .npz")
    args = ap.parse_args(argv)
    dumped = {}
    bench = bench_run.load_benchmark()
    _, config, traffic, limits = bench_run.cell_files(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = bench_run.run_cell(config, traffic, seed, args.seconds, False,
                                 t_start=t0)
        import torch
        peak = torch.cuda.max_memory_allocated()
        bench_run.judge(run, limits)
        read = {m["name"]: bench_run.reader(m["name"])(run)
                for m in bench_run.metrics_of(bench, args.workload, False)}
        eps = []
        for ep in run.episodes:
            p = ep["poses"]
            gt = reference.trajectory(ep["scene"], len(p))
            eps.append([len(p), ep["lost"], round(reference.ate_rmse(
                p[:, :3], gt[:, :3, 3]) * 1e3, 2) if len(p) > 2 else None])
        print(json.dumps(dict(
            workload=args.workload, seed=seed, correct=run.correct,
            check={k: v for k, (v, _) in run.check.items()},
            judged=reference.judge(run.episodes),
            controls=control_numbers(run.episodes), metrics=read,
            episodes=eps, frames=run.frames, lost=run.lost,
            memory_peak_bytes=peak)), flush=True)
        for j, ep in enumerate(run.episodes):
            dumped[f"{seed}_{j}"] = ep["poses"]
    if args.dump:
        import numpy as np
        np.savez_compressed(args.dump, **dumped)
    return 0


if __name__ == "__main__":
    sys.exit(main())
