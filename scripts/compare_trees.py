"""Compare two checkouts of this repository on one NVIDIA card, in turns.

    python3 scripts/compare_trees.py PARENT_DIR [CHANGE_DIR]

Runs a worker process in each tree in the order parent, change, change,
parent (``CHANGE_DIR`` defaults to this checkout), so that both see the
same card, power limit and host within one call.  Each worker imports
its own tree's ``chip_smoke`` and ``gslam_tpu_torch``, builds that
tree's kernels and prints one JSON line:

- device ms of the B3 matcher on ``track_forward``'s inputs and of the
  B5 Schur reduction on the local-BA problem (C = 8, P = 1024, O = 8),
  by CUDA-graph replay (``chip_smoke.graph_ms``);
- device ms of ``track_forward``'s stages (``chip_smoke.phase_stages``;
  ``match`` is the matcher call with its PyTorch decisions);
- a warm 64-frame ``KeyframeSLAM`` run: ms/frame, the timer sections in
  ms/frame (``local_ba`` among them) and the ATE.

The last line gathers the four results with the card's name and power
limit.  A tree to compare with is unpacked with ``git archive`` into a
directory that ``.gitignore`` lists.
"""

import json
import os
import subprocess
import sys
from pathlib import Path


def worker() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from gslam_tpu_torch.models.graft import example_inputs
    from gslam_tpu_torch.ops import frontend
    from gslam_tpu_torch.ops.cuda import build, matcher, schur

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    inputs = example_inputs(cs.H, cs.W, cs.M, cs.K, device="cuda")
    img, _, _, desc, valid, _ = inputs
    f = frontend.extract_features(img, max_kps=cs.K)
    prob = cs.bench_problem()
    lam = torch.tensor(1e-3, device="cuda")
    out = {
        "matcher_ms": cs.graph_ms(lambda: matcher.hamming_top2_kernel(
            desc, valid, f.desc, f.valid)),
        "schur_ms": cs.graph_ms(lambda: schur.schur_reduce_kernel(
            prob, lam, 0.01)),
        "stages_ms": cs.phase_stages(inputs),
    }
    camera, frames = cs.load_frames()
    cs.run_slam(camera, frames)                      # warm-up
    slam, secs = cs.run_slam(camera, frames)
    n = len(frames)
    ts = [fr.timestamp for fr in frames]
    gt = [fr.gt_pose[:3] for fr in frames]
    m = cs.evaluate_trajectory(np.asarray(ts), slam.positions(),
                               np.asarray(ts), np.stack(gt),
                               with_scale=False)
    out.update(slam_ms_per_frame=secs * 1e3 / n,
               slam_split_ms_per_frame=cs.split_ms(slam, n),
               slam_ate_m=m.ate_rmse)
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "--worker":
        return worker()
    parent = Path(sys.argv[1]).resolve()
    change = Path(sys.argv[2] if len(sys.argv) > 2
                  else Path(__file__).resolve().parents[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    runs = []
    for label, tree in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)},
            capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        runs.append({"tree": label, **res})
        sp = res["slam_split_ms_per_frame"]
        print(f"{label}: matcher {res['matcher_ms']:.6f} ms, schur "
              f"{res['schur_ms']:.6f} ms, match stage "
              f"{res['stages_ms']['match']:.4f} ms, SLAM "
              f"{res['slam_ms_per_frame']:.3f} ms/frame, local_ba "
              f"{sp.get('local_ba', float('nan')):.4f} ms/frame, ATE "
              f"{res['slam_ate_m']!r} m", flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
