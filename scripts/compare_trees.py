"""Compare two checkouts of this repository on one NVIDIA card, in turns.

    python3 scripts/compare_trees.py PARENT_DIR [CHANGE_DIR]

Runs a worker process in each tree in the order parent, change, change,
parent (``CHANGE_DIR`` defaults to this checkout), so that both see the
same card, power limit and host within one call.  Each worker imports
its own tree's ``chip_smoke`` and ``gslam_tpu_torch``, builds that
tree's kernels and prints one JSON line:

- device ms, by CUDA-graph replay (``chip_smoke.graph_ms``), of B1
  FAST+NMS on ``track_forward``'s example image (480 x 640, threshold
  0.06) and on the first frame of the 64-frame SLAM sequence (threshold
  0.08), of the B3 matcher on ``track_forward``'s inputs, of the B4 gated
  matcher at N = 2048, M = 512 (``chip_smoke.gated_inputs``) and at
  N = 768, M = 384 (the first rows and keypoints of those inputs), of
  the B5 Schur reduction on the local-BA problem (C = 8, P = 1024,
  O = 8), of the B6 cost on that problem and on ``chip_smoke.SCHUR_EXTRA``'s
  (C = 32, P = 1024 and the loop run's C = 4, P = 384), and of B2 BRIEF
  on ``track_forward``'s frame at K = 512 and at its first 384
  keypoints, and of the B7 descent at N = 384 and 512 on a k = 6, L = 2
  tree and at N = 512 on a k = 8, L = 4 tree (``chip_smoke.vocab_cases``'
  trees, made here from the same seeds);
- B6's output at those three shapes as float32 hex, and a SHA-256 of
  B2's words at K = 512 and of B7's words at each of its shapes (equal
  fields show equal outputs);
- device ms of ``track_forward``'s stages (``chip_smoke.phase_stages``;
  ``match`` is the matcher call with its PyTorch decisions);
- a warm 64-frame ``KeyframeSLAM`` run: ms/frame, the timer sections in
  ms/frame (``local_ba`` among them) and the ATE.

The last line gathers the four results with the card's name and power
limit.  A tree to compare with is unpacked with ``git archive`` into a
directory that ``.gitignore`` lists.
"""

import hashlib
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
    from gslam_tpu_torch.ops import frontend, vocab
    from gslam_tpu_torch.ops.cuda import (
        brief, build, fastnms, matcher, schur,
    )
    from gslam_tpu_torch.ops.cuda import vocab as vocab_k
    from gslam_tpu_torch.ops.matching import gate_squared

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    inputs = example_inputs(cs.H, cs.W, cs.M, cs.K, device="cuda")
    img, _, _, desc, valid, _ = inputs
    f = frontend.extract_features(img, max_kps=cs.K)
    prob = cs.bench.ba_problem(torch.device("cuda"))
    lam = torch.tensor(1e-3, device="cuda")
    camera, frames = cs.load_frames()
    frame = torch.as_tensor(frames[0].image, device="cuda")
    nms, raw = fastnms.fast_nms_plain(img, cs.THRESH)
    uv = frontend.select_keypoints(nms, max_kps=cs.K, raw_score=raw)[0]
    angle = frontend.compute_orientations(img, uv)
    b2 = (frontend.gaussian_blur(img, sigma=2.0), uv, torch.cos(angle),
          torch.sin(angle))
    b2_loop = (b2[0], *(x[:384] for x in b2[1:]))
    costs = {"C8_P1024_O8": prob}
    for label, case in cs.SCHUR_EXTRA.items():
        costs[label] = cs.to_problem(cs.ba_case(**case, seed=1), "cuda")
    g = cs.gated_inputs()
    g_loop = [x[:768] for x in g[:2]] + [x[:384] for x in g[2:4]] \
        + [g[4][:768], g[5][:384]]
    gate2 = gate_squared(cs.SLAMConfig().gate_radius_px)
    out = {
        "fast_nms_ms": cs.graph_ms(lambda: fastnms.fast_nms_raw(
            img, cs.THRESH)),
        "fast_nms_slam_frame_ms": cs.graph_ms(lambda: fastnms.fast_nms_raw(
            frame, cs.SLAM_CFG["fast_threshold"])),
        "gated_ms": cs.graph_ms(lambda: matcher.gated_top2_kernel(
            *g, gate2)),
        "gated_N768_M384_ms": cs.graph_ms(lambda: matcher.gated_top2_kernel(
            *g_loop, gate2)),
        "matcher_ms": cs.graph_ms(lambda: matcher.hamming_top2_kernel(
            desc, valid, f.desc, f.valid)),
        "schur_ms": cs.graph_ms(lambda: schur.schur_reduce_kernel(
            prob, lam, 0.01)),
        "stages_ms": cs.phase_stages(inputs),
        "brief_ms": cs.graph_ms(lambda: brief.brief(*b2)),
        "brief_K384_ms": cs.graph_ms(lambda: brief.brief(*b2_loop)),
        "brief_sha256": hashlib.sha256(
            brief.brief(*b2).cpu().numpy().tobytes()).hexdigest(),
        "ba_cost_ms": {}, "ba_cost_hex": {},
    }
    for label, p in costs.items():
        out["ba_cost_ms"][label] = cs.graph_ms(
            lambda: schur.ba_cost_kernel(p, 0.01))
        bits = schur.ba_cost_kernel(p, 0.01).cpu().numpy().view(np.uint32)
        out["ba_cost_hex"][label] = f"0x{int(bits):08x}"
    rng = np.random.default_rng(11)
    voc_loop = vocab.train_vocabulary(cs.random_words(rng, 4000), k=6, L=2,
                                      seed=0, device="cuda")
    voc_big = vocab.train_vocabulary(cs.random_words(rng, 40000), k=8,
                                     L=4, seed=0, device="cuda")
    out["bow_descent_ms"], out["bow_descent_sha256"] = {}, {}
    for seed, (label, voc, N) in enumerate((
            ("N384_k6_L2", voc_loop, 384), ("N512_k6_L2", voc_loop, 512),
            ("N512_k8_L4", voc_big, 512)), start=20):
        d, v = cs.descent_case(voc, N, seed, 0.1)

        def b7(voc=voc, d=d, v=v):
            return vocab_k.transform_words_kernel(voc.node_desc, d, v,
                                                  voc.k, voc.L)

        out["bow_descent_ms"][label] = cs.graph_ms(b7)
        out["bow_descent_sha256"][label] = hashlib.sha256(
            b7().cpu().numpy().tobytes()).hexdigest()
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
        print(f"{label}: fast_nms {res['fast_nms_ms']:.6f} ms (SLAM frame "
              f"{res['fast_nms_slam_frame_ms']:.6f}), gated "
              f"{res['gated_ms']:.6f} ms (N=768, M=384 "
              f"{res['gated_N768_M384_ms']:.6f}), matcher "
              f"{res['matcher_ms']:.6f} ms, schur "
              f"{res['schur_ms']:.6f} ms, ba_cost {res['ba_cost_ms']} ms "
              f"{res['ba_cost_hex']}, brief {res['brief_ms']:.6f} ms "
              f"(K=384 {res['brief_K384_ms']:.6f}) words "
              f"{res['brief_sha256'][:16]}, bow_descent "
              f"{res['bow_descent_ms']} ms words "
              f"{ {k: v[:16] for k, v in res['bow_descent_sha256'].items()} }"
              f", match stage "
              f"{res['stages_ms']['match']:.4f} ms, SLAM "
              f"{res['slam_ms_per_frame']:.3f} ms/frame, local_ba "
              f"{sp.get('local_ba', float('nan')):.4f} ms/frame, ATE "
              f"{res['slam_ate_m']!r} m", flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
