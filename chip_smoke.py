"""Smoke run of gslam_tpu_torch on one NVIDIA card: build, check, time.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; each prints its seconds):

1. print the card's name and power limit; build the seven CUDA sources
   (``gslam_tpu_torch/csrc/*.cu``: six with the seven ported kernels and
   ``probe.cu``, one ``nvcc`` each, in parallel), print each kernel's
   register / shared-memory use and B5's scratch at C = 8 and C = 32
   (which must stay under 12 MB); then the probes: the launch floor (an
   empty kernel, timed by graph replay like every kernel here) and the
   card's integer rates per clock and SM (the Hamming step xor, popc,
   add, and plain integer operations), which the operation bounds of
   B3, B4 and B7 are stated against;
2. the tracking step ``track_forward`` (480 x 640 image, K = 512
   keypoints, a 2048-entry map slab): hold B1 FAST+NMS (bit for bit on
   both maps, twice for the same bits), B2 BRIEF (bit for bit, also at
   the loop run's K = 384) and B3 matcher against
   their plain versions (B3 also at N = 333, M = 1000 with equal minima
   on both sides of its tile borders, with the valid columns in one
   tile only and in one column only, and two calls on the same inputs
   bit for bit), drive the step once through the kernels (launch
   counters set to 0 just before, read just after), check the
   example's identity pose and the plain path, time it;
3. hold B4 (gated matcher, N = 2048 map rows against M = 512 keypoints
   near their projections, gate 40 px; also at the loop run's N = 768,
   M = 384 and at M = 2500, more keypoints than it stages at once; each
   twice for the same bits), B5 (Schur reduction) and B6 (BA
   cost) against their plain versions on the local-BA problem of
   ``bench.py`` (C = 8, P = 1024, O = 8); both also at C = 32, P = 1024,
   O = 8 (the widest camera count of their contract; six cameras per
   point, repeated cameras, pad slots) and at the loop run's C = 4,
   P = 384, each twice for the same bits; B6 also bit for bit against
   the float32 model of its summation order (``cost_order``); and
   ``bundle_adjust`` with the kernels against the plain LM for 6
   iterations;
4. hold B1 bit for bit on the first frame of the full-width RGB-D
   sequence at the SLAM threshold; drive ``KeyframeSLAM`` over the first
   64 frames of that sequence (480 x 640 ``ring_out``, 1200 points,
   textured, depth; ``max_kps`` 512, ``local_map_size`` 2048,
   ``ba_points`` 1024, ``ba_window`` 8, ``ba_iters`` 6, ``kf_max_gap``
   8, ``cap_frames`` 64), launch counters around it: B1, B2, B4, B5 and
   B6 all launched, >= 90% of frames tracked, >= 3 keyframes and local
   BA ran, and the ATE within ``max(0.05, 2 ref + 0.01)`` of the JAX
   package's run;
5. time two more, warm SLAM runs with the kernels (their ATE must equal
   the first run's bit for bit) and one with the plain versions
   (ms/frame, frames/s, split by timer section), the device busy share
   under torch.profiler, and every kernel's device time (CUDA events
   around replays of a CUDA graph of many calls) beside its plain
   version, its bound and the launch floor, B5, B6, B3, B4, B1 (the
   SLAM frame) and B2 at their extra shapes too; B1's bound counts the arc
   sums only at the starts that qualify on its input;
6. pyramid: hold B1 bit for bit on the three level images of the first
   frame's pyramid (480x640, 384x512, 307x410: 410 is not a multiple of
   4) and B2 bit for bit at each level's keypoint budget; drive
   ``KeyframeSLAM`` with ``n_levels`` 3, ``pyramid_scale`` 1.25 over the
   64 frames, launch counters around it: B1 and B2 three times a frame,
   B4, B5 and B6 launched, >= 90% tracked, >= 3 keyframes, the ATE within
   ``max(0.05, 2 ref + 0.01)`` of the JAX package's run; then warm runs
   in turns (kernels, plain, kernels), the kernel runs repeating the ATE
   bit for bit (ms/frame, split by timer section);
7. hold B7 (BoW tree descent) against its plain version, word for
   word, at the loop path's shape (N = 384 descriptors, k = 6, L = 2)
   and at k = 8, L = 4 (4681 nodes; N = 512, and an odd N with invalid
   rows), on vocabularies trained here from seeded random descriptors;
8. batched dispatch: drive ``KeyframeSLAM.track_batch`` over all 192
   frames of that sequence with ``dispatch_batch`` 8 (the reference's
   full-system cell, bench.py:136-151), its K-frame body replayed as one
   CUDA graph; launch counters around the run (the graph's captured
   launches times its replays): B1, B2, B4, B5 and B6 launched, 192
   finite poses, >= 90% of frames tracked, >= 3 keyframes, at least one
   dispatch that took every frame before its K-th (kf_max_gap = K = 8,
   so the K-th frame of a dispatch after a keyframe always needs one),
   and the ATE within ``max(0.05, 2 ref + 0.01)``
   of the JAX package's batched run; a second run repeats the ATE bit
   for bit; the graph's capture time, node count and memory pool are
   printed.  Then the graph against the same body run eagerly on one
   batch of 8 frames with the same uniforms, every output bit for bit;
   then sequential ``track`` against ``track_batch`` over the 192 frames
   in turns (sequential, batched, batched, sequential: ms/frame,
   frames/s, split by timer section) and the device busy share of each
   over 24 warm frames;
9. monocular: ``KeyframeSLAM`` over 48 depth-free frames of the ``line``
   motion at 480 x 640 over 3000 untextured points (same configuration,
   one frame a call) with the JAX package's RANSAC draws of its
   reference run replayed (``tests/data/mono_draws.npz``), launch
   counters around it: the two-view bootstrap, >= 3 keyframes, B1, B2,
   B4, B5 and B6 launched, no fewer tracked frames than the JAX
   package's run less 5 and the ATE after scale alignment within
   ``max(0.05, 2 ref + 0.01)`` of its; then, printed, the same frames
   with the system's own draws and the textured 1200-point scene of the
   64-frame cell (a mono run's outcome turns on its draws, there in both
   packages);
10. visual-inertial: ``KeyframeSLAM`` over 64 frames of the ``line``
    motion at 480 x 640 (1200 textured points, depth, IMU windows of 10
    samples a frame, noise 0.01; the 64-frame configuration with
    ``vi_min_factors`` 6, ``kf_min_gap`` 2, ``kf_max_gap`` 6), launch
    counters around it and around each VI LM call: VI initialized,
    |gravity| within 0.2 of 9.81 and its cosine to the true direction
    above 0.96, one IMU factor and one loop edge per keyframe pair (at
    least keyframes - 2), at least one VI local BA with B5 and B6
    launched inside it, the ATE within ``max(0.05, 2 ref + 0.01)`` of
    the JAX package's run, the same ATE bit for bit in a second run;
    ms/frame, ``slam/local_ba`` and its share of the wall, the last VI
    LM's cost history;
11. lens models: ``project`` / ``unproject`` of the pinhole, ATAN,
    OpenCV and OCAM models (tests/test_geometry.py's calibrations) over a
    480 x 640 pixel grid, the Freiburg-1 ``Undistorter`` on one VGA frame
    and the two ``StereoRectifier`` remaps of the rotated, distorted rig
    of tests/test_datasets_eval.py:350, each on the card against the
    same call on the CPU (max abs error printed, gated at a few float32
    ulps), with the card's time of each;
12. the hard distorted gate of tests/test_slam_e2e.py:527-549 at full
    width, not cut: ``KeyframeSLAM`` over 40 frames of the ``line``
    motion at 480 x 640 through the OpenCV camera (k1 -0.25, k2 0.08;
    textured, exposure 0.15, 600 points) with that test's configuration,
    launch counters around it, twice with the same ATE bit for bit; then
    through ``track_batch`` with 8 a dispatch (the OpenCV model inside
    the captured body), counters around it; then the graph against its
    eager body on one batch, bit for bit.  Gates: >= 90% tracked, >= 4
    keyframes, the ATE within ``max(0.05, 2 ref + 0.01)`` of the JAX
    package's run and under the test's own 0.20 m;
13. the main path from files: 64 frames of that scene written in the TUM
    RGB-D layout (8-bit RGB and 16-bit depth PNGs by a standard-library
    writer, rgb.txt, depth.txt, groundtruth.txt, calib.txt) into a
    temporary directory, the native decoder built from
    ``native/gslam_native.cpp``, the directory opened with
    ``open_dataset(dir + ".tumrgbd")``: every decoded frame equal to what
    was written, the camera OpenCV; decode ms/frame (the player, the
    colour files alone, their gray, ``NativeLoader``'s readahead), then
    ``KeyframeSLAM`` over the decoded frames, counters around it, the ATE
    within ``max(0.05, 2 ref + 0.01)`` of the JAX package's run over the
    same files, track ms/frame beside decode ms/frame;
14. the app layer, the user's own entry points over those files:
    ``python -m gslam_tpu_torch eval -dataset <dir>.tumrgbd -slam
    keyframe -slam.<field> ...`` (phase 13's configuration) in a process
    of its own, its saved trajectory the same text as phase 13's run,
    its report's ATE within the same gate, a metrics row a frame, its
    saved map loadable; ``cli.main(["viz", ...])`` in this process with
    the same flags, launch counters around it (B1, B2, B4, B5, B6), the
    same trajectory, the HTML viewer (its embedded JSON parsed), both
    PLYs and the PNG; ``SLAMPipeline`` fed by ``DatasetPlayer(rate=0)``,
    its published poses bit for bit phase 13's, ids in order, a map
    message; ``play -vocabulary`` (a vocabulary trained as phase 15's
    from the first frames) over 16 frames, counters around it (B7 among
    them); the port's bench line (``gslam_tpu_torch.bench``, on the
    192-frame scene of phase 8); ``graft_entry.entry()``'s step bit for
    bit phase 2's; ``graft_entry.dryrun_multichip(1)`` on a world of one
    (NCCL);
15. drive ``KeyframeSLAM`` with a vocabulary over the two-lap sequence
    of ``tests/test_longrun.py::test_kitti00_shaped_two_lap_run`` (1024
    frames 480 x 640 ``ring_out``, lap 2 revisits lap 1; vocabulary k =
    6, L = 2 trained from the first 6 frames' features; ``max_kps`` 384,
    ``ba_window`` 4, ``cap_frames`` 256, stock loop-closer settings),
    frames rendered one at a time, launch counters around the run: B1,
    B2, B4, B5, B6 and B7 all launched, >= 100 keyframes, no arena
    overflow, >= 2 loop closures, ATE of the corrected trajectory under
    1.5 m; then kidnap the tracker (a bogus pose, a dead motion model),
    feed frames from the far side of the ring and require BoW
    relocalization to bring the pose back through B7;
16. the other SLAM systems, each run twice with the same ATE bit for
    bit and launch counters around the first: ``FrameToFrameOdometry``
    over the 64 frames of phase 4 with depth (PnP) and without (two-view
    geometry, the JAX package's draws replayed from
    ``tests/data/odometry_mono_draws.npz``; ATE after Sim3 alignment), B1
    and B2 once a frame, B3 once a frame after the first, B3 held against
    its plain version at the 512 x 512 keypoints of frames 0 and 1, then
    ms/frame in turns (kernels, plain, kernels); ``DirectOdometry`` (plain
    PyTorch, no kernel) over those 64 frames and over 64 frames of the
    ``line`` motion, >= 90% of frames valid, device operations a frame and
    busy share; ``StereoSLAM`` over 48 textured frames of KITTI 00's
    rectified geometry (1241 x 376, fx 718.856, baseline 0.54 m), two B1
    and two B2 launches a frame, B4-B6 launched, > 50 map points, B1 held
    bit for bit at that width; ``GlobalSfM`` over the 10-frame orbit of
    tests/test_sfm.py (256 x 192; the JAX package's pair draws replayed
    from ``tests/data/sfm_draws.npz``), B3 once a pair, B5 and B6 in each
    of three global BA rounds, >= 9 edges, B1, B3 and B5 / B6 held at its
    shapes (B5 on the global BA's own problem, C = 10); each with the ATE
    within ``max(0.05, 2 ref + 0.01)`` of the JAX package's run (stereo
    also under 0.12 m, SfM under 0.30 m);
17. the fleet (the reference's ``__graft_entry__.dryrun_multichip`` at
    full width): ``KeyframeSLAM`` over the 64 frames of phase 4 and over
    64 frames of the same scene from seed 11, the maps merged with
    ``merge_arenas`` (b placed 50 m along x), launch counters around
    every run below; global BA over the merged map (every keyframe, 4096
    points a solve, 16 slots) through the psum variant on a world of one
    (NCCL), against the plain path on the same map, the keyframe ATE
    (each sequence SE3-aligned) within ``max(0.05, 2 ref + 0.01)`` of the
    JAX package's run and the reference's centre test; the ring variant
    with B5's partials entry and B6 on the merged map's global problem on
    worlds of 1 (NCCL), 2 and 4 (gloo, every rank on the one card, each
    hop through the host), each twice for the same bits, against the
    single-device ``bundle_adjust`` with the kernels (poses 1e-3, costs
    rtol 0.05); B5's partials entry against its plain version at C = 4,
    8, 32 and with ring pad cameras, assembled bit for bit
    ``gslam_schur``'s S and b, over four point blocks within
    tolerance; ``sharded_track_batch`` of 8 frames at the tracking
    step's shapes on a world of one, bit for bit 8 ``track_forward``
    calls;
18. print the slices' JSON lines (the probes and the extra shapes'
    times among them), the ``kernels`` JSON line (with each kernel's
    launches on every phase's main path), then the device JSON as the
    last line.

Needs a CUDA card, ``nvcc`` and ``g++``; without a card it exits non-zero
before printing any result.  The fleet phase starts its ranks as new
processes on the same card (``gslam_tpu_torch.parallel.launch.spawn``)
and waits for each to end.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gslam_tpu_torch.app.registry import SLAMS, open_dataset
from gslam_tpu_torch.core.camera import Camera, pinhole_unproject
from gslam_tpu_torch.core.image import to_gray_f32
from gslam_tpu_torch.core.imu import preintegrate_full
from gslam_tpu_torch.core.se3 import se3_apply, se3_inverse
from gslam_tpu_torch.core.undistort import StereoRectifier, Undistorter
from gslam_tpu_torch.estimation.pnp import (
    _p3p_grunert, pnp_reproj_error, refine_pose_gn,
)
from gslam_tpu_torch.estimation.ransac import run_ransac
from gslam_tpu_torch.map.arena import (
    arena_from_numpy, arena_stats, arena_to_numpy, merge_arenas,
)
from gslam_tpu_torch.datasets import native_loader
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch import bench
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.graft_entry import FLEET_ALIGN, FLEET_SEEDS
from gslam_tpu_torch.models import keyframe_slam
from gslam_tpu_torch.models.direct import DirectConfig, DirectOdometry
from gslam_tpu_torch.models.graft import example_inputs, track_forward
from gslam_tpu_torch.models.keyframe_slam import (
    BatchGraph, KeyframeSLAM, SLAMConfig, tensor_leaves,
)
from gslam_tpu_torch.models.odometry import FrameToFrameOdometry
from gslam_tpu_torch.models.sfm import GlobalSfM
from gslam_tpu_torch.ops import frontend, vocab
from gslam_tpu_torch.ops.cuda import brief, build, fastnms, matcher, schur
from gslam_tpu_torch.ops.cuda import vocab as vocab_k
from gslam_tpu_torch.ops.matching import (
    gate_squared, hamming_top2, hamming_top2_gated, match_descriptors,
)
from gslam_tpu_torch.opt import ba
from gslam_tpu_torch.opt.robust import huber_weight
from gslam_tpu_torch.opt.vi import ViProblem, stack_factors
from gslam_tpu_torch.parallel import (
    dist_ba, distributed_bundle_adjust_ring, launch, make_dp_mesh, make_mesh,
    sharded_track_batch,
)
from gslam_tpu_torch.utils.platform import card_name_and_power_limit
from gslam_tpu_torch.utils.png import write_png

H, W, M, K, B = 480, 640, 2048, 512, 256
DEVICE = "cuda"
# threads that render the synthetic sequences' views ahead of the reads
# (SyntheticDataset.render_ahead: the same frames, bit for bit)
RENDER_THREADS = min(8, os.cpu_count() or 1)
THRESH = 0.06
PNP_THRESH = 2e-5

# the full-width RGB-D sequence and configuration of bench.py:136-145,
# tracked one frame per call (dispatch_batch 1)
SLAM_FRAMES = 64
SEQUENCE = dict(n_frames=192, n_points=1200, width=640, height=480,
                motion="ring_out", depth=True, texture=True, radius=14.0,
                world_extent=8.0, laps=1, noise=0.01)
SLAM_CFG = dict(max_kps=512, fast_threshold=0.08, local_map_size=2048,
                ba_points=1024, ba_window=8, ba_iters=6, ba_obs_per_point=8,
                kf_max_gap=8, cap_frames=64, cap_points=16384,
                cap_obs=65536, dispatch_batch=1)
# ATE (m) of the JAX package's KeyframeSLAM (gslam_tpu, plain jnp path)
# over the same 64 frames and configuration, computed on a CPU by
# ``python tests/test_torch_slam.py --reference-ate``; an accuracy
# figure, not a speed figure.  Gate of tests/test_slam_e2e.py:146.
REF_ATE = 0.0869997888803482
ATE_GATE = max(0.05, 2.0 * REF_ATE + 0.01)

# the reference's full-system cell (bench.py:136-151): all 192 frames of
# that sequence, 8 frames a track_batch dispatch, the same configuration
BATCH_K = 8
BATCH_CFG = dict(SLAM_CFG, dispatch_batch=BATCH_K)
# ATE (m) of the JAX package's track_batch over the same 192 frames and
# configuration, computed on a CPU by ``python
# tests/test_torch_slam.py --reference-ate-batched`` (24 keyframes, 191
# frames tracked); an accuracy figure, not a speed figure
REF_ATE_BATCHED = 0.15867488086223602
ATE_GATE_BATCHED = max(0.05, 2.0 * REF_ATE_BATCHED + 0.01)
BATCH_PROFILE_FRAMES = 24
BATCH_EAGER_AT = 16     # the graph against the eager body: frames 16-23

# the monocular run: 48 depth-free frames of the line motion (the
# reference loses ring_out and orbit without depth) over 3000 untextured
# points, SLAM_CFG, one frame a call.  On the textured 1200-point scene
# of the 64-frame cell the run turns on the RANSAC draws, in both
# packages (PERF.md section 6, PR 8): it is run too, and printed
MONO_SEQUENCE = dict(n_frames=48, n_points=3000, width=640, height=480,
                     motion="line", depth=False, texture=False, noise=0.01)
MONO_TEXTURED = dict(MONO_SEQUENCE, n_points=1200, texture=True)
# the JAX package's run of the same frames (``python
# tests/test_torch_slam.py --reference-ate-mono``, CPU): ATE after scale
# alignment (m), frames tracked with at least min_track_inliers inliers
REF_ATE_MONO = 0.17913846671581268
REF_TRACKED_MONO = 46
ATE_GATE_MONO = max(0.05, 2.0 * REF_ATE_MONO + 0.01)
# that run's RANSAC draws (``python tests/test_torch_slam.py
# --reference-draws-mono`` writes them), replayed in the gated run: the
# scaled ATE of a mono run turns on its draws (0.12 to 0.70 m over the
# port's seeds, 0.18 to 0.36 m over the JAX package's; PERF.md)
MONO_DRAWS = Path(__file__).resolve().parent / "tests/data/mono_draws.npz"

# the 64-frame cell with pyramid extraction: three levels at scale 1.25,
# so B1 and B2 run once per level, at 480x640, 384x512 and 307x410 (410
# is not a multiple of 4: B1's 4-byte loads), B2 at the level budgets
PYRAMID_CFG = dict(SLAM_CFG, n_levels=3, pyramid_scale=1.25)
# ATE (m) of the JAX package's run of the same 64 frames with the same
# configuration, computed on a CPU by ``python tests/test_torch_slam.py
# --reference-ate-pyramid``; an accuracy figure, not a speed figure
REF_ATE_PYRAMID = 0.09382911026477814
ATE_GATE_PYRAMID = max(0.05, 2.0 * REF_ATE_PYRAMID + 0.01)

# the visual-inertial run: 64 frames of the line motion at 480x640 with
# ground-truth IMU windows (10 samples a frame), SLAM_CFG with the VI
# settings of tests/test_slam_e2e.py:465-466; local BA turns into the
# joint VI LM (B5 per iteration, B6 per cost) once gravity is aligned
VI_SEQUENCE = dict(n_frames=64, n_points=1200, width=640, height=480,
                   motion="line", depth=True, texture=True, imu=True,
                   noise=0.01)
VI_CFG = dict(SLAM_CFG, vi_min_factors=6, kf_min_gap=2, kf_max_gap=6)
# ATE (m) of the JAX package's run of the same frames (``python
# tests/test_torch_slam.py --reference-ate-vi``, CPU); an accuracy
# figure, not a speed figure
REF_ATE_VI = 0.015885187312960625
ATE_GATE_VI = max(0.05, 2.0 * REF_ATE_VI + 0.01)
GRAVITY_TRUE = np.asarray([0.0, 0.0, -9.81])

# the reference's hard synthetic gate (tests/test_slam_e2e.py:527-549),
# not cut: 40 frames of the line motion at 480x640 through a radially
# distorted OpenCV camera (k1 -0.25, k2 0.08), textured, exposure jitter
# 0.15, 600 points, depth, and that test's configuration; the OpenCV
# project / unproject run inside the tracking (and the batch graph)
DISTORTED_SEQUENCE = dict(n_frames=40, n_points=600, width=640, height=480,
                          motion="line", depth=True, texture=True,
                          exposure=0.15, distortion=[-0.25, 0.08])
DISTORTED_CFG = dict(max_kps=384, fast_threshold=0.08, ba_window=4,
                     ba_points=512, ba_iters=3, cap_frames=32,
                     cap_points=8192, cap_obs=32768, local_map_size=768,
                     kf_max_gap=6)
DISTORTED_BATCH_CFG = dict(DISTORTED_CFG, dispatch_batch=BATCH_K)
DISTORTED_EAGER_AT = 16  # the graph against the eager body: frames 16-23
# ATE (m) of the JAX package's runs of the same frames, one a call and
# through track_batch (``python tests/test_torch_slam.py
# --reference-ate-distorted`` and ``--reference-ate-distorted-batched``,
# CPU); accuracy figures, not speed figures.  The test's own bar is 0.20 m
REF_ATE_DISTORTED = 0.021682703867554665
REF_ATE_DISTORTED_BATCHED = 0.022814733907580376
ATE_BAR_DISTORTED = 0.20
ATE_GATE_DISTORTED = min(max(0.05, 2.0 * REF_ATE_DISTORTED + 0.01),
                         ATE_BAR_DISTORTED)
ATE_GATE_DISTORTED_BATCHED = min(
    max(0.05, 2.0 * REF_ATE_DISTORTED_BATCHED + 0.01), ATE_BAR_DISTORTED)

# the main path from files on disk: 64 frames of that scene written in
# the TUM RGB-D layout (gslam_tpu/datasets/tum_rgbd.py:1-16: 8-bit RGB
# PNGs, 16-bit depth PNGs at 5000 a metre, rgb.txt, depth.txt,
# groundtruth.txt, and a calib.txt with the synthetic camera's
# "fx fy cx cy k1 k2 0 0 0"), read back through
# open_dataset(dir + ".tumrgbd"), tracked with DISTORTED_CFG
TUM_SEQUENCE = dict(DISTORTED_SEQUENCE, n_frames=64)
# depth files are stamped 5 ms after their colour frame (TUM's sensors
# stamp the two streams apart; the loader associates within 20 ms)
TUM_DEPTH_DT = 0.005
# ATE (m) of the JAX package's KeyframeSLAM over the same files read
# through its own open_dataset (``python tests/test_torch_slam.py
# --reference-ate-tum``, CPU); an accuracy figure
REF_ATE_TUM = 0.023739947006106377
ATE_GATE_TUM = max(0.05, 2.0 * REF_ATE_TUM + 0.01)

# frame-to-frame odometry (BASELINE config #1) over the 64 frames of the
# KeyframeSLAM cell: depth mode (PnP on the previous frame's depth), then
# mono mode on the same frames without their depth (two-view geometry,
# |t| = scale_hint a step, ATE after Sim3 alignment); B1, B2 once a
# frame, B3 (the all-pairs matcher) once a frame after the first
ODOM_CFG = dict(max_kps=512, fast_threshold=0.08)
# ATE (m) of the JAX package's odometry over the same frames (``python
# tests/test_torch_slam.py --reference-ate-odometry`` and
# ``--reference-ate-odometry-mono``, CPU); accuracy figures.  The mono
# run replays that run's draws (``--reference-draws-odometry-mono``
# writes them): a mono run's outcome turns on its RANSAC draws
REF_ATE_ODOM = 0.05468263477087021
REF_ATE_ODOM_MONO = 1.6413596868515015
ATE_GATE_ODOM = max(0.05, 2.0 * REF_ATE_ODOM + 0.01)
ATE_GATE_ODOM_MONO = max(0.05, 2.0 * REF_ATE_ODOM_MONO + 0.01)
ODOM_MONO_DRAWS = Path(__file__).resolve().parent / \
    "tests/data/odometry_mono_draws.npz"

# stereo SLAM (BASELINE config #3) on KITTI odometry's rectified
# geometry: 1241 x 376 pixels, fx = fy = 718.856 (KITTI's published
# calibration of sequence 00, P0; here as a horizontal field of view),
# baseline 0.54 m; 48 frames of the line motion without depth images,
# textured, noise 0.01; SLAM_CFG.  The right image runs B1 / B2 too, so
# two of each a frame; 1241 is not a multiple of 4 (B1's 4-byte loads)
KITTI00_FX = 718.856
STEREO_SEQUENCE = dict(n_frames=48, n_points=1200, width=1241, height=376,
                       fov_deg=2.0 * np.degrees(np.arctan(1241 / 2.0
                                                          / KITTI00_FX)),
                       motion="line", depth=False, stereo=True, baseline=0.54,
                       texture=True, noise=0.01)
# ATE (m) of the JAX package's StereoSLAM over the same frames (``python
# tests/test_torch_slam.py --reference-ate-stereo``, CPU); the JAX
# test's own bar is 0.12 m (tests/test_slam_e2e.py:256)
REF_ATE_STEREO = 0.009211651049554348
ATE_BAR_STEREO = 0.12
ATE_GATE_STEREO = min(max(0.05, 2.0 * REF_ATE_STEREO + 0.01), ATE_BAR_STEREO)

# direct odometry over the 64 frames of the KeyframeSLAM cell with
# DirectConfig's defaults (1024 points, 3 levels at scale 2, 12 GN steps
# a level, the depth residual on); plain PyTorch, as the reference is
# plain jnp.  ATE (m) of the JAX package's run (``python
# tests/test_torch_slam.py --reference-ate-direct``, CPU)
REF_ATE_DIRECT = 2.009354591369629
ATE_GATE_DIRECT = max(0.05, 2.0 * REF_ATE_DIRECT + 0.01)
# the same system over 64 frames of the line motion at 480 x 640 (VI_
# SEQUENCE's scene without IMU windows): small motion between frames,
# the setting a direct method is built for (``--reference-ate-direct-
# line``)
DIRECT_LINE_SEQUENCE = dict(n_frames=64, n_points=1200, width=640,
                            height=480, motion="line", depth=True,
                            texture=True, noise=0.01)
REF_ATE_DIRECT_LINE = 0.0019683917053043842
ATE_GATE_DIRECT_LINE = max(0.05, 2.0 * REF_ATE_DIRECT_LINE + 0.01)

# global SfM over the first 10 frames of tests/test_sfm.py's orbit (SEQ,
# :24, 256 x 192, 800 points) with the settings of its e2e test (:120):
# every pair through B3 (384 x 384), global BA through B5 / B6 at C = 10
# (three rounds).  ATE (m) after Sim3 alignment of the JAX package's run
# (``python tests/test_torch_slam.py --reference-ate-sfm``, CPU), whose
# pair draws the run replays (``--reference-draws-sfm`` writes them):
# the outcome turns on the draws, in both packages
SFM_SEQUENCE = dict(n_frames=24, n_points=800, width=256, height=192,
                    motion="orbit", depth=False)
SFM_FRAMES = 10
SFM_KW = dict(max_kps=384, fast_threshold=0.08, min_pair_inliers=15,
              ba_iters=10)
REF_ATE_SFM = 0.06321600079536438
ATE_BAR_SFM = 0.30
ATE_GATE_SFM = min(max(0.05, 2.0 * REF_ATE_SFM + 0.01), ATE_BAR_SFM)
SFM_DRAWS = Path(__file__).resolve().parent / "tests/data/sfm_draws.npz"
# the same orbit at the width of the other VGA cells: 640 x 480, 1200
# points, max_kps 512 (B3 at 512 x 512, B5 / B6 at C = 10 over some 700
# tracks), the same pair draws (they depend on the seed and the pair
# count alone).  ATE (m) after Sim3 alignment of the JAX package's run
# (``python tests/test_torch_slam.py --reference-ate-sfm-wide``, CPU):
# 2.12 m, lost (a constant trajectory scores 2.92 m; on seeds 0-7 the
# JAX package gives 0.34-2.12 m, ``python tests/test_torch_sfm.py
# --seed-spread full``), so 2 ref + 0.01 would pass any answer and the
# ATE here is printed, not gated; its other gates hold
SFM_WIDE_SEQUENCE = dict(SFM_SEQUENCE, width=640, height=480, n_points=1200)
SFM_WIDE_KW = dict(SFM_KW, max_kps=512)
REF_ATE_SFM_WIDE = 2.123727560043335

# the fleet cell (the reference's __graft_entry__.dryrun_multichip at full
# width): the 64-frame cell's sequence (SyntheticDataset's seed 3) and the
# same scene from the reference's second seed (11), each tracked by
# KeyframeSLAM, merged with b placed 50 m along x, then global BA over the
# merged map (every keyframe, at most MAX_CAMS; 4096 points a solve; 16
# slots a point) through the psum variant on a world of one, and the ring
# variant with the kernels on the merged map's global problem (the seeds
# and the placement, FLEET_SEEDS and FLEET_ALIGN, are graft_entry's)
FLEET_GBA = dict(iters=4, max_points=4096, max_obs_per_point=16)
FLEET_RING_ITERS = 8
FLEET_WORLDS = (1, 2, 4)
FLEET_TRACK_B = 8
# keyframe ATE (m, fleet_ate) of the JAX package's fleet run at this size
# on a CPU (its psum variant on a (1, 1) mesh): ``python
# tests/test_torch_slam.py --reference-ate-fleet``
REF_ATE_FLEET = 0.055166078479649834
ATE_GATE_FLEET = max(0.05, 2.0 * REF_ATE_FLEET + 0.01)

# the two-lap loop-closure run of tests/test_longrun.py:34-54 (the JAX
# package's own loop-closure configuration), stock loop-closer settings
LOOP_SEQUENCE = dict(n_frames=1024, n_points=1200, width=640, height=480,
                     motion="ring_out", depth=True, texture=True,
                     radius=14.0, world_extent=8.0, laps=2, noise=0.01)
LOOP_CFG = dict(max_kps=384, fast_threshold=0.08, ba_window=4,
                ba_points=384, ba_iters=2, cap_frames=256, cap_points=16384,
                cap_obs=65536, local_map_size=768, kf_max_gap=8)
LOOP_VOC = dict(k=6, L=2, frames=6, max_kps=256, threshold=0.08, seed=0)
# gates of that test
LOOP_MIN_KEYFRAMES, LOOP_MIN_CLOSURES, LOOP_ATE_GATE = 100, 2, 1.5
# the kidnap: frames from the far side of the ring (a quarter of the
# sequence = half of lap 1), accepted within this distance of where the
# corrected trajectory places that frame (the ring's diameter is 28 m)
KIDNAP_FRAME, KIDNAP_TRIES, KIDNAP_TOL_M = 256, 5, 3.0
# B7 at the top of the JAX package's contract (4681 nodes, 4096 words),
# at a DBoW-sized tree (1.1 M nodes) of which the kernel reads only the
# top levels whole, and at the verification's landmark slab
# (models/loop_closure.py: verify's max_points)
VOC_BIG = dict(k=8, L=4)
VOC_DEEP = dict(k=10, L=6)
VERIFY_SLAB = 512
VOCAB_TIMED = ("loop", "slab", "big", "deep")   # cases of vocab_cases

# peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # outside the tensor cores
N_SMS = 132
# integer rates of this card and the launch floor (ms), set by
# phase_probe (measured: see there)
INT_RATES = {}
LAUNCH_FLOOR_MS = [float("nan")]

# extra shapes the redesigned kernels are held to: B5 at the widest
# camera count of its contract (a global BA of 32 keyframes) and at the
# loop run's window; B3 off the tile grid, with ties across tile borders
SCHUR_EXTRA = {"C32_P1024_O8": dict(C=32, P=1024, O=8, window=6, pads=True),
               "C4_P384_O8": dict(C=4, P=384, O=8, window=4, pads=False)}
SCHUR_SCRATCH_MAX_MB = 12.0
MATCHER_EXTRA = dict(N=333, M=1000)
# B2 at the loop run's max_kps (and B6 at SCHUR_EXTRA's problems)
BRIEF_LOOP_K = 384
# B4 at the loop run's shape (local_map_size 768, max_kps 384) and with
# more keypoints than its staging tile
GATED_EXTRA = {"gated_matcher_N768_M384": (768, 384),
               "gated_matcher_N2048_M2500": (2048, 2500)}

KERNELS = {
    "fast_nms": dict(source="gslam_tpu_torch/csrc/fastnms.cu",
                     replaces="gslam_tpu/ops/pallas/fastnms.py:108"),
    "brief": dict(source="gslam_tpu_torch/csrc/brief.cu",
                  replaces="gslam_tpu/ops/pallas/brief.py:148"),
    "matcher": dict(source="gslam_tpu_torch/csrc/matcher.cu",
                    replaces="gslam_tpu/ops/pallas/matcher.py:66"),
    "gated_matcher": dict(source="gslam_tpu_torch/csrc/gated.cu",
                          replaces="gslam_tpu/ops/pallas/matcher.py:137"),
    "schur": dict(source="gslam_tpu_torch/csrc/schur.cu",
                  replaces="gslam_tpu/ops/pallas/schur.py:292"),
    "ba_cost": dict(source="gslam_tpu_torch/csrc/schur.cu",
                    replaces="gslam_tpu/ops/pallas/schur.py:396"),
    # B5's partials entry: the same TPU kernel, whose partial outputs the
    # reference's ring BA sums (partials_from_outs, schur.py:418)
    "schur_partials": dict(source="gslam_tpu_torch/csrc/schur.cu",
                           replaces="gslam_tpu/ops/pallas/schur.py:292"),
    "bow_descent": dict(source="gslam_tpu_torch/csrc/vocab.cu",
                        replaces="gslam_tpu/ops/pallas/vocab.py:69"),
}
# (wrapper module, its launch counter) per kernel
COUNTERS = {"fast_nms": (fastnms, "launches"), "brief": (brief, "launches"),
            "matcher": (matcher, "launches"),
            "gated_matcher": (matcher, "gated_launches"),
            "schur": (schur, "schur_launches"),
            "ba_cost": (schur, "cost_launches"),
            "schur_partials": (schur, "partials_launches"),
            "bow_descent": (vocab_k, "launches")}
TRACK_PATH = ("fast_nms", "brief", "matcher")
SLAM_PATH = ("fast_nms", "brief", "gated_matcher", "schur", "ba_cost")
LOOP_PATH = SLAM_PATH + ("bow_descent",)
# the fleet path: two SLAM runs, the ring BA with the kernels, tracking
FLEET_PATH = SLAM_PATH + ("schur_partials", "matcher")
FLEET_RING_PATH = ("schur_partials", "ba_cost")


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 100, warm: int = 5) -> float:
    """Mean device time of ``fn()`` in ms: CUDA events around ``reps``
    back-to-back calls, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 50, replays: int = 5) -> float:
    """Mean device time of ``fn()`` in ms with the host taken out:
    ``reps`` calls captured in one CUDA graph, replayed ``replays``
    times between CUDA events."""
    fn()                                 # build and cache what fn needs
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(n_bytes: float, n_ops: float, n_words: float = 0.0,
             n_int: float = 0.0):
    """(bound in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over their rates: ``n_ops``
    float32 operations at the data sheet's rate, ``n_words`` Hamming
    steps (xor, popc, add) and ``n_int`` other integer operations at
    the rates phase_probe measured, per clock and SM, times 132 SMs and
    the card's highest SM clock."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / FP32_OPS_PER_S * 1e3
    if n_words or n_int:
        per_s = N_SMS * INT_RATES["max_sm_mhz"] * 1e6
        to += (n_words / INT_RATES["hamming_steps_per_clk_sm"]
               + n_int / INT_RATES["int_ops_per_clk_sm"]) / per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def counts():
    return {name: getattr(mod, attr) for name, (mod, attr)
            in COUNTERS.items()}


# ---------------------------------------------------------------------------
# phases


def kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled (nested) function name:
    ``_ZN12_GLOBAL__N_112gated_kernelEPKi...`` -> ``gated_kernel``."""
    s = mangled[2:] if mangled.startswith("_Z") else ""
    s = s[1:] if s.startswith("N") else s
    names = []
    while s[:1].isdigit():
        digits = re.match(r"\d+", s).group()
        n = int(digits)
        names.append(s[len(digits):len(digits) + n])
        s = s[len(digits) + n:]
    return names[-1] if names else mangled


def resource_lines(name, text):
    """The register, shared-memory and spill lines of one source's
    ``-Xptxas -v`` output, each with its kernel's name."""
    entry, out = "?", []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = kernel_name(m.group(1))
        if "registers" in line or "spill" in line or "error" in line.lower():
            out.append(f"  {name}.cu {entry}: "
                       f"{line.split(':', 1)[-1].strip()}")
    return out


def phase_build():
    log("card:", card_name_and_power_limit())
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{len(build.SOURCES)} sources")
    for name, text in logs.items():
        for line in resource_lines(name, text):
            log(line)
    for C in (8, schur.MAX_CAMS):    # B5's scratch: the blocks' partials
        n = schur._lib().gslam_schur_scratch(C, 1024)
        log(f"  schur.cu scratch at C={C}, P=1024: {n} floats "
            f"({n * 4 / 1e6:.6f} MB)")
    if n * 4 / 1e6 >= SCHUR_SCRATCH_MAX_MB:
        raise AssertionError(f"B5 scratch at C={schur.MAX_CAMS}, P=1024 is "
                             f"not under {SCHUR_SCRATCH_MAX_MB} MB")


def sm_clocks_mhz():
    """(current, highest) SM clock of the first card, as nvidia-smi
    reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    cur, top = out.strip().splitlines()[0].split(",")
    return float(cur), float(top)


def toolkit_documents():
    """Files under the CUDA toolkit's document folders whose name says
    programming manual (its arithmetic-instruction table gives the popc
    rate)."""
    found = []
    for root in ("/usr/local/cuda/doc", "/usr/local/cuda/docs",
                 "/usr/local/cuda/share/doc", "/usr/share/doc/cuda*"):
        for path in glob.glob(root + "/**", recursive=True):
            if "programming" in path.lower():
                found.append(path)
    return found


def phase_probe():
    """The launch floor (an empty kernel, timed by graph replay like
    every kernel here) and the card's integer rates per clock and SM:
    the Hamming step (xor, popc, add) and plain integer operations,
    each measured with a loop of independent chains over every SM.  The
    CUDA C++ programming manual's table gives 16 popc and 64 adds or
    logic operations per clock and SM for compute capability 9.0; the
    measured rates stand in where the toolkit's documents are absent."""
    lib = build.library("probe")
    lib.gslam_probe_empty.restype = ctypes.c_int
    lib.gslam_probe_empty.argtypes = [ctypes.c_void_p]
    lib.gslam_probe_int_loop.restype = ctypes.c_int
    lib.gslam_probe_int_loop.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]

    def empty():
        build.check_launch(lib.gslam_probe_empty(build.stream_ptr()),
                           "gslam_probe_empty")

    floor = [graph_ms(empty), graph_ms(empty)]
    docs = toolkit_documents()
    log("CUDA C++ programming manual in the toolkit's documents: "
        + (", ".join(docs) + "; integer rates measured all the same"
           if docs else "absent; integer rates measured"))
    out = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    blocks, iters = N_SMS * 8, 4096
    steps = blocks * 256 * 8 * iters
    rates = {}
    for label, popc in (("hamming_steps", 1), ("int_steps", 0)):
        def loop():
            build.check_launch(lib.gslam_probe_int_loop(
                out.data_ptr(), blocks, iters, popc, build.stream_ptr()),
                "gslam_probe_int_loop")
        ms = cuda_ms(loop, reps=20, warm=3)
        clk, top = sm_clocks_mhz()
        rates[label] = steps / (ms * 1e-3) / (N_SMS * clk * 1e6)
        log(f"probe {label}: {ms:.4f} ms for {steps} steps at {clk:.0f} MHz "
            f"(highest {top:.0f} MHz): {rates[label]:.3f} per clock and SM")
    INT_RATES.update(
        hamming_steps_per_clk_sm=rates["hamming_steps"],
        int_ops_per_clk_sm=2.0 * rates["int_steps"],    # xor and add
        max_sm_mhz=top)
    LAUNCH_FLOOR_MS[0] = min(floor)
    log(f"launch_floor_ms {floor[0]:.6f}/{floor[1]:.6f} (an empty kernel, "
        "graph replay)")
    return dict(launch_floor_ms=min(floor), **INT_RATES,
                toolkit_documents=docs)


def matcher_case(N, M, kind="ties", seed=0):
    """numpy (a, valid_a, b, valid_b) for the Hamming matcher, words as
    int32.  ``ties``: equal minima 1, 64, 128 and 256 columns apart
    (columns duplicated across the B3 kernel's 128-column tile borders,
    rows that sit on them) and 1, 32, 64, 128 and 256 rows apart (rows
    duplicated across its 32-row borders, columns that sit on them),
    noisy copies, a tenth of each side masked.  ``one_tile``: only
    columns 130 to 139 valid (the last two where M is smaller).
    ``one_column``: only the last column valid."""
    rng = np.random.default_rng(seed)
    a, b = random_words(rng, N), random_words(rng, M)
    va, vb = rng.random(N) < 0.9, rng.random(M) < 0.9
    if kind == "ties":
        n_copy = min(N // 4, M)
        src = rng.integers(0, M, n_copy)
        a[:n_copy] = b[src]
        a[:n_copy // 2, 0] ^= np.uint32(1) << rng.integers(
            0, 32, n_copy // 2).astype(np.uint32)
        rows = iter(range(N - 1, -1, -1))
        for c, gap in ((127, 1), (100, 64), (5, 128), (40, 256), (0, 1)):
            if c + gap < M:
                b[c + gap] = b[c]
                vb[c] = vb[c + gap] = True
                for flips in (0, 2):             # rows tied at c, c + gap
                    r = next(rows, None)
                    if r is not None:
                        a[r] = b[c]
                        a[r, 3] ^= np.uint32((1 << flips) - 1)
                        va[r] = True
        cols = iter(range(M - 1, -1, -1))
        for r, gap in ((31, 1), (3, 32), (9, 64), (17, 128), (21, 256)):
            if r + gap < N - 10:
                a[r + gap] = a[r]
                va[r] = va[r + gap] = True
                c = next(cols)
                b[c] = a[r]                      # a column tied at r, r + gap
                vb[c] = True
    elif kind == "one_tile":
        vb[:] = False
        vb[130:140] = True
        if M <= 130:
            vb[-2:] = True
    elif kind == "one_column":
        vb[:] = False
        vb[-1] = True
    else:
        raise ValueError(kind)
    return a.view(np.int32), va, b.view(np.int32), vb


def fast_case(kind, H, W, seed=0):
    """A numpy float32 (H, W) image for B1 and the threshold it is meant
    for.  ``ring``: two corners whose 16 circle pixels all qualify, a
    dark centre ringed by brighter pixels and a bright centre ringed by
    darker ones, with random circle values, so every start's arc sum
    differs from the next in its last bits.  ``boundary``: values on a
    1/64 grid with the threshold 4/64, so that many circle differences
    equal +t or -t exactly.  ``noise``: uniform noise (corners anywhere,
    the border rows included).  ``flat``: no corner at all."""
    rng = np.random.default_rng(seed)
    if kind == "ring":
        img = np.full((H, W), 0.1, np.float32)
        ring = rng.uniform(0.5, 1.0, 16).astype(np.float32)
        centres = ((H // 3, W // 3, 0.0), (2 * H // 3, 2 * W // 3, -0.7))
        for cy, cx, shift in centres:
            if shift:
                img[cy, cx] = 0.9
            for (dx, dy), v in zip(frontend.FAST_OFFSETS, ring):
                img[cy + dy, cx + dx] = v + np.float32(shift)
        return img, 0.06
    if kind == "boundary":
        return (rng.integers(0, 32, (H, W)) / 64).astype(np.float32), 0.0625
    if kind == "noise":
        return rng.uniform(0, 1, (H, W)).astype(np.float32), 0.06
    if kind == "flat":
        return np.full((H, W), 0.25, np.float32), 0.06
    raise ValueError(kind)


def ba_case(C, P, O, seed=0, window=None, pads=False):
    """numpy fields of a BundleProblem: C cameras along a line with small
    rotations, P points in front of them, each point's O slots drawn
    (with repeats) from ``window`` neighbouring cameras (all C if None),
    slot 1 naming slot 0's camera for every fourth point; noisy
    projections, non-uniform weights, a fixed camera and a fixed point,
    a point behind every camera, a seventh of the slots invalid.  With
    ``pads``, invalid slots of every other point carry the camera index
    -1 or C, as padding does."""
    rng = np.random.default_rng(seed)
    window = C if window is None else min(window, C)
    pose = np.zeros((C, 7))
    pose[:, 0] = 0.2 * np.arange(C)
    pose[:, 1:3] = rng.normal(0, 0.05, (C, 2))
    q = np.tile([1.0, 0, 0, 0], (C, 1)) + rng.normal(0, 0.03, (C, 4))
    pose[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    first = rng.integers(0, C - window + 1, (P, 1))
    # each point in front of the middle of its cameras
    X = np.stack([rng.uniform(-2, 2, P) - 0.2 * (first[:, 0] + window / 2),
                  rng.uniform(-1.5, 1.5, P), rng.uniform(3, 9, P)], -1)
    if P > 3:
        X[3, 2] = -5.0                       # behind every camera
    obs_cam = (first + rng.integers(0, window, (P, O))).astype(np.int32)
    if O > 1:
        obs_cam[::4, 1] = obs_cam[::4, 0]
    t, qw, qv = (pose[obs_cam][..., :3], pose[obs_cam][..., 3:4],
                 pose[obs_cam][..., 4:])
    v = np.broadcast_to(X[:, None], t.shape)
    tt = 2.0 * np.cross(qv, v)
    pc = v + qw * tt + np.cross(qv, tt) + t
    uv = pc[..., :2] / np.maximum(pc[..., 2:], 1e-3)
    uv += rng.normal(0, 2e-3, uv.shape)
    valid = rng.random((P, O)) < 6 / 7
    if pads:
        pad = ~valid & (np.arange(P)[:, None] % 2 == 0)
        obs_cam[pad] = np.where(rng.random(int(pad.sum())) < 0.5, -1, C)
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    pt_fixed = np.zeros(P, bool)
    pt_fixed[min(7, P - 1)] = True
    xyz = X + rng.normal(0, 0.01, X.shape)
    weight = rng.random((P, O)) + 0.5
    return (pose.astype(np.float32), cam_fixed, xyz.astype(np.float32),
            pt_fixed, obs_cam, uv.astype(np.float32), valid,
            weight.astype(np.float32))


def vi_case(device=DEVICE, seed=0, pose_noise=0.05, vel_noise=0.2,
            tilt_deg=0.0):
    """The visual-inertial window of tests/test_vi.py, in numpy and the
    port: 6 keyframes 0.4 s apart on a climbing circle (radius 2 m, 0.8
    rad/s, yawing with the motion), exact IMU samples at 200 Hz
    preintegrated by the port, 64 landmarks seen by every keyframe in
    front of it (weight 1e4), poses (but keyframe 0, the gauge) and
    velocities with noise of ``pose_noise`` and ``vel_noise``, gravity
    tilted by ``tilt_deg`` about y (that file's gravity-refinement case:
    0.01, 0.1, 5).  Returns (ViProblem on ``device``, true poses, true
    velocities)."""
    C, P, dt_kf, hz = 6, 64, 0.4, 200.0
    w, r = 0.8, 2.0
    g_w = np.array([0.0, 0.0, -9.81])

    def state(t):
        p = np.stack([r * np.cos(w * t), r * np.sin(w * t), 0.3 * t], -1)
        v = np.stack([-r * w * np.sin(w * t), r * w * np.cos(w * t),
                      0.3 * np.ones_like(t)], -1)
        a = np.stack([-r * w * w * np.cos(w * t),
                      -r * w * w * np.sin(w * t), np.zeros_like(t)], -1)
        return p, v, a

    def R_wb(t):
        c, s = np.cos(w * t), np.sin(w * t)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    rng = np.random.default_rng(seed)
    times = np.arange(C) * dt_kf
    poses = np.zeros((C, 7), np.float32)
    vels = np.zeros((C, 3), np.float32)
    for i, t in enumerate(times):
        p, v, _ = state(np.asarray(t))
        R = R_wb(t)
        poses[i, :3] = -R.T @ p
        poses[i, 3:] = [np.cos(-0.5 * w * t), 0.0, 0.0, np.sin(-0.5 * w * t)]
        vels[i] = v
    facs = []
    for i in range(C - 1):
        ts = np.arange(times[i], times[i + 1] + 0.5 / hz, 1.0 / hz)
        _, _, a_w = state(ts)
        smp = np.zeros((len(ts), 7), np.float32)
        smp[:, 0] = ts
        smp[:, 1:4] = np.einsum("mji,mj->mi", np.stack([R_wb(t) for t in ts]),
                                a_w - g_w)
        smp[:, 6] = w
        facs.append(preintegrate_full(torch.as_tensor(smp, device=device),
                                      gyro_noise=1e-3, accel_noise=1e-2))
    X = np.stack([rng.uniform(-4, 4, P), rng.uniform(-4, 4, P),
                  rng.uniform(2, 6, P)], -1).astype(np.float32)
    pc = se3_apply(torch.as_tensor(poses)[None],
                   torch.as_tensor(X)[:, None]).numpy()        # (P, C, 3)
    ok = pc[..., 2] > 0.3
    uv = (pc[..., :2] / np.maximum(pc[..., 2], 0.3)[..., None]).astype(
        np.float32)
    noisy = poses.copy()
    noisy[1:, :3] += rng.normal(0, pose_noise, (C - 1, 3))
    vel0 = vels + rng.normal(0, vel_noise, (C, 3))
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    X0 = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    fields = (noisy, cam_fixed, X0, np.zeros(P, bool),
              np.tile(np.arange(C, dtype=np.int32), (P, 1)), uv, ok,
              np.full((P, C), 1e4, np.float32))
    vision = ba.BundleProblem(*(torch.as_tensor(x, device=device)
                                for x in fields))
    dev = vision.cam_pose.device
    prob = ViProblem(
        vision=vision, vel=torch.as_tensor(vel0, dtype=torch.float32,
                                           device=dev),
        pair_i=torch.arange(C - 1, dtype=torch.int32, device=dev),
        pair_j=torch.arange(1, C, dtype=torch.int32, device=dev),
        pair_valid=torch.ones(C - 1, dtype=torch.bool, device=dev),
        imu=stack_factors(facs), gravity_w=torch.as_tensor(
            9.81 * np.array([np.sin(np.deg2rad(tilt_deg)), 0.0,
                             -np.cos(np.deg2rad(tilt_deg))]),
            dtype=torch.float32, device=dev),
        bias_g=torch.zeros(3, device=dev), bias_a=torch.zeros(3, device=dev))
    return prob, poses, vels


def without_pad_indices(fields):
    """``fields`` with the camera index of pad slots (outside [0, C))
    set to 0, which the plain version can index."""
    cam = fields[4]
    C = fields[0].shape[0]
    return fields[:4] + (np.where((cam < 0) | (cam >= C), 0, cam)
                         .astype(np.int32),) + fields[5:]


def to_problem(fields, device):
    return ba.BundleProblem(*(torch.as_tensor(x, device=device)
                              for x in fields))


def tree_sum(rows):
    """The fixed tree over the last axis of (n, 256) float32 ``rows``:
    entry t takes entry t + h for h = 128, 64, ..., 1; entry 0."""
    r = rows.copy()
    h = r.shape[-1] // 2
    while h:
        r[:, :h] = r[:, :h] + r[:, h:2 * h]
        h //= 2
    return r[:, 0]


def cost_order(fields, huber=0.01):
    """B6's robust cost sum w e^2 of BundleProblem ``fields`` (numpy, as
    ``ba_case`` gives them) in float32 numpy, every operation rounded as
    ``residual_stage<true>`` of csrc/schur.cu rounds it (x / z, no fused
    multiply-adds; a pad camera index taken from the end and clamped
    into [0, C)), summed in the kernel's fixed order: (1) per point the
    slot terms (w e) e in slot order from +0, a slot without weight
    adding nothing; (2) 256 consecutive points per partial, padded with
    zeros, in the tree of ``tree_sum``; (3) entry t of 256 folds
    partials t, t + 256, ... from 0, then the same tree."""
    f = np.float32
    pose, _, xyz, _, cam, uv, valid, weight = fields
    C = pose.shape[0]
    c = np.clip(np.where(cam < 0, cam + C, cam), 0, C - 1)
    t0, t1, t2, qw, qx, qy, qz = np.moveaxis(pose.astype(f)[c], -1, 0)
    px, py, pz = (xyz[:, k:k + 1].astype(f) for k in range(3))
    tx = f(2) * (qy * pz - qz * py)
    ty = f(2) * (qz * px - qx * pz)
    tz = f(2) * (qx * py - qy * px)
    x = px + qw * tx + (qy * tz - qz * ty) + t0
    y = py + qw * ty + (qz * tx - qx * tz) + t1
    z = pz + qw * tz + (qx * ty - qy * tx) + t2
    front = z > f(1e-6)
    zs = np.where(front, z, f(1))
    rx = x / zs - uv[..., 0]
    ry = y / zs - uv[..., 1]
    e = np.sqrt(rx * rx + ry * ry)
    hd = f(huber)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        hub = np.where(e <= hd, f(1), hd / np.maximum(e, f(1e-12)))
        wt = np.where(valid, weight, f(0)).astype(f)
        w = np.where(front & (wt != 0), wt * hub, f(0))
        terms = np.where(w != 0, (w * e) * e, f(0))
    acc = np.zeros(xyz.shape[0], f)
    for o in range(terms.shape[1]):                      # (1)
        acc = acc + terms[:, o]
    nb = -(-acc.size // 256)
    partial = tree_sum(np.pad(acc, (0, nb * 256 - acc.size))
                       .reshape(nb, 256))                # (2)
    fold = np.zeros(256, f)
    rows = np.pad(partial, (0, -(-nb // 256) * 256 - nb)).reshape(-1, 256)
    for row in rows:                                     # (3)
        fold = fold + row
    return tree_sum(fold[None])[0]


def schur_scales(prob, out_p, huber_delta=0.01):
    """The magnitude each of B5's per-point outputs is formed from, for
    tolerances relative to it (float32 rounding scales with it, and
    points from millimetres to metres deep span eight decades): for W_e
    the largest entry of the (6, 3) observation block an entry lies in;
    for Hpp^-1 its (3, 3) block's largest entry times the block's
    condition (a perturbation dH of Hpp moves the inverse by Hpp^-1 dH
    Hpp^-1); for bp, a sum over observations that cancels, the sum of
    its terms' magnitudes with each residual taken as |r| + |uv| (the
    projection it is the difference of)."""
    r, _, Jp, valid = ba._project_residual_jac(prob)
    w = prob.obs_weight * huber_weight(torch.linalg.vector_norm(r, dim=-1),
                                       huber_delta)
    w = torch.where(valid, w, torch.zeros_like(w))
    Jp = Jp * (~prob.point_fixed)[:, None, None, None]
    bp_terms = torch.einsum("poia,poi->pa", (Jp * w[..., None, None]).abs(),
                            r.abs() + prob.obs_uv.abs())
    block = lambda t: t.abs().amax(dim=(-2, -1), keepdim=True)  # noqa: E731
    Hi = out_p[3].double()
    hi_scale = block(Hi) ** 2 * block(torch.linalg.inv(Hi))
    return block(out_p[2].W_e), hi_scale.float(), bp_terms


def assert_schur_close(out_k, out_p, prob, what):
    """B5's outputs against the plain version's on ``prob`` (the problem
    the plain version ran on); the max abs error of each.  S and b
    within tests/test_pallas.py:180-191's tolerances; W_e, Hpp^-1 and bp
    within their absolute tolerances there plus a relative term of each
    entry's scale (schur_scales): 1e-3 of its block for W_e, 1e-4 for
    Hpp^-1 and bp.  A block of a far point, whose entries are small, is
    held at its own scale."""
    (S1, b1, W1, Hi1, bp1), (S0, b0, W0, Hi0, bp0) = out_k, out_p
    for name, k, p, rtol, atol in (
            ("S", S1, S0, 1e-4, 1e-4 * S0.abs().max().item()),
            ("b", b1, b0, 0.0, 1e-4 * max(b0.abs().max().item(), 1e-6))):
        torch.testing.assert_close(k, p, rtol=rtol, atol=atol,
                                   msg=f"B5 {name} disagrees ({what})")
    errs = {"S": (S1 - S0).abs().max().item(),
            "b": (b1 - b0).abs().max().item()}
    ratios = {}
    w_scale, hi_scale, bp_scale = schur_scales(prob, out_p)
    for name, k, p, rtol, atol, scale in (
            ("W_e", W1.W_e, W0.W_e, 1e-3, 1e-4, w_scale),
            ("Hpp_inv", Hi1, Hi0, 1e-4, 1e-3, hi_scale),
            ("bp", bp1, bp0, 1e-4, 1e-5, bp_scale)):
        err = (k - p).abs()
        errs[name] = err.max().item()
        ratios[name] = (err / (atol + rtol * scale)).max().item()
        if not ratios[name] <= 1.0:
            raise AssertionError(f"B5 {name} disagrees ({what}): error "
                                 f"{ratios[name]:.3g} times its tolerance")
    log(f"B5 ({what}): largest error over its tolerance "
        + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items()))
    return errs


def assert_partials_close(out_k, out_p, prob, what):
    """B5's partials entry (Hcc, bvec, S_corr, W, Hpp^-1, bp) against its
    plain version's on ``prob``: S_corr and Hcc as assert_schur_close
    holds S (rtol 1e-4, atol 1e-4 of the largest entry), bvec as b, W_e,
    Hpp^-1 and bp under its scale-relative rule; the max abs errors."""
    Hk, bk, Sk, Wk, Hik, bpk = out_k
    Hp, bp_, Sp, Wp, Hip, bpp = out_p
    torch.testing.assert_close(Hk, Hp, rtol=1e-4,
                               atol=1e-4 * Hp.abs().max().item(),
                               msg=f"B5 partials Hcc disagrees ({what})")
    errs = assert_schur_close((Sk, bk.reshape(-1), Wk, Hik, bpk),
                              (Sp, bp_.reshape(-1), Wp, Hip, bpp), prob,
                              f"partials, {what}")
    errs = {"S_corr": errs.pop("S"), "bvec": errs.pop("b"), **errs,
            "Hcc": (Hk - Hp).abs().max().item()}
    return errs


def assemble_partials(out, lam, cam_fixed):
    """(S, b_s) from B5 partials (Hcc, bvec, S_corr, ...): damped and
    pinned as the ring assembles them after the cross-shard sum."""
    cam_free = ~cam_fixed
    return ba.assemble_schur(out[0], out[1] * cam_free[:, None], out[2], lam,
                             cam_free)


def assert_same_bits(fn, what):
    """Two calls of ``fn`` return the same bits in every tensor."""
    first, again = fn(), fn()
    torch.cuda.synchronize()
    flat = lambda out: [t for x in out                      # noqa: E731
                        for t in (x if isinstance(x, tuple) else (x,))]
    if not all(torch.equal(x, y) for x, y in zip(flat(first), flat(again))):
        raise AssertionError(f"{what}: two runs on the same inputs differ")


def phase_check(inputs):
    """Each kernel against its plain version at the main-path shapes.
    Returns per-kernel records (max_abs_err, inputs for timing)."""
    img, cam, xyz, desc, valid, _ = inputs
    rec = {}

    # B1: FAST + NMS on the example frame
    rec["fast_nms"] = check_fast_nms(img, THRESH, "example frame")

    # B2: BRIEF on that frame's K keypoints (plain detector path)
    blur, uv, ca, sa, kvalid = brief_inputs(img, K)
    d_k = brief.brief(blur, uv, ca, sa)
    d_p = frontend.brief_from_rotation(blur, uv, ca, sa)
    torch.cuda.synchronize()
    bad_words = (d_k != d_p).sum().item()
    bit_err = 0.0 if bad_words == 0 else 1.0
    log(f"B2 brief: {K} keypoints ({int(kvalid.sum())} valid), "
        f"{bad_words} differing words")
    if bad_words:
        raise AssertionError("BRIEF kernel is not bit-equal")
    rec["brief"] = dict(max_abs_err=bit_err, args=(blur, uv, ca, sa))
    # the loop run's K: the first BRIEF_LOOP_K of those keypoints
    args = (blur, *(x[:BRIEF_LOOP_K] for x in (uv, ca, sa)))
    if not torch.equal(brief.brief(*args),
                       frontend.brief_from_rotation(*args)):
        raise AssertionError(f"BRIEF kernel is not bit-equal at "
                             f"K={BRIEF_LOOP_K}")
    assert_same_bits(lambda: (brief.brief(*args),), "B2 brief")
    rec[f"brief_K{BRIEF_LOOP_K}"] = dict(max_abs_err=0.0, args=args)

    # B3: the map slab (N = 2048) against the frame's K descriptors
    fdesc = torch.where(kvalid[:, None], d_p, torch.zeros_like(d_p))
    top_k = matcher.hamming_top2_kernel(desc, valid, fdesc, kvalid)
    top_p = hamming_top2(desc, valid, fdesc, kvalid)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(top_k, top_p))
    m_k = matcher.match_hamming(desc, valid, fdesc, kvalid)
    m_p = match_descriptors(desc, valid, fdesc, kvalid)
    same = (torch.equal(m_k.idx, m_p.idx) and torch.equal(m_k.valid,
                                                          m_p.valid)
            and torch.equal(m_k.dist[m_k.valid], m_p.dist[m_p.valid]))
    log(f"B3 matcher: max_abs_err {err:.3g} over best/second/idx/back, "
        f"{int(m_k.count)} matches, decisions equal {same}")
    if err != 0.0 or not same:
        raise AssertionError("matcher kernel disagrees with plain version")
    assert_same_bits(lambda: matcher.hamming_top2_kernel(
        desc, valid, fdesc, kvalid), "B3 matcher")
    rec["matcher"] = dict(max_abs_err=err,
                          args=(desc, valid, fdesc, kvalid))

    # B3 off the tile grid: ties across tile borders, a lone valid tile,
    # a lone valid column
    for kind in ("ties", "one_tile", "one_column"):
        args = [torch.as_tensor(x, device=DEVICE)
                for x in matcher_case(**MATCHER_EXTRA, kind=kind, seed=5)]
        top_k = matcher.hamming_top2_kernel(*args)
        top_p = hamming_top2(*args)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(top_k, top_p))
        tied = int((top_p[0] == top_p[1]).sum())
        log(f"B3 matcher N={MATCHER_EXTRA['N']} M={MATCHER_EXTRA['M']} "
            f"{kind}: max_abs_err {err:.3g}, {tied} rows with tied minima")
        if err != 0.0 or (kind == "ties" and tied < 8):
            raise AssertionError(f"matcher kernel disagrees with plain "
                                 f"version ({kind})")
        assert_same_bits(lambda: matcher.hamming_top2_kernel(*args),
                         f"B3 matcher ({kind})")
        if kind == "ties":
            rec["matcher_extra"] = dict(max_abs_err=err, args=tuple(args))
    return rec


def brief_inputs(img, n_kps, threshold=THRESH):
    """B2's inputs on ``img`` as ``extract_features`` forms them (the
    plain detector): the blurred image, the top ``n_kps`` keypoints,
    the cosines and sines of their angles, and their validity."""
    nms, raw = fastnms.fast_nms_plain(img, threshold)
    uv, _, kvalid, _ = frontend.select_keypoints(nms, max_kps=n_kps,
                                                 raw_score=raw)
    angle = frontend.compute_orientations(img, uv)
    blur = frontend.gaussian_blur(img, sigma=2.0)
    return blur, uv, torch.cos(angle), torch.sin(angle), kvalid


def check_fast_nms(img, threshold, what):
    """B1 against its plain version, bit for bit on both maps, and two
    calls the same bits; the record for timing."""
    nms_k, raw_k = fastnms.fast_nms_raw(img, threshold)
    nms_p, raw_p = fastnms.fast_nms_plain(img, threshold)
    torch.cuda.synchronize()
    err = max((raw_k - raw_p).abs().max().item(),
              (nms_k - nms_p).abs().max().item())
    same = torch.equal(raw_k, raw_p) and torch.equal(nms_k, nms_p)
    same_support = torch.equal(nms_k > 0, nms_p > 0)
    log(f"B1 fast_nms ({what}, threshold {threshold}): max_abs_err "
        f"{err:.3g}, bit for bit {same}, nms support equal {same_support}, "
        f"corners {(nms_k > 0).sum().item()}")
    if not (err == 0.0 and same and same_support):
        raise AssertionError(f"FAST+NMS kernel disagrees with plain version "
                             f"({what})")
    assert_same_bits(lambda: fastnms.fast_nms_raw(img, threshold),
                     f"B1 fast_nms ({what})")
    return dict(max_abs_err=err, args=(img, threshold))


def check_frame_at(img, threshold, n_kps, what, phase):
    """B1 (check_fast_nms) and B2 against their plain versions, bit for
    bit, on one frame of a path's own size at its threshold and its
    ``n_kps``; the two records, with their timing and the path
    (``phase``) whose launches their rows report."""
    fast = check_fast_nms(img, threshold, what)
    fast["timing"] = (lambda: fastnms.fast_nms_raw(img, threshold),
                      lambda: fastnms.fast_nms_plain(img, threshold),
                      fast_work(img, threshold))
    fast["launched_in"] = [(phase, "fast_nms")]
    args = brief_inputs(img, n_kps, threshold)[:4]
    d_k = brief.brief(*args)
    d_p = frontend.brief_from_rotation(*args)
    torch.cuda.synchronize()
    bad_words = (d_k != d_p).sum().item()
    log(f"B2 brief ({what}, K = {n_kps}): {bad_words} differing words")
    if bad_words:
        raise AssertionError(f"BRIEF kernel is not bit-equal ({what})")
    assert_same_bits(lambda: (brief.brief(*args),), f"B2 brief ({what})")
    return fast, dict(max_abs_err=0.0, launched_in=[(phase, "brief")],
                      timing=(lambda: brief.brief(*args),
                              lambda: frontend.brief_from_rotation(*args),
                              brief_work(args[0], n_kps)))


def phase_check_fast_frame(frame):
    """B1 on the first frame of the 64-frame SLAM sequence, at the SLAM
    path's threshold."""
    img = torch.as_tensor(frame.image, device=DEVICE)
    return {"fast_nms_slam_frame": check_fast_nms(
        img, SLAM_CFG["fast_threshold"], "first SLAM frame")}


def phase_main_path(inputs):
    """One track_forward through the kernels, launch counts around it;
    then the plain path on the card from the same generator seed.
    Returns (launches, (pose, inliers, features) of the kernel run)."""
    img, cam, xyz, desc, valid, _ = inputs
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    reset_counts()
    T, n, nf = track_forward(img, cam, xyz, desc, valid, generator=gen,
                             max_kps=K, ransac_b=B, device=DEVICE)
    torch.cuda.synchronize()
    launched = counts()
    log(f"track_forward path launches: {launched}")
    if any(launched[k] < 1 for k in TRACK_PATH):
        raise AssertionError(f"a kernel of the path never ran: {launched}")

    T_np = T.cpu().numpy()
    n_self = int(valid[:min(K, M)].sum())
    log(f"track_forward: pose {np.array2string(T_np, precision=6)}, "
        f"{int(n)} inliers of {n_self} self-features, {int(nf)} features")
    ident = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)
    if not (np.isfinite(T_np).all()
            and np.abs(T_np[:3]).max() <= 1e-3
            and np.abs(T_np[3:] - ident[3:]).max() <= 1e-3):
        raise AssertionError(f"identity pose not recovered: {T_np}")
    if int(n) < n_self // 2:
        raise AssertionError(f"too few inliers: {int(n)} < {n_self // 2}")

    gen_p = torch.Generator(device=DEVICE)
    gen_p.manual_seed(0)
    Tp, n_p, nf_p = track_forward(img, cam, xyz, desc, valid,
                                  generator=gen_p, max_kps=K, ransac_b=B,
                                  use_kernels=False, device=DEVICE)
    f_k = frontend.extract_features(img, max_kps=K)
    f_p = frontend.extract_features(img, max_kps=K, use_kernels=False)
    m_k = matcher.match_hamming(desc, valid, f_k.desc, f_k.valid)
    m_p = match_descriptors(desc, valid, f_p.desc, f_p.valid)
    torch.cuda.synchronize()
    dpose = np.abs(Tp.cpu().numpy() - T_np).max()
    same_matches = (torch.equal(m_k.idx, m_p.idx)
                    and torch.equal(m_k.valid, m_p.valid))
    log(f"plain path: pose diff {dpose:.3g}, inliers {int(n_p)}, "
        f"features {int(nf_p)}, match sets equal {same_matches} "
        f"({int(m_k.count)} matches)")
    if not (same_matches and dpose <= 1e-4 and int(nf_p) == int(nf)):
        raise AssertionError("plain path disagrees with the kernel path")
    return launched, (T.cpu(), int(n), int(nf))


def time_frame(inputs, use_kernels: bool, reps: int = 30):
    img, cam, xyz, desc, valid, _ = inputs
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)

    def step():
        return track_forward(img, cam, xyz, desc, valid, generator=gen,
                             max_kps=K, ransac_b=B, use_kernels=use_kernels,
                             device=DEVICE)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        T, n, _ = step()
        n.item()                         # the caller reads the result
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_stages(inputs):
    """Device time of each stage of the step, as track_forward runs it."""
    img, cam, xyz, desc, valid, _ = inputs
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    f = frontend.extract_features(img, max_kps=K)
    m = matcher.match_hamming(desc, valid, f.desc, f.valid)
    rays = pinhole_unproject(cam, f.uv[m.idx.clamp_min(0).long()])[:, :2]
    data = torch.cat([xyz, rays], -1)
    err_fn = pnp_reproj_error
    T, inl, _ = run_ransac(_p3p_grunert, err_fn, data, m.valid, 4,
                           PNP_THRESH, B, generator=gen)
    w = inl.to(torch.float32)
    return {
        "extract": cuda_ms(lambda: frontend.extract_features(img,
                                                             max_kps=K),
                           reps=20),
        "match": cuda_ms(lambda: matcher.match_hamming(desc, valid, f.desc,
                                                       f.valid), reps=20),
        "ransac": cuda_ms(lambda: run_ransac(
            _p3p_grunert, err_fn, data, m.valid, 4, PNP_THRESH, B,
            generator=gen), reps=20),
        "refine": cuda_ms(lambda: refine_pose_gn(T, data, w), reps=20),
    }


def device_profile(step, frames: int, label: str, calls: int = None):
    """Device busy share of ``step()``: kernel time that torch.profiler
    records over ``calls`` calls (by default one per frame) that track
    ``frames`` frames, over their wall time; and the kernels that take
    the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames if calls is None else calls):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us
            n_kernels += 1
    busy_us = sum(by_name.values())
    if busy_us == 0:
        log(f"profile {label}: the profiler recorded no device time; "
            "device busy share not measured")
        return None
    log(f"profile {label} over {frames} frames: wall "
        f"{wall_us / frames / 1e3:.3f} ms/frame, device busy "
        f"{busy_us / frames / 1e3:.3f} ms/frame "
        f"({100 * busy_us / wall_us:.1f}% busy), "
        f"{n_kernels / frames:.0f} device ops/frame")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {us / frames:9.1f} us/frame  {name[:90]}")
    return dict(wall_ms=wall_us / frames / 1e3,
                busy_ms=busy_us / frames / 1e3,
                busy_share=busy_us / wall_us,
                device_ops_per_frame=n_kernels / frames)


def phase_profile(inputs, frames: int = 10):
    img, cam, xyz, desc, valid, _ = inputs
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)

    def step():
        return track_forward(img, cam, xyz, desc, valid, generator=gen,
                             max_kps=K, ransac_b=B, device=DEVICE)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    return device_profile(step, frames, "track_forward")


def phase_kernel_times(rec, launched):
    """B1, B2 and B3 kernel and plain times at the tracking step's
    shapes, with bounds."""
    img, thresh = rec["fast_nms"]["args"]
    blur, uv, ca, sa = rec["brief"]["args"]
    desc, valid, fdesc, kvalid = rec["matcher"]["args"]
    work = {
        "fast_nms": fast_work(img, thresh),
        "brief": brief_work(blur, uv.shape[0]),
        "matcher": matcher_work(desc.shape[0], fdesc.shape[0]),
    }
    calls = {
        "fast_nms": (lambda: fastnms.fast_nms_raw(img, thresh),
                     lambda: fastnms.fast_nms_plain(img, thresh)),
        "brief": (lambda: brief.brief(blur, uv, ca, sa),
                  lambda: frontend.brief_from_rotation(blur, uv, ca, sa)),
        "matcher": (lambda: matcher.hamming_top2_kernel(desc, valid, fdesc,
                                                        kvalid),
                    lambda: hamming_top2(desc, valid, fdesc, kvalid)),
    }
    return time_kernels(calls, work, rec, launched)


def brief_work(blur, n_kps):
    """(bytes, float operations) of one B2 call: the image read once,
    uv, cos and sin per keypoint, the pattern, the words written; per
    bit 8 products, 6 sums, 4 roundings, 8 clamps, 2 addresses (2
    operations each) and 1 compare."""
    return (4 * (blur.numel() + n_kps * 4 + 256 * 4) + n_kps * 32,
            n_kps * 256 * 31)


def cost_work(prob):
    """(bytes, float operations) of one B6 call: poses, points and the
    (point, slot) tables read once, the cost written; per observation
    the residual, its norm, the Huber weight and w e^2 (40)."""
    C = prob.cam_pose.shape[0]
    P, O = prob.obs_cam.shape
    return (C * 28 + P * 12 + P * O * 17 + 4,
            int(prob.obs_valid.sum()) * 40)


def fast_work(img, threshold, arc=9):
    """(bytes, float operations) that one B1 call on ``img`` needs: the
    image read once and both maps written once; per pixel 16 circle
    differences, 32 compares, 22 mask operations (the arc starts of both
    masks) and the 3 x 3 NMS (9 maxima, 1 compare); and for each arc
    start that qualifies on this image (counted with the plain version's
    masks, inside the border) ``arc`` subtractions, ``arc`` sums and one
    maximum."""
    H, W = img.shape
    d = torch.stack([torch.roll(img, (-int(dy), -int(dx)), (0, 1))
                     for dx, dy in frontend.FAST_OFFSETS]) - img
    starts = 0
    for m in (d > threshold, d < -threshold):
        ext = torch.cat([m, m[:arc]])
        for s in range(16):
            starts += int(ext[s:s + arc].all(0)[3:H - 3, 3:W - 3].sum())
    n_px = H * W
    log(f"B1 work at {H}x{W}, threshold {threshold}: {starts} qualifying "
        f"arc starts ({starts / n_px:.5f} a pixel)")
    return 3 * 4 * n_px, n_px * (16 + 32 + 22 + 10) + starts * (2 * arc + 1)


def matcher_work(N, M):
    """(bytes, float operations, Hamming steps, other integer
    operations) of one B3 call: per pair 8 steps (xor, popc, add), then
    4 top-2 and column compares."""
    return ((N + M) * (32 + 1) + N * 12 + M * 4, 0, N * M * 8,
            N * M * 4)


def gated_inputs(N=2048, Mk=512, seed=7):
    """B4's inputs, by default at its main-path shape (N = 2048 map rows
    against M = 512 keypoints): each keypoint within a few pixels of a
    map row's projection with a near copy of its descriptor (the
    tracking matcher's situation), the rest random; about 10% of rows
    masked.  Keypoints beyond N are random."""
    rng = np.random.default_rng(seed)
    near = min(N, Mk)
    uv_map = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)],
                      -1).astype(np.float32)
    desc_map = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(
        np.uint32)
    perm = rng.permutation(N)[:near]
    kp_uv = (uv_map[perm] + rng.normal(0, 3.0, (near, 2))).astype(np.float32)
    kp_desc = desc_map[perm].copy()
    kp_desc[:, 0] ^= np.uint32(1) << rng.integers(0, 32, near).astype(
        np.uint32)
    valid_map = rng.random(N) < 0.9
    valid_kp = rng.random(Mk) < 0.95
    if Mk > near:
        kp_uv = np.concatenate([kp_uv, np.stack(
            [rng.uniform(0, W, Mk - near), rng.uniform(0, H, Mk - near)],
            -1).astype(np.float32)])
        kp_desc = np.concatenate([kp_desc, random_words(rng, Mk - near)])
    return [torch.as_tensor(x, device=DEVICE) for x in (
        desc_map.view(np.int32), valid_map, kp_desc.view(np.int32),
        valid_kp, uv_map, kp_uv)]


def phase_check_slam_kernels():
    """B4, B5 and B6 against their plain versions at the SLAM path's
    shapes; bundle_adjust with the kernels against the plain LM."""
    rec = {}
    gate2 = gate_squared(SLAMConfig().gate_radius_px)
    for label, (N, Mk) in {"gated_matcher": (2048, 512),
                           **GATED_EXTRA}.items():
        g_args = gated_inputs(N, Mk)
        out_k = matcher.gated_top2_kernel(*g_args, gate2)
        out_p = hamming_top2_gated(*g_args, gate2)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(out_k, out_p))
        n_m = int((out_p[0] <= 64).sum())
        log(f"B4 gated matcher N={N} M={Mk}: max_abs_err {err:.3g} over "
            f"best/second/idx, {n_m} rows with a candidate within 64 bits")
        if err != 0.0:
            raise AssertionError(f"gated matcher kernel disagrees with "
                                 f"plain (N={N}, M={Mk})")
        assert_same_bits(lambda: matcher.gated_top2_kernel(*g_args, gate2),
                         f"B4 gated matcher (N={N}, M={Mk})")
        rec[label] = dict(max_abs_err=err, args=(*g_args, gate2))

    prob = bench.ba_problem(torch.device(DEVICE))
    lam = torch.tensor(1e-3, device=DEVICE)
    S1, b1, W1, Hi1, bp1 = schur.schur_reduce_kernel(prob, lam, 0.01)
    S0, b0, W0, Hi0, bp0 = ba.schur_reduce(prob, lam, 0.01)
    torch.cuda.synchronize()
    errs = assert_schur_close((S1, b1, W1, Hi1, bp1),
                              (S0, b0, W0, Hi0, bp0), prob,
                              "C=8, P=1024, O=8")
    log("B5 schur vs plain (C=8, P=1024, O=8): max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    assert_same_bits(lambda: schur.schur_reduce_kernel(prob, lam, 0.01),
                     "B5 schur")
    rec["schur"] = dict(max_abs_err=max(errs.values()), args=(prob, lam))
    rec["ba_cost"] = check_cost(prob, prob, tuple(x.cpu().numpy()
                                                  for x in prob),
                                "C=8, P=1024, O=8")

    # B5 at the widest camera count of its contract and at the loop
    # run's window, few cameras per point, repeated cameras, pad slots
    for label, case in SCHUR_EXTRA.items():
        fields = ba_case(**case, seed=1)
        wide = to_problem(fields, DEVICE)
        plain = to_problem(without_pad_indices(fields), DEVICE)
        out_k = schur.schur_reduce_kernel(wide, lam, 0.01)
        out_p = ba.schur_reduce(plain, lam, 0.01)
        torch.cuda.synchronize()
        e = assert_schur_close(out_k, out_p, plain, label)
        log(f"B5 schur vs plain ({label}): max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
        assert_same_bits(lambda: schur.schur_reduce_kernel(wide, lam, 0.01),
                         f"B5 schur ({label})")
        rec["schur_" + label] = dict(max_abs_err=max(e.values()),
                                     args=(wide, lam), plain=plain)
        rec["ba_cost_" + label] = check_cost(wide, plain, fields, label)

    out_k, st_k = ba.bundle_adjust(prob, iters=6, use_kernels=True)
    out_p, st_p = ba.bundle_adjust(prob, iters=6, use_kernels=False)
    torch.cuda.synchronize()
    log(f"bundle_adjust 6 iters: accepted kernels "
        f"{st_k.accepted.tolist()} plain {st_p.accepted.tolist()}; cost "
        f"{st_k.cost[0].item():.6g} -> {st_k.cost[-1].item():.6g} "
        f"(plain -> {st_p.cost[-1].item():.6g}); pose diff "
        f"{(out_k.cam_pose - out_p.cam_pose).abs().max().item():.3g}")
    if not torch.equal(st_k.accepted, st_p.accepted):
        raise AssertionError("LM with the kernels took other steps")
    torch.testing.assert_close(st_k.cost, st_p.cost, rtol=1e-3, atol=0.0)
    torch.testing.assert_close(out_k.cam_pose, out_p.cam_pose, rtol=0.0,
                               atol=1e-4)
    return rec


def check_cost(prob, plain, fields, what):
    """B6 on ``prob`` within rtol 1e-5 of the plain version on ``plain``
    (``prob`` with pads set to camera 0), bit for bit the float32 model
    of its summation order on ``fields`` (``cost_order``), and two calls
    the same bits; the record for timing."""
    got = schur.ba_cost_kernel(prob, 0.01)
    ref = ba.ba_cost(plain, 0.01)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0,
                               msg=f"B6 cost disagrees ({what})")
    bits = int(got.cpu().numpy().view(np.uint32))
    model = int(cost_order(fields, 0.01).view(np.uint32))
    err = (got - ref).abs().item()
    log(f"B6 cost ({what}): {got.item()!r} (float32 0x{bits:08x}), plain "
        f"{ref.item()!r}, max abs err {err:.3g}; the model of its order "
        f"0x{model:08x}")
    if bits != model:
        raise AssertionError(f"B6 cost: other bits than its order's model "
                             f"({what})")
    assert_same_bits(lambda: (schur.ba_cost_kernel(prob, 0.01),),
                     f"B6 cost ({what})")
    return dict(max_abs_err=err, args=(prob,), plain=plain,
                hex=f"0x{bits:08x}")


def load_frames():
    """All frames of the full-width sequence (the 64-frame phases take
    the first SLAM_FRAMES)."""
    t0 = time.perf_counter()
    ds = SyntheticDataset(**SEQUENCE)
    ds.open("synth://")
    ds.render_ahead(RENDER_THREADS)
    frames = list(ds)
    log(f"sequence: {len(frames)} frames {SEQUENCE['height']}x"
        f"{SEQUENCE['width']} rendered in {time.perf_counter() - t0:.1f} s")
    return ds.camera, frames


def run_slam(camera, frames, use_kernels=True, seed=0, cfg=None):
    """A fresh KeyframeSLAM (``cfg``, by default SLAM_CFG) over
    ``frames``; (slam, seconds)."""
    slam = KeyframeSLAM(camera, SLAMConfig(**(cfg or SLAM_CFG),
                                           use_kernels=use_kernels,
                                           seed=seed), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr in frames:
        slam.track(fr)
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0


def slam_metrics(slam, frames, with_scale=False):
    """Trajectory metrics of a run over ``frames`` against their ground
    truth."""
    ts = np.asarray([fr.timestamp for fr in frames])
    gt = np.stack([fr.gt_pose[:3] for fr in frames])
    return evaluate_trajectory(ts, slam.positions(), ts, gt,
                               with_scale=with_scale)


def fleet_ate(centres, times, n_a, gt_a, gt_b):
    """Keyframe ATE (m) of a merged map: the first ``n_a`` keyframe
    centres against sequence a's ground truth, the rest against b's
    (``gt_*`` = (timestamps, positions)), each sequence SE3-aligned on
    its own (each SLAM world starts at its first camera, and b's was
    moved by FLEET_ALIGN), the RMS over all keyframes."""
    sq, n = 0.0, 0
    for sl, (t_gt, p_gt) in ((slice(0, n_a), gt_a), (slice(n_a, None), gt_b)):
        m = evaluate_trajectory(times[sl], centres[sl], t_gt, p_gt,
                                with_scale=False)
        sq += m.ate_rmse ** 2 * m.n_matched
        n += m.n_matched
    return float(np.sqrt(sq / n))


def tracked_frames(slam):
    return sum(st["n_inliers"] >= slam.cfg.min_track_inliers
               for st in slam.stats)


def phase_slam(camera, frames):
    """The SLAM main path once through the kernels, counters around it;
    tracking, keyframe, BA and ATE gates."""
    reset_counts()
    slam, secs = run_slam(camera, frames)
    launched = counts()
    log(f"KeyframeSLAM path launches over {len(frames)} frames: "
        f"{launched} ({secs:.2f} s, first run)")
    missing = [k for k in SLAM_PATH if launched[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the SLAM path never ran: "
                             f"{missing}")
    tracked = tracked_frames(slam)
    n_kf = slam._n_frames_host
    ba_runs = slam.timer.stats().get("slam/local_ba", {}).get("count", 0)
    pos = slam.positions()
    m = slam_metrics(slam, frames)
    log(f"SLAM: {tracked}/{len(frames)} frames tracked, {n_kf} keyframes, "
        f"{ba_runs} local BA runs, ATE {m.ate_rmse:.8f} m (gate "
        f"{ATE_GATE:.4f} m; JAX reference {REF_ATE:.6f} m), RPE "
        f"{m.rpe_rmse:.6f} m; inliers "
        f"{[st['n_inliers'] for st in slam.stats]}")
    if not np.isfinite(pos).all() or pos.shape != (len(frames), 3):
        raise AssertionError("trajectory not finite or of the wrong shape")
    if tracked < 0.9 * len(frames):
        raise AssertionError(f"only {tracked} of {len(frames)} frames "
                             "tracked")
    if n_kf < 3 or ba_runs < 1:
        raise AssertionError(f"{n_kf} keyframes, {ba_runs} local BA runs")
    if not m.ate_rmse <= ATE_GATE:
        raise AssertionError(f"ATE {m.ate_rmse} m above {ATE_GATE} m")
    return launched, dict(tracked=tracked, keyframes=n_kf,
                          local_ba_runs=ba_runs, ate_m=m.ate_rmse,
                          rpe_m=m.rpe_rmse, first_run_s=secs)


# timer sections that run inside another (not counted again in "rest")
NESTED_SECTIONS = ("loop_gba", "vi_local_ba")


def split_ms(slam, n):
    """Wall ms per frame of each timer section."""
    return {k.split("/")[1]: v["total"] * 1e3 / n
            for k, v in slam.timer.stats().items()}


def rest_ms(ms_per_frame, split):
    """The host glue outside every top-level timer section."""
    return ms_per_frame - sum(v for k, v in split.items()
                              if k not in NESTED_SECTIONS)


def slam_turns(camera, frames, cfg, first_ate, what):
    """Warm runs of ``cfg`` over ``frames`` in turns (kernels, plain,
    kernels): ms/frame and timer split of each; the kernel runs must
    repeat ``first_ate`` bit for bit."""
    n = len(frames)
    runs = {}
    for label, uk in (("kernels", True), ("plain", False),
                      ("kernels2", True)):
        slam, secs = run_slam(camera, frames, use_kernels=uk, cfg=cfg)
        ms, split = secs * 1e3 / n, split_ms(slam, n)
        ate = slam_metrics(slam, frames).ate_rmse
        runs[label] = dict(ms_per_frame=ms, split_ms_per_frame=split,
                           ate_m=ate)
        if uk and ate != first_ate:
            raise AssertionError(f"{what} {label}: ATE {ate!r} m differs "
                                 f"from the first run's {first_ate!r} m")
        log(f"{what} {label}: {ms:.3f} ms/frame ({n / secs:.2f} frames/s), "
            f"ATE {ate!r} m; split ms/frame: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"; rest (host glue) {rest_ms(ms, split):.3f}")
    return runs


def phase_slam_timing(camera, frames, first_ate):
    """Warm runs in turns (kernels, plain, kernels) and a profile; the
    runs with the kernels must repeat the first run's ATE bit for bit
    (no float atomics anywhere on the path)."""
    runs = slam_turns(camera, frames, SLAM_CFG, first_ate, "SLAM")
    # device busy share over the first 24 frames of a fresh run (the
    # bootstrap keyframe, 23 tracked frames, two keyframes with BA)
    n_prof = min(24, len(frames))
    slam = KeyframeSLAM(camera, SLAMConfig(**SLAM_CFG), device=DEVICE)
    it = iter(frames[:n_prof])
    prof = device_profile(lambda: slam.track(next(it)), n_prof,
                          "KeyframeSLAM")
    ms = [runs["kernels"]["ms_per_frame"], runs["kernels2"]["ms_per_frame"]]
    return dict(ms_per_frame=min(ms), frames_per_s=1e3 / min(ms),
                ms_per_frame_runs=ms,
                plain_ms_per_frame=runs["plain"]["ms_per_frame"],
                split_ms_per_frame=runs["kernels"]["split_ms_per_frame"],
                plain_split_ms_per_frame=runs["plain"]["split_ms_per_frame"],
                profile=prof)


def batched_launches(slam, counted):
    """Kernel launches of a track_batch run from the wrappers' counts
    over it (``counted``): a wrapper counts when Python calls it, so the
    capture of each batch graph counted its launches once, though it
    launched nothing, and its replays counted none.  Each graph adds its
    captured launches times (replays - 1)."""
    out = dict(counted)
    for graph in slam._graphs.values():
        for name, n in graph.captured.items():
            out[name] += n * (graph.replays - 1)
    return out


def graph_nodes(graph: BatchGraph) -> int:
    """Node count of a batch graph's captured cudaGraph_t (the driver's
    cuGraphGetNodes; the CUDA runtime's graph is the driver's)."""
    lib = ctypes.CDLL(ctypes.util.find_library("cuda") or "libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(graph.graph.raw_cuda_graph()),
                              None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {err}")
    return n.value


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, for a bit-for-bit comparison (NaN equals NaN)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def run_batched(camera, frames, seed=0, cfg=None):
    """A fresh KeyframeSLAM (``cfg``, by default BATCH_CFG) through
    track_batch over ``frames``, 8 a dispatch; (slam, seconds, seconds of
    them capturing graphs)."""
    slam = KeyframeSLAM(camera, SLAMConfig(**(cfg or BATCH_CFG), seed=seed),
                        device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.track_batch(frames)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return slam, secs, sum(g.capture_s for g in slam._graphs.values())


def phase_batched(camera, frames):
    """The reference's full-system cell: track_batch over all frames,
    counters around it; the gates; the graph's record; a second run
    that repeats the ATE bit for bit."""
    reset_counts()
    slam, secs, cap_s = run_batched(camera, frames)
    launched = batched_launches(slam, counts())
    n = len(frames)
    graphs = list(slam._graphs.values())
    log(f"track_batch path launches over {n} frames: {launched} ({secs:.2f}"
        f" s, first run, {cap_s:.3f} s of it capturing)")
    missing = [k for k in SLAM_PATH if launched[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the batched path never ran: "
                             f"{missing}")
    poses = torch.stack(slam.trajectory).cpu().numpy()
    tracked = tracked_frames(slam)
    n_kf = slam._n_frames_host
    m = slam_metrics(slam, frames)
    section = slam.timer.stats().get("slam/track_batch", {})
    # kf_max_gap (8) = K: a dispatch that starts after a keyframe meets
    # the keyframe predicate on its K-th frame, in the JAX package too
    # (a keyframe every 8 frames there), so a dispatch takes at most K - 1
    # frames before its trigger frame
    whole = sum(a >= BATCH_K - 1 for a in slam.batch_accepted)
    if len(graphs) != 1:
        raise AssertionError(f"{len(graphs)} batch graphs, expected one")
    g = graphs[0]
    nodes = graph_nodes(g)
    log(f"batch graph (K={BATCH_K}, {SEQUENCE['height']}x"
        f"{SEQUENCE['width']}, M={SLAM_CFG['local_map_size']}): captured in "
        f"{g.capture_s:.3f} s, {nodes} nodes, memory pool "
        f"{g.pool_bytes / 2 ** 20:.1f} MiB, replays {g.replays}, launches a "
        f"replay {g.captured}")
    log(f"track_batch: {tracked}/{n} frames tracked, {n_kf} keyframes, "
        f"{section.get('count', 0)} dispatches, frames accepted per dispatch "
        f"{slam.batch_accepted}, ATE {m.ate_rmse!r} m (gate "
        f"{ATE_GATE_BATCHED:.4f} m; JAX reference {REF_ATE_BATCHED:.6f} m), "
        f"RPE {m.rpe_rmse:.6f} m")
    if poses.shape != (n, 7) or not np.isfinite(poses).all():
        raise AssertionError("batched trajectory not finite or of the wrong "
                             "shape")
    if tracked < 0.9 * n or n_kf < 3:
        raise AssertionError(f"{tracked} of {n} frames tracked, {n_kf} "
                             "keyframes")
    if section.get("count", 0) < 1 or whole < 1:
        raise AssertionError("no batch dispatched, or none accepted up to "
                             "its K-th frame")
    if not m.ate_rmse <= ATE_GATE_BATCHED:
        raise AssertionError(f"ATE {m.ate_rmse} m above {ATE_GATE_BATCHED} m")
    slam2, secs2, _ = run_batched(camera, frames)
    ate2 = slam_metrics(slam2, frames).ate_rmse
    log(f"track_batch second run: ATE {ate2!r} m ({secs2:.2f} s)")
    if ate2 != m.ate_rmse:
        raise AssertionError("the second batched run's ATE differs")
    return launched, dict(
        frames=n, dispatch_batch=BATCH_K, tracked=tracked, keyframes=n_kf,
        ate_m=m.ate_rmse, rpe_m=m.rpe_rmse, dispatches=section.get("count"),
        batches_accepted_to_kth_frame=whole, first_run_s=secs,
        graph=dict(capture_s=g.capture_s, nodes=nodes,
                   pool_bytes=g.pool_bytes, replays=g.replays,
                   launches_per_replay=g.captured))


def phase_graph_vs_eager(camera, frames, cfg=None, at=BATCH_EAGER_AT):
    """The captured graph against the same K-frame body run eagerly, on
    one batch (frames ``at`` onwards after tracking the frames before one
    a call; ``cfg`` by default BATCH_CFG) with the same uniforms: every
    output bit for bit, twice."""
    slam = KeyframeSLAM(camera, SLAMConfig(**(cfg or BATCH_CFG)),
                        device=DEVICE)
    for fr in frames[:at]:
        slam.track(fr)
    batch = frames[at:at + BATCH_K]
    imgs = torch.from_numpy(np.stack([fr.image for fr in batch])).to(DEVICE)
    slab = slam._slab(slam.arena, slam._kf_tensor())
    x = slam._batch_inputs(imgs, slam._batch_uniforms(BATCH_K), *slab[1:])
    t0 = time.perf_counter()
    eager = slam._batch_body(x)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    graph = BatchGraph(slam._batch_body, x)
    replay_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = graph(x)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        leaves = list(zip(tensor_leaves(out), tensor_leaves(eager)))
        differ = [i for i, (a, b) in enumerate(leaves)
                  if a.shape != b.shape or not torch.equal(bits(a), bits(b))]
        if differ:
            raise AssertionError(f"graph replay differs from the eager body "
                                 f"in outputs {differ}")
    rows = eager.rows.cpu().numpy()
    log(f"graph vs eager body, frames {at}-{at + BATCH_K - 1}: "
        f"{len(leaves)} outputs bit for bit "
        f"equal in two replays (poses, packed rows, visible / found, frozen "
        f"trigger state); inliers {rows[:, 14].astype(int).tolist()}, "
        f"trigger {rows[:, 17].astype(int).tolist()}; eager body "
        f"{eager_s * 1e3:.3f} ms, replay {replay_ms[0]:.3f}/"
        f"{replay_ms[1]:.3f} ms (host wall to a synchronize)")
    return dict(outputs=len(leaves), eager_ms=eager_s * 1e3,
                replay_ms=replay_ms)


def warm_profile(camera, frames, batched: bool):
    """Device busy share over BATCH_PROFILE_FRAMES frames of a warm
    system: after the bootstrap and one batch's worth of frames (a
    batched system's graph captured then), the next frames one track()
    call each, or one track_batch call."""
    cfg = BATCH_CFG if batched else SLAM_CFG
    slam = KeyframeSLAM(camera, SLAMConfig(**cfg), device=DEVICE)
    warm = frames[:1 + BATCH_K]
    window = frames[len(warm):len(warm) + BATCH_PROFILE_FRAMES]
    if batched:
        slam.track_batch(warm)
        return device_profile(lambda: slam.track_batch(window), len(window),
                              "track_batch", calls=1)
    for fr in warm:
        slam.track(fr)
    it = iter(window)
    return device_profile(lambda: slam.track(next(it)), len(window),
                          "track (sequential)")


def phase_batch_timing(camera, frames):
    """Sequential track against track_batch over all frames, in turns
    (sequential, batched, batched, sequential), each a fresh system;
    then the device busy share of each over warm frames.  No gain is
    claimed: the host's speed differs from call to call."""
    n = len(frames)
    runs = []
    for label in ("sequential", "batched", "batched", "sequential"):
        if label == "batched":
            slam, secs, cap_s = run_batched(camera, frames)
        else:
            slam, secs = run_slam(camera, frames)
            cap_s = 0.0
        split = split_ms(slam, n)
        ms = secs * 1e3 / n
        runs.append(dict(run=label, ms_per_frame=ms, frames_per_s=n / secs,
                         capture_s=cap_s,
                         ms_per_frame_without_capture=(secs - cap_s) * 1e3 / n,
                         ate_m=slam_metrics(slam, frames).ate_rmse,
                         keyframes=slam._n_frames_host, split_ms=split))
        log(f"{label} over {n} frames: {ms:.3f} ms/frame ({n / secs:.2f} "
            f"frames/s; {(secs - cap_s) * 1e3 / n:.3f} ms/frame without the "
            f"{cap_s:.3f} s of graph capture); ATE {runs[-1]['ate_m']:.6f} m, "
            f"{slam._n_frames_host} keyframes; split ms/frame: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"; rest (host glue) {rest_ms(ms, split):.3f}")
    prof = {"sequential": warm_profile(camera, frames, False),
            "batched": warm_profile(camera, frames, True)}
    return dict(runs=runs, profile=prof)


class ReferenceDraws:
    """A ``uniforms`` hook that replays a recorded run's RANSAC draws
    (``tests/test_torch_slam.py --reference-draws-mono``) in order: the
    two-view pair while the system has no map, a (256, 4) PnP draw once
    it has one.  Raises when the system asks for another kind of draw
    than the recorded run took at that point, or for more."""

    def __init__(self, path=MONO_DRAWS, device=None):
        device = device or DEVICE
        with np.load(path) as d:
            self.kind = d["kind"].tolist()
            self.inliers = d["inliers"].tolist()
            self.draws = {
                0: iter(torch.as_tensor(d["pnp"], device=device)),
                1: iter(zip(torch.as_tensor(d["two_view_e"], device=device),
                            torch.as_tensor(d["two_view_h"], device=device)))}
        self.taken = 0
        self.slam = None

    def __call__(self):
        kind = 0 if self.slam.initialized else 1
        if self.kind[self.taken:self.taken + 1] != [kind]:
            raise AssertionError(f"draw {self.taken}: the system asks for "
                                 f"kind {kind}, the recorded run took "
                                 f"{self.kind[self.taken:self.taken + 1]}")
        self.taken += 1
        return next(self.draws[kind])


def run_mono(camera, frames, draws=None):
    """A fresh KeyframeSLAM over the depth-free ``frames`` one a call,
    with ``draws`` as its uniforms hook, else its own generator; (slam,
    seconds)."""
    slam = KeyframeSLAM(camera, SLAMConfig(**SLAM_CFG), device=DEVICE,
                        uniforms=draws)
    if draws is not None:
        draws.slam = slam
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr in frames:
        slam.track(fr)
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0


def mono_record(slam, frames):
    m = slam_metrics(slam, frames, with_scale=True)
    return dict(first_mapped=next((i for i, st in enumerate(slam.stats)
                                   if st["n_kf"] > 0), None),
                tracked=tracked_frames(slam), keyframes=slam._n_frames_host,
                ate_scaled_m=m.ate_rmse, rpe_m=m.rpe_rmse,
                finite=bool(np.isfinite(slam.positions()).all()),
                inliers=[st["n_inliers"] for st in slam.stats])


def render(sequence):
    t0 = time.perf_counter()
    ds = SyntheticDataset(**sequence)
    ds.open("synth://")
    ds.render_ahead(RENDER_THREADS)
    frames = list(ds)
    return ds.camera, frames, time.perf_counter() - t0


def phase_mono():
    """KeyframeSLAM over the depth-free frames one a call with the JAX
    package's draws replayed, counters around it; the bootstrap,
    keyframe, kernel, tracked-frame and ATE gates.  Then, for the record,
    the same frames with the system's own draws and the textured
    scene."""
    camera, frames, render_s = render(MONO_SEQUENCE)
    draws = ReferenceDraws()
    reset_counts()
    slam, secs = run_mono(camera, frames, draws)
    launched = counts()
    n = len(frames)
    rec = mono_record(slam, frames)
    log(f"mono path launches over {n} frames: {launched} ({secs:.2f} s, "
        f"{render_s:.1f} s rendering)")
    log(f"mono, the JAX package's {draws.taken} draws replayed: map made on "
        f"frame {rec['first_mapped']}, {rec['tracked']}/{n} frames tracked "
        f"(JAX reference {REF_TRACKED_MONO}), {rec['keyframes']} keyframes, "
        f"ATE after scale alignment {rec['ate_scaled_m']!r} m (gate "
        f"{ATE_GATE_MONO:.4f} m; JAX reference {REF_ATE_MONO:.6f} m); inliers "
        f"{rec['inliers']}, the reference's {draws.inliers}")
    missing = [k for k in SLAM_PATH if launched[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the mono path never ran: {missing}")
    if not slam.initialized or rec["keyframes"] < 3:
        raise AssertionError(f"mono: initialized {slam.initialized}, "
                             f"{rec['keyframes']} keyframes")
    if rec["tracked"] < REF_TRACKED_MONO - 5:
        raise AssertionError(f"mono: {rec['tracked']} frames tracked, the "
                             f"reference {REF_TRACKED_MONO}")
    if not (rec["finite"] and rec["ate_scaled_m"] <= ATE_GATE_MONO):
        raise AssertionError(f"mono ATE {rec['ate_scaled_m']} m above "
                             f"{ATE_GATE_MONO}")
    own = mono_record(run_mono(camera, frames)[0], frames)
    camera, frames, _ = render(MONO_TEXTURED)
    textured = mono_record(run_mono(camera, frames)[0], frames)
    for label, r in (("the system's own draws", own),
                     ("the textured 1200-point scene", textured)):
        log(f"mono, {label} (not gated): map made on frame "
            f"{r['first_mapped']}, {r['tracked']}/{n} frames tracked, "
            f"{r['keyframes']} keyframes, ATE after scale alignment "
            f"{r['ate_scaled_m']!r} m")
    return launched, dict(frames=n, **rec, ms_per_frame=secs * 1e3 / n,
                          own_draws=own, textured=textured)


def phase_check_pyramid(frame):
    """B1 bit for bit on the three level images of the first frame's
    pyramid (as extract_features_pyramid forms them on the card), and B2
    bit for bit at each level's keypoint budget; the records for
    timing."""
    img = torch.as_tensor(frame.image, device=DEVICE)
    levels = frontend.image_pyramid(img, PYRAMID_CFG["n_levels"],
                                    PYRAMID_CFG["pyramid_scale"])
    ks = frontend.pyramid_budgets([lvl.shape for lvl in levels],
                                  PYRAMID_CFG["max_kps"])
    thr = PYRAMID_CFG["fast_threshold"]
    rec = {}
    for lev, (lvl, k) in enumerate(zip(levels, ks)):
        h, w = lvl.shape
        rec[f"pyramid_fast_nms_{h}x{w}"] = check_fast_nms(
            lvl, thr, f"pyramid level {lev}, {h}x{w}")
        blur, uv, ca, sa, kvalid = brief_inputs(lvl, int(k), thr)
        args = (blur, uv, ca, sa)
        same = torch.equal(brief.brief(*args),
                           frontend.brief_from_rotation(*args))
        log(f"B2 brief (pyramid level {lev}, {h}x{w}): K = {k} "
            f"({int(kvalid.sum())} valid), bit for bit {same}")
        if not same:
            raise AssertionError(f"BRIEF kernel is not bit-equal at pyramid "
                                 f"level {lev} (K={k})")
        assert_same_bits(lambda: (brief.brief(*args),),
                         f"B2 brief (pyramid level {lev})")
        rec[f"pyramid_brief_{h}x{w}_K{k}"] = dict(max_abs_err=0.0,
                                                  args=args, K=int(k))
    return rec


def phase_pyramid(camera, frames):
    """KeyframeSLAM with the three-level pyramid over the 64 frames, one
    a call, counters around it: B1 and B2 three times a frame, B4 once a
    tracked frame, B5 and B6 in local BA; tracked-frame, keyframe and
    ATE gates; then warm runs in turns (kernels, plain, kernels), the
    kernel runs repeating the first run's ATE bit for bit."""
    n = len(frames)
    reset_counts()
    slam, secs = run_slam(camera, frames, cfg=PYRAMID_CFG)
    launched = counts()
    tracked = tracked_frames(slam)
    n_kf = slam._n_frames_host
    m = slam_metrics(slam, frames)
    per_frame = {k: v / n for k, v in launched.items()}
    log(f"pyramid path launches over {n} frames: {launched} ({secs:.2f} s, "
        f"first run); per frame: "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_frame.items()))
    log(f"pyramid SLAM: {tracked}/{n} frames tracked, {n_kf} keyframes, "
        f"ATE {m.ate_rmse!r} m (gate {ATE_GATE_PYRAMID:.4f} m; JAX "
        f"reference {REF_ATE_PYRAMID:.6f} m), RPE {m.rpe_rmse:.6f} m; "
        f"features {[st['n_features'] for st in slam.stats[:8]]}...")
    missing = [k for k in SLAM_PATH if launched[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the pyramid path never ran: "
                             f"{missing}")
    levels = PYRAMID_CFG["n_levels"]
    if launched["fast_nms"] != levels * n or launched["brief"] != levels * n:
        raise AssertionError(f"B1 / B2 not {levels} launches a frame: "
                             f"{launched}")
    pos = slam.positions()
    if not np.isfinite(pos).all() or pos.shape != (n, 3):
        raise AssertionError("pyramid trajectory not finite or of the wrong "
                             "shape")
    if tracked < 0.9 * n or n_kf < 3:
        raise AssertionError(f"pyramid: {tracked} of {n} frames tracked, "
                             f"{n_kf} keyframes")
    if not m.ate_rmse <= ATE_GATE_PYRAMID:
        raise AssertionError(f"pyramid ATE {m.ate_rmse} m above "
                             f"{ATE_GATE_PYRAMID} m")
    runs = slam_turns(camera, frames, PYRAMID_CFG, m.ate_rmse, "pyramid")
    return launched, dict(
        frames=n, tracked=tracked, keyframes=n_kf, ate_m=m.ate_rmse,
        rpe_m=m.rpe_rmse, first_run_s=secs, launches_per_frame=per_frame,
        runs=runs)


def run_vi(camera, frames, inside):
    """A KeyframeSLAM run of VI_CFG over ``frames`` with the B5 / B6
    launches of each VI LM call appended to ``inside``; (slam,
    seconds)."""
    solve = keyframe_slam.vi_bundle_adjust

    def counted(*a, **kw):
        before = counts()
        out = solve(*a, **kw)
        after = counts()
        inside.append({k: after[k] - before[k] for k in ("schur",
                                                         "ba_cost")})
        return out

    keyframe_slam.vi_bundle_adjust = counted
    try:
        return run_slam(camera, frames, cfg=VI_CFG)
    finally:
        keyframe_slam.vi_bundle_adjust = solve


def phase_vi():
    """Visual-inertial KeyframeSLAM over 64 VGA frames with IMU windows,
    counters around it: VI initialized, gravity magnitude and direction,
    one factor and one loop edge per keyframe pair, ATE gate, B5 and B6
    launched inside the VI LM; a second run repeats the ATE bit for
    bit."""
    camera, frames, render_s = render(VI_SEQUENCE)
    n = len(frames)
    inside = []
    reset_counts()
    slam, secs = run_vi(camera, frames, inside)
    launched = counts()
    m = slam_metrics(slam, frames)
    tracked = tracked_frames(slam)
    n_kf = slam._n_frames_host
    g = None if slam.gravity_w is None else np.asarray(slam.gravity_w,
                                                      np.float64)
    g_norm = float("nan") if g is None else float(np.linalg.norm(g))
    cos = float("nan") if g is None else float(g @ GRAVITY_TRUE) / (
        g_norm * 9.81)
    st = slam.timer.stats()
    split = split_ms(slam, n)
    ms = secs * 1e3 / n
    costs = None if slam.vi_costs is None else slam.vi_costs.tolist()
    log(f"VI path launches over {n} frames: {launched} ({secs:.2f} s, "
        f"{render_s:.1f} s rendering); B5 / B6 launches inside each VI LM "
        f"call: {inside}")
    log(f"VI SLAM: {tracked}/{n} frames tracked, {n_kf} keyframes, "
        f"vi_ready {slam.vi_ready}, {len(slam.imu_factors)} IMU factors, "
        f"{len(slam.imu_edges)} loop edges, gravity {g} (|g| {g_norm:.6f}, "
        f"cos to true {cos:.6f}), ATE {m.ate_rmse!r} m (gate "
        f"{ATE_GATE_VI:.4f} m; JAX reference {REF_ATE_VI:.6f} m), RPE "
        f"{m.rpe_rmse:.6f} m")
    lba = st.get("slam/local_ba", {}).get("total", 0.0)
    log(f"VI SLAM: {ms:.3f} ms/frame ({n / secs:.2f} frames/s, first run); "
        f"slam/local_ba {lba:.3f} s ({100 * lba / secs:.1f}% of the wall, "
        f"{st.get('slam/local_ba', {}).get('count', 0)} runs, "
        f"{st.get('slam/vi_local_ba', {}).get('count', 0)} of them VI); "
        f"split ms/frame: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in split.items())
        + f"; rest (host glue) {rest_ms(ms, split):.3f}; the last VI LM's "
          f"costs {costs}")
    if not slam.vi_ready or g is None:
        raise AssertionError("VI: never initialized")
    if not (abs(g_norm - 9.81) < 0.2 and cos > 0.96):
        raise AssertionError(f"VI gravity {g}: |g| {g_norm}, cos {cos}")
    if not len(slam.imu_factors) == len(slam.imu_edges) >= n_kf - 2:
        raise AssertionError(f"VI: {len(slam.imu_factors)} factors, "
                             f"{len(slam.imu_edges)} edges, {n_kf} keyframes")
    if not any(c["schur"] >= 1 and c["ba_cost"] >= 1 for c in inside):
        raise AssertionError(f"no VI LM ran with B5 and B6: {inside}")
    if not (np.isfinite(slam.positions()).all()
            and m.ate_rmse <= ATE_GATE_VI):
        raise AssertionError(f"VI ATE {m.ate_rmse} m above {ATE_GATE_VI} m")
    slam2, secs2 = run_vi(camera, frames, [])
    ate2 = slam_metrics(slam2, frames).ate_rmse
    log(f"VI SLAM second run: {secs2 * 1e3 / n:.3f} ms/frame, ATE {ate2!r} "
        f"m")
    if ate2 != m.ate_rmse:
        raise AssertionError(f"VI second run: ATE {ate2!r} m differs from "
                             f"{m.ate_rmse!r} m")
    return launched, dict(
        frames=n, tracked=tracked, keyframes=n_kf, vi_ready=slam.vi_ready,
        imu_factors=len(slam.imu_factors), imu_edges=len(slam.imu_edges),
        gravity_w=g.tolist(), gravity_norm=g_norm, gravity_cos=cos,
        ate_m=m.ate_rmse, rpe_m=m.rpe_rmse,
        ms_per_frame_runs=[ms, secs2 * 1e3 / n], split_ms_per_frame=split,
        local_ba_s=lba, local_ba_share=lba / secs,
        vi_lm_launches=inside, last_vi_costs=costs)


# ---------------------------------------------------------------------------
# lens models, undistortion and rectification; files on disk

# the TUM benchmark's Freiburg-1 calibration (gslam_tpu/datasets/
# tum_rgbd.py's default camera: OpenCV radial-tangential with k3)
FR1_ARGS = (640, 480, 517.3, 516.5, 318.6, 255.3,
            0.2624, -0.9531, -0.0054, 0.0026, 1.1633)
# card against CPU: a few float32 ulps (CUDA's tanf, atanf and atan2f
# are within 2 to 4 ulps of the rounded result, PyTorch's CPU versions
# within 1): pixels to 1e-3 px, rays to 1e-5, remapped images to 1e-6
LENS_PX_TOL, LENS_RAY_TOL, REMAP_TOL = 1e-3, 1e-5, 1e-6


def ocam_calibration():
    """tests/test_geometry.py's OCAM calibration: a near-equidistant
    omnidirectional fit (cam2world degree 5, world2cam degree 9)."""
    f = 300.0
    rho = np.linspace(1e-3, f * 1.2, 64)
    theta = rho / f
    z_over_rxy = np.cos(theta) / np.sin(theta) * rho
    poly = np.polynomial.polynomial.polyfit(rho, z_over_rxy, 5)
    ang = np.arctan2(z_over_rxy, rho)
    inv = np.polynomial.polynomial.polyfit(ang, rho, 9)
    return [320.0, 240.0], [1.0, 0.0, 0.0], poly, inv


# the four models at tests/test_geometry.py:185-246's calibrations (VGA)
LENS_ARGS = {
    "pinhole": (640, 480, 500.0, 505.0, 320.0, 240.0),
    "atan": (640, 480, 500.0, 505.0, 320.0, 240.0, 0.9),
    "opencv": (640, 480, 500.0, 505.0, 320.0, 240.0,
               0.05, -0.01, 0.001, -0.002, 0.002),
    "ocam": (640, 480, *ocam_calibration()),
}


def lens_camera(model):
    return getattr(Camera, model)(*LENS_ARGS[model])


def pixel_grid(W=640, H=480):
    """(H * W, 2) float32 pixel centres, row-major."""
    uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    return np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)


def lens_points(cam, seed=0):
    """Camera-frame points seen at every pixel of the VGA grid: the CPU
    unprojection of the pixel centres, at seeded depths 0.5 to 8 (unit
    rays scaled for OCAM)."""
    rays = cam.unproject(torch.from_numpy(pixel_grid()))
    depth = np.random.default_rng(seed).uniform(0.5, 8.0, (len(rays), 1))
    return rays * torch.from_numpy(depth.astype(np.float32))


def border_only(got, ref, uv, W, H, tol):
    """Indices where two validity masks differ at a pixel coordinate more
    than ``tol`` from the image border (none is allowed)."""
    d = np.nonzero(got != ref)[0]
    u, v = uv[d, 0], uv[d, 1]
    near = ((np.abs(u) < tol) | (np.abs(u - W) < tol) | (np.abs(v) < tol)
            | (np.abs(v - H) < tol))
    return d[~near]


def rotated_rig():
    """tests/test_datasets_eval.py:350's rig: cam1 turned 2 / 1 / 0.5
    degrees about y / x / z and 1.2 m along x; (R10, c1, T_c1c0)."""
    def rot(axis, deg):
        a = np.radians(deg)
        c, s = np.cos(a), np.sin(a)
        return np.array({"x": [[1, 0, 0], [0, c, -s], [0, s, c]],
                         "y": [[c, 0, s], [0, 1, 0], [-s, 0, c]],
                         "z": [[c, -s, 0], [s, c, 0], [0, 0, 1]]}[axis])

    R10 = rot("y", 2.0) @ rot("x", 1.0) @ rot("z", 0.5)
    c1 = np.array([1.2, 0.0, 0.0])
    T10 = np.eye(4)
    T10[:3, :3] = R10
    T10[:3, 3] = -R10 @ c1
    return R10, c1, T10


def phase_lens():
    """The four lens models' project and unproject over a VGA pixel grid,
    the Freiburg-1 Undistorter on one VGA frame, and the StereoRectifier's
    two remaps on the rotated distorted rig: on the card against the same
    call on the CPU (max abs error each, gated at a few ulps), with the
    card's time of each call."""
    out = {}
    grid = torch.from_numpy(pixel_grid())
    for model in LENS_ARGS:
        cam = lens_camera(model)
        p = lens_points(cam)
        uv_c, ok_c = cam.project(p)
        uv_d, ok_d = cam.project(p.to(DEVICE))
        r_c = cam.unproject(grid)
        r_d = cam.unproject(grid.to(DEVICE))
        torch.cuda.synchronize()
        uv_d, ok_d, r_d = uv_d.cpu(), ok_d.cpu(), r_d.cpu()
        fin = torch.isfinite(uv_c).all(-1)
        px_err = float((uv_d - uv_c)[fin].abs().max())
        ray_err = float((r_d - r_c).abs().max())
        bad = border_only(ok_d.numpy(), ok_c.numpy(), uv_c.numpy(), 640, 480,
                          LENS_PX_TOL)
        mask_diff = int((ok_d != ok_c).sum())
        pd, gd = p.to(DEVICE), grid.to(DEVICE)
        ms_p = cuda_ms(lambda: cam.project(pd), reps=20)
        ms_u = cuda_ms(lambda: cam.unproject(gd), reps=20)
        log(f"lens {model}: project {len(p)} points max abs err "
            f"{px_err:.3g} px ({int(ok_c.sum())} in the image, {mask_diff} "
            f"masks differ at the border), unproject max abs err "
            f"{ray_err:.3g}; card {ms_p:.4f} / {ms_u:.4f} ms")
        if not (px_err <= LENS_PX_TOL and ray_err <= LENS_RAY_TOL
                and len(bad) == 0 and torch.isfinite(r_d).all()):
            raise AssertionError(f"lens {model}: card against CPU {px_err} "
                                 f"px, {ray_err} in rays, masks differ at "
                                 f"{bad[:4]}")
        out[model] = dict(project_max_abs_err_px=px_err,
                          unproject_max_abs_err=ray_err,
                          mask_differences=mask_diff, project_ms=ms_p,
                          unproject_ms=ms_u, points=len(p))
    # the Freiburg-1 undistortion of one VGA frame of the distorted scene
    ds = SyntheticDataset(**dict(DISTORTED_SEQUENCE, n_frames=1))
    ds.open("synth://")
    img = torch.from_numpy(next(iter(ds)).image)
    und = Undistorter(Camera.opencv(*FR1_ARGS))
    ref = und.undistort(img)
    img_d = img.to(DEVICE)
    got = und.undistort(img_d).cpu()
    err = float((got - ref).abs().max())
    ms = cuda_ms(lambda: und.undistort(img_d), reps=50)
    log(f"Undistorter (Freiburg-1, 480x640): card against CPU max abs err "
        f"{err:.3g}, {float(und.valid.mean()):.4f} of pixels valid; card "
        f"{ms:.4f} ms a frame")
    if not (err <= REMAP_TOL and ref[torch.from_numpy(und.valid)].std() > 0):
        raise AssertionError(f"Undistorter: card against CPU {err}")
    out["undistort_fr1"] = dict(max_abs_err=err, ms=ms,
                                valid_share=float(und.valid.mean()))
    # the two rectification remaps of the rotated, distorted rig at VGA
    R10, c1, T10 = rotated_rig()
    rig = SyntheticDataset(**dict(DISTORTED_SEQUENCE, n_frames=1, n_points=0,
                                  depth=False))
    rig.open("synth://")
    img0, _ = rig._render(np.eye(3), np.zeros(3), False)
    img1, _ = rig._render(R10.T, c1, False)
    rec = StereoRectifier(rig.camera, rig.camera, T10)
    pair = (torch.from_numpy(img0), torch.from_numpy(img1))
    ref = rec.rectify(*pair)
    pair_d = tuple(t.to(DEVICE) for t in pair)
    got = [t.cpu() for t in rec.rectify(*pair_d)]
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    ms = cuda_ms(lambda: rec.rectify(*pair_d), reps=50)
    log(f"StereoRectifier (rotated distorted rig, 480x640, baseline "
        f"{rec.baseline:.4f} m): card against CPU max abs err {errs}; card "
        f"{ms:.4f} ms a pair")
    if not (max(errs) <= REMAP_TOL and abs(rec.baseline - 1.2) < 1e-9):
        raise AssertionError(f"StereoRectifier: card against CPU {errs}")
    out["rectify_pair"] = dict(max_abs_err=errs, ms=ms,
                               baseline=rec.baseline)
    return out


def phase_distorted(camera, frames):
    """The hard synthetic gate at full width: KeyframeSLAM over the 40
    distorted frames one a call, counters around it, twice (the same ATE
    bit for bit); then through track_batch, 8 a dispatch, counters
    around it (each graph's replays counted); then that graph against its
    eager body on one batch.  Tracked share, keyframes and the ATE gates
    for both."""
    n = len(frames)
    reset_counts()
    slam, secs = run_slam(camera, frames, cfg=DISTORTED_CFG)
    launched = counts()
    m = slam_metrics(slam, frames)
    tracked, n_kf = tracked_frames(slam), slam._n_frames_host
    split = split_ms(slam, n)
    log(f"distorted path launches over {n} frames: {launched} ({secs:.2f} "
        f"s, first run)")
    log(f"distorted SLAM: {tracked}/{n} frames tracked, {n_kf} keyframes, "
        f"ATE {m.ate_rmse!r} m (gate {ATE_GATE_DISTORTED:.4f} m; JAX "
        f"reference {REF_ATE_DISTORTED:.6f} m), RPE {m.rpe_rmse:.6f} m; "
        f"{secs * 1e3 / n:.3f} ms/frame; split ms/frame: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    slam2, secs2 = run_slam(camera, frames, cfg=DISTORTED_CFG)
    ate2 = slam_metrics(slam2, frames).ate_rmse
    log(f"distorted SLAM second run: {secs2 * 1e3 / n:.3f} ms/frame, ATE "
        f"{ate2!r} m")
    reset_counts()
    bslam, bsecs, cap_s = run_batched(camera, frames, cfg=DISTORTED_BATCH_CFG)
    blaunched = batched_launches(bslam, counts())
    bm = slam_metrics(bslam, frames)
    btracked, bn_kf = tracked_frames(bslam), bslam._n_frames_host
    log(f"distorted track_batch launches over {n} frames: {blaunched} "
        f"({bsecs:.2f} s, {cap_s:.3f} s of it capturing); {btracked}/{n} "
        f"tracked, {bn_kf} keyframes, accepted per dispatch "
        f"{bslam.batch_accepted}, ATE {bm.ate_rmse!r} m (gate "
        f"{ATE_GATE_DISTORTED_BATCHED:.4f} m; JAX reference "
        f"{REF_ATE_DISTORTED_BATCHED:.6f} m); {bsecs * 1e3 / n:.3f} ms/frame")
    for what, lau in (("distorted", launched), ("distorted batched",
                                                blaunched)):
        missing = [k for k in SLAM_PATH if lau[k] < 1]
        if missing:
            raise AssertionError(f"kernels of the {what} path never ran: "
                                 f"{missing}")
    for what, s, mm, tr, kf, gate in (
            ("distorted", slam, m, tracked, n_kf, ATE_GATE_DISTORTED),
            ("distorted batched", bslam, bm, btracked, bn_kf,
             ATE_GATE_DISTORTED_BATCHED)):
        if not np.isfinite(s.positions()).all() or tr < 0.9 * n or kf < 4:
            raise AssertionError(f"{what}: {tr} of {n} frames tracked, {kf} "
                                 "keyframes, or a trajectory not finite")
        if not mm.ate_rmse <= gate:
            raise AssertionError(f"{what} ATE {mm.ate_rmse} m above {gate} m")
    if ate2 != m.ate_rmse:
        raise AssertionError(f"distorted second run: ATE {ate2!r} m differs "
                             f"from {m.ate_rmse!r} m")
    if bslam.timer.stats().get("slam/track_batch", {}).get("count", 0) < 1:
        raise AssertionError("distorted: no batch dispatched")
    graph = phase_graph_vs_eager(camera, frames, DISTORTED_BATCH_CFG,
                                 DISTORTED_EAGER_AT)
    return launched, blaunched, dict(
        frames=n, tracked=tracked, keyframes=n_kf, ate_m=m.ate_rmse,
        rpe_m=m.rpe_rmse, ms_per_frame_runs=[secs * 1e3 / n,
                                             secs2 * 1e3 / n],
        split_ms_per_frame=split,
        batched=dict(tracked=btracked, keyframes=bn_kf, ate_m=bm.ate_rmse,
                     ms_per_frame=bsecs * 1e3 / n, capture_s=cap_s,
                     accepted=bslam.batch_accepted,
                     launches=blaunched),
        graph_vs_eager=graph)


def write_tum_sequence(root, frames, camera):
    """Write rendered frames in the TUM RGB-D layout under ``root``: each
    gray frame as an 8-bit RGB PNG (the gray level in all three
    channels), its depth as a 16-bit PNG at 5000 a metre stamped
    TUM_DEPTH_DT later, rgb.txt, depth.txt, groundtruth.txt (cam ->
    world, quaternion xyzw, float32 values in full) and calib.txt
    ("fx fy cx cy k1 k2 0 0 0" of the OpenCV ``camera``).  Returns the
    (rgb, depth16) arrays written, frame by frame."""
    root = Path(root)
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines = ["# color images", "# timestamp filename"]
    depth_lines = ["# depth maps", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory",
                "# timestamp tx ty tz qx qy qz qw"]
    written = []
    for fr in frames:
        t = fr.timestamp
        g = np.round(fr.image * 255.0).astype(np.uint8)
        rgb = np.repeat(g[..., None], 3, -1)
        d16 = np.round(fr.depth * 5000.0).clip(0, 65535).astype(np.uint16)
        td = t + TUM_DEPTH_DT
        name, dname = f"{t:.6f}.png", f"{td:.6f}.png"
        write_png(root / "rgb" / name, rgb)
        write_png(root / "depth" / dname, d16)
        rgb_lines.append(f"{t:.6f} rgb/{name}")
        depth_lines.append(f"{td:.6f} depth/{dname}")
        p = fr.gt_pose                      # [t, qw qx qy qz]
        gt_lines.append(" ".join([f"{t:.6f}"] + [
            f"{float(p[i]):.9g}" for i in (0, 1, 2, 4, 5, 6, 3)]))
        written.append((rgb, d16))
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        (root / name).write_text("\n".join(lines) + "\n")
    k = camera.params
    (root / "calib.txt").write_text(
        " ".join(f"{float(v):.9g}" for v in k[:6]) + " 0 0 0\n")
    return written


def phase_tum_disk(tmp):
    """The main path from files: render the 64 frames, write them in the
    TUM RGB-D layout into ``tmp`` (which phase_app reads after), build
    the native decoder, open the directory with open_dataset(dir +
    ".tumrgbd"), check every decoded frame against what was written (bit
    for bit) and the camera (OpenCV, the synthetic parameters), time the
    decoding (the player's frames, the colour files alone, and
    NativeLoader's readahead of their gray), then KeyframeSLAM over the
    decoded frames, counters around it, against the JAX package's run
    over the same files.  Returns (launches, checks, the run: the
    directory, the system and the decoded frames)."""
    camera, frames, render_s = render(TUM_SEQUENCE)
    n = len(frames)
    root = os.path.join(tmp, "synth_distorted")
    t0 = time.perf_counter()
    written = write_tum_sequence(root, frames, camera)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = native_loader.build()
    build_s = time.perf_counter() - t0
    if lib.parent != build.BUILD_DIR or not lib.is_file():
        raise AssertionError(f"native library not built: {lib}")
    ds = open_dataset(root + ".tumrgbd")
    if not (ds.is_opened() and len(ds) == n
            and ds.camera.model == "opencv"
            and np.array_equal(ds.camera.params, camera.params)):
        raise AssertionError(f"TUM player: opened {ds.is_opened()}, "
                             f"{len(ds)} frames, camera "
                             f"{ds.camera.info()}")
    t0 = time.perf_counter()
    disk = list(ds)
    decode_s = time.perf_counter() - t0
    for i, (fr, (rgb, d16)) in enumerate(zip(disk, written)):
        same = (np.array_equal(fr.color, rgb)
                and fr.depth.dtype == np.float32
                and np.array_equal(fr.depth,
                                   d16.astype(np.float32) / 5000.0)
                and np.array_equal(fr.image, to_gray_f32(rgb))
                and np.array_equal(fr.gt_pose, frames[i].gt_pose)
                and abs(fr.timestamp - frames[i].timestamp) < 1e-6)
        if not same:
            raise AssertionError(f"decoded frame {i} differs from what "
                                 "was written")
    paths = [os.path.join(root, rel) for _, rel in ds.rgb]
    t0 = time.perf_counter()
    for p in paths:
        native_loader.read_rgb_u8(p)
    rgb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gray = [native_loader.read_gray_f32(p) for p in paths]
    gray_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader = native_loader.NativeLoader(paths, n_threads=4, ring=8)
    try:
        ahead = [loader.next() for _ in paths]
        end = loader.next()
    finally:
        loader.close()
    ahead_s = time.perf_counter() - t0
    if end is not None or not all(np.array_equal(a, g)
                                  for a, g in zip(ahead, gray)):
        raise AssertionError("NativeLoader's frames differ from the "
                             "plain decode, or it did not end")
    reset_counts()
    slam, secs = run_slam(ds.camera, disk, cfg=DISTORTED_CFG)
    launched = counts()
    m = slam_metrics(slam, disk)
    tracked, n_kf = tracked_frames(slam), slam._n_frames_host
    decode = dict(player_ms_per_frame=decode_s * 1e3 / n,
                  rgb_decode_ms_per_frame=rgb_s * 1e3 / n,
                  gray_decode_ms_per_frame=gray_s * 1e3 / n,
                  readahead_ms_per_frame=ahead_s * 1e3 / n,
                  write_ms_per_frame=write_s * 1e3 / n, build_s=build_s,
                  render_s=render_s)
    log(f"TUM layout on disk: {n} frames written ({write_s:.2f} s), native "
        f"decoder built in {build_s:.2f} s ({lib.name}); every decoded frame "
        f"equals what was written (colour, depth, gray, ground truth), "
        f"camera {ds.camera.model}; decode ms/frame: player (colour + depth "
        f"+ gray) {decode['player_ms_per_frame']:.3f}, colour files alone "
        f"{decode['rgb_decode_ms_per_frame']:.3f}, their gray "
        f"{decode['gray_decode_ms_per_frame']:.3f}, NativeLoader readahead "
        f"(4 threads) {decode['readahead_ms_per_frame']:.3f}")
    log(f"TUM path launches over {n} frames: {launched}; {tracked}/{n} "
        f"frames tracked, {n_kf} keyframes, ATE {m.ate_rmse!r} m (gate "
        f"{ATE_GATE_TUM:.4f} m; JAX reference {REF_ATE_TUM:.6f} m), RPE "
        f"{m.rpe_rmse:.6f} m; track {secs * 1e3 / n:.3f} ms/frame beside "
        f"decode {decode['player_ms_per_frame']:.3f} ms/frame")
    missing = [k for k in SLAM_PATH if launched[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the TUM path never ran: {missing}")
    if not np.isfinite(slam.positions()).all() or tracked < 0.9 * n \
            or n_kf < 4:
        raise AssertionError(f"TUM: {tracked} of {n} frames tracked, {n_kf} "
                             "keyframes, or a trajectory not finite")
    if not m.ate_rmse <= ATE_GATE_TUM:
        raise AssertionError(f"TUM ATE {m.ate_rmse} m above {ATE_GATE_TUM} m")
    return launched, dict(frames=n, tracked=tracked, keyframes=n_kf,
                          ate_m=m.ate_rmse, rpe_m=m.rpe_rmse,
                          track_ms_per_frame=secs * 1e3 / n,
                          split_ms_per_frame=split_ms(slam, n),
                          decode=decode), dict(
        root=root, slam=slam, frames=disk,
        track_ms_per_frame=secs * 1e3 / n)


# the app layer's path (phase_app): the CLI's run over the TUM cell's
# files launches the SLAM path; with a vocabulary, B7 as well
APP_PATH = SLAM_PATH
APP_VOCAB_PATH = SLAM_PATH + ("bow_descent",)
APP_VOCAB_FRAMES = 16


def app_flags():
    """The CLI flags of DISTORTED_CFG: -slam keyframe -slam.<field> v
    (and -cpu true when DEVICE is the CPU)."""
    out = ["-slam", "keyframe"] + (["-cpu", "true"] if DEVICE == "cpu"
                                   else [])
    for k, v in DISTORTED_CFG.items():
        out += [f"-slam.{k}", str(v)]
    return out


def viewer_data(html_path):
    """The viewer's embedded JSON (``const D = {...};``)."""
    txt = Path(html_path).read_text()
    return json.loads(txt.split("const D = ", 1)[1].split(";\n", 1)[0])


def phase_app(tum, main_out, frames):
    """The port's user surface over the TUM cell's files (module
    docstring, phase 14): ``python -m gslam_tpu_torch eval`` in a
    subprocess against phase_tum_disk's in-process run; ``cli.main(["viz",
    ...])`` in this process, counters around it; ``SLAMPipeline`` with
    ``DatasetPlayer(rate=0)``; ``play -vocabulary`` over 16 frames,
    counters around it; ``bench.main`` on ``frames`` (the 192-frame
    scene); ``graft_entry.entry()`` against phase_main_path's outputs;
    ``graft_entry.dryrun_multichip(1)``.  Returns (launches of the viz
    run, launches of the vocabulary run, checks)."""
    from gslam_tpu_torch import graft_entry
    from gslam_tpu_torch.app import cli
    from gslam_tpu_torch.app.config import Svar
    from gslam_tpu_torch.app.messenger import Messenger
    from gslam_tpu_torch.datasets.base import DatasetPlayer
    from gslam_tpu_torch.eval.trajectory import save_tum_trajectory
    from gslam_tpu_torch.map.arena import load_arena
    from gslam_tpu_torch.models.pipeline import (CURFRAME_TOPIC, MAP_TOPIC,
                                                 SLAMPipeline)

    path = tum["root"] + ".tumrgbd"
    ref, disk = tum["slam"], tum["frames"]
    n = len(disk)
    flags = app_flags()
    out = Path(tum["root"]).parent / "app"
    out.mkdir()
    # the in-process run's trajectory through the CLI's own writer
    direct = out / "direct.txt"
    save_tum_trajectory(str(direct), np.asarray([f.timestamp for f in disk]),
                        torch.stack(ref.trajectory)[:, :7].cpu().numpy())
    want = direct.read_text()

    # 1. the CLI in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gslam_tpu_torch", "eval", "-dataset", path,
         *flags, "-out", str(out / "report.json"),
         "-save_traj", str(out / "traj.txt"),
         "-save_map", str(out / "map.npz"), "-metrics", str(out / "m.jsonl")],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    proc_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m gslam_tpu_torch eval exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    rep = json.loads((out / "report.json").read_text())
    rows = [json.loads(x) for x in open(out / "m.jsonl")]
    got = (out / "traj.txt").read_text()
    arena = load_arena(str(out / "map.npz"), device=DEVICE)
    frame_ms = rep["timing"]["app/frame"]["mean"] * 1e3
    startup_s = proc_s - rep["timing"]["app/frame"]["total"]
    log(f"app: python -m gslam_tpu_torch eval over {n} TUM files: exit 0 in "
        f"{proc_s:.2f} s ({startup_s:.2f} s outside the frames: start-up, "
        f"kernels loaded, decode, writing), app/frame {frame_ms:.3f} ms "
        f"(in-process {tum['track_ms_per_frame']:.3f}); ATE "
        f"{rep['ate_rmse']!r} m (gate {ATE_GATE_TUM:.4f} m), {rep['frames']} "
        f"frames, {rep['keyframes']} keyframes, device memory "
        f"{rep['device_hbm_mb']:.1f} MB; trajectory bit for bit the "
        f"in-process run: {got == want}; {len(rows)} metric rows; map "
        f"{int(arena.n_frames)} keyframes")
    if got != want:
        raise AssertionError("the CLI's trajectory differs from the "
                             "in-process KeyframeSLAM over the same files")
    if not rep["ate_rmse"] <= ATE_GATE_TUM or rep["frames"] != n:
        raise AssertionError(f"CLI eval: ATE {rep['ate_rmse']} (gate "
                             f"{ATE_GATE_TUM}), {rep['frames']} frames")
    if len(rows) != n or [r["frame"] for r in rows] != list(range(n)):
        raise AssertionError(f"CLI eval: {len(rows)} metric rows")
    if int(arena.n_frames) != ref._n_frames_host:
        raise AssertionError(f"saved map: {int(arena.n_frames)} keyframes, "
                             f"the run {ref._n_frames_host}")

    # 2. viz in this process, counters around it
    prefix = str(out / "viz")
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["viz", "-dataset", path, *flags, "-out", prefix,
                   "-save_traj", str(out / "viz.txt")])
    torch.cuda.synchronize()
    viz_s = time.perf_counter() - t0
    launched = counts()
    data = viewer_data(prefix + ".html")
    missing = [k for k in APP_PATH if launched[k] < 1]
    outputs = {x: os.path.getsize(prefix + x) for x in
               (".html", "_traj.ply", "_map.ply", ".png")}
    log(f"app: cli.main(['viz', ...]) exit {rc} in {viz_s:.2f} s; launches "
        f"{launched}; outputs {outputs} bytes; viewer: {len(data['traj'])} "
        f"poses, {len(data['points'])} points, {len(data['frusta'])} "
        f"keyframes, {len(data['covis']) // 2} covisibility edges")
    if rc != 0 or missing:
        raise AssertionError(f"viz: exit {rc}, kernels never ran: {missing}")
    if (out / "viz.txt").read_text() != got:
        raise AssertionError("viz's trajectory differs from the eval run's")
    if len(data["traj"]) != n or not data["frusta"] or not data["points"]:
        raise AssertionError("viz: the viewer's data is incomplete")
    if Path(prefix + ".png").read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("viz: no PNG")

    # 3. the messenger-wired pipeline
    ds = open_dataset(path)
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**DISTORTED_CFG),
                        device=DEVICE)
    bus = Messenger()
    poses, maps = [], []
    bus.subscribe(CURFRAME_TOPIC, 0, poses.append)
    bus.subscribe(MAP_TOPIC, 0, maps.append)
    pipe = SLAMPipeline(slam, bus=bus, queue_size=len(ds))
    t0 = time.perf_counter()
    player = DatasetPlayer(ds, bus=bus, rate=0.0).start()
    try:
        if not pipe.wait(600.0):
            raise AssertionError("pipeline: no end of stream")
    finally:
        player.stop()
        pipe.shutdown()
    pipe_s = time.perf_counter() - t0
    same = (len(poses) == n
            and [p["id"] for p in poses] == list(range(n))
            and all(np.array_equal(p["pose"], t.cpu().numpy())
                    for p, t in zip(poses, ref.trajectory)))
    log(f"app: SLAMPipeline + DatasetPlayer(rate=0): {len(poses)} poses in "
        f"{pipe_s:.2f} s, ids in order and bit for bit the direct loop: "
        f"{same}; {len(maps)} map messages")
    if not same or not maps:
        raise AssertionError("pipeline differs from the direct loop")

    # 4. -vocabulary over the first frames, counters around it
    voc = train_loop_vocabulary(open_dataset(path))
    vocab.save_vocabulary(voc, str(out / "voc.npz"))
    s = Svar()
    s.parse_main(["play", "-dataset", path, *flags, "-vocabulary",
                  str(out / "voc.npz"), "-Dataset.Max",
                  str(APP_VOCAB_FRAMES)])
    reset_counts()
    rc = cli.app_play(s)
    torch.cuda.synchronize()
    launched_voc = counts()
    log(f"app: play -vocabulary over {APP_VOCAB_FRAMES} frames: exit {rc}, "
        f"launches {launched_voc}")
    missing = [k for k in APP_VOCAB_PATH if launched_voc[k] < 1]
    if rc != 0 or missing:
        raise AssertionError(f"-vocabulary: exit {rc}, kernels never ran: "
                             f"{missing}")

    # 5. the port's bench line
    t0 = time.perf_counter()
    line = bench.main(frames=frames)
    bench_s = time.perf_counter() - t0
    log(f"app: bench ({bench_s:.1f} s) on {card_name_and_power_limit()}: "
        + json.dumps(line))

    # 6. graft entry: the step and its example, bit for bit phase 2
    fn, args = graft_entry.entry()
    T, n_inl, n_feat = fn(*args[:5], generator=args[5])
    T0, n0, nf0 = main_out
    entry_same = (torch.equal(T.cpu(), T0) and int(n_inl) == n0
                  and int(n_feat) == nf0)
    log(f"app: graft_entry.entry() bit for bit phase_main_path: "
        f"{entry_same} ({int(n_inl)} inliers, {int(n_feat)} features)")
    if not entry_same:
        raise AssertionError("graft_entry.entry() differs from "
                             "phase_main_path")
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(1)
    dry_s = time.perf_counter() - t0
    log(f"app: dryrun_multichip(1) in {dry_s:.1f} s: " + json.dumps(dry))
    return launched, launched_voc, dict(
        eval=dict(seconds=proc_s, outside_frames_s=startup_s,
                  frame_ms=frame_ms, ate_m=rep["ate_rmse"],
                  keyframes=rep["keyframes"],
                  device_hbm_mb=rep["device_hbm_mb"],
                  same_as_in_process=True,
                  in_process_ms_per_frame=tum["track_ms_per_frame"]),
        viz=dict(seconds=viz_s, outputs=outputs), pipeline_s=pipe_s,
        bench=line, bench_s=bench_s, graft_entry_same=entry_same,
        dryrun=dry, dryrun_s=dry_s)


def schur_work(prob):
    """(bytes, float operations) of one B5 call on ``prob``."""
    C = prob.cam_pose.shape[0]
    P, O = prob.obs_cam.shape
    n_obs = int(prob.obs_valid.sum())
    # distinct cameras per point: the Schur correction's camera pairs
    cams = torch.zeros((P, C), dtype=torch.bool, device=DEVICE)
    cams[torch.arange(P, device=DEVICE)[:, None].expand(P, O),
         prob.obs_cam.long().clamp(0, C - 1)] = prob.obs_valid
    pairs = int((cams.sum(1) ** 2).sum())
    # per observation: residual and weight (34), Jacobians (30), Hpp
    # and bp (45), W_e (72), Y = W_e Hpp^-1 (90), Hcc (84) and b (40);
    # per point the 3x3 inverse (40); per camera pair of a point the
    # 6x6 block of U V^T (216)
    n_bytes = (C * 16 * 4 + P * 16 + P * O * 16             # inputs
               + P * 48 + P * O * 72 + (36 * C * C + 42 * C) * 4)
    return n_bytes, n_obs * 395 + P * 40 + pairs * 216


def gated_matcher_work(a_map, v_map, a_kp, v_kp, uv_map, uv_kp, gate2):
    """(bytes, float operations, Hamming steps, other integer
    operations) of one B4 call: per pair the gate (2 subtractions, 2
    products, 1 sum, 1 compare: float operations); per pair inside the
    gate 8 Hamming steps (xor, popc, add) and 3 top-2 compares."""
    N, Mk = a_map.shape[0], a_kp.shape[0]
    d2 = ((uv_map[:, None] - uv_kp[None]) ** 2).sum(-1)
    n_gated = int((v_map[:, None] & v_kp[None] & (d2 <= gate2)).sum())
    return ((N + Mk) * (32 + 8 + 1) + N * 12, N * Mk * 6, n_gated * 8,
            n_gated * 3)


def phase_slam_kernel_times(rec, launched, n_frames, ba_runs):
    """B4, B5 and B6 device times beside their plain versions, at the
    SLAM path's shapes, with bounds from this run's inputs."""
    g = rec["gated_matcher"]["args"]
    prob, lam = rec["schur"]["args"]
    work = {"gated_matcher": gated_matcher_work(*g),
            "schur": schur_work(prob), "ba_cost": cost_work(prob)}
    calls = {
        "gated_matcher": (lambda: matcher.gated_top2_kernel(*g),
                          lambda: hamming_top2_gated(*g)),
        "schur": (lambda: schur.schur_reduce_kernel(prob, lam, 0.01),
                  lambda: ba.schur_reduce(prob, lam, 0.01)),
        "ba_cost": (lambda: schur.ba_cost_kernel(prob, 0.01),
                    lambda: ba.ba_cost(prob, 0.01)),
    }
    per = {"gated_matcher": f"{launched['gated_matcher'] / n_frames:.3f} "
           "per frame",
           "schur": f"{launched['schur'] / ba_runs:.2f} per local BA",
           "ba_cost": f"{launched['ba_cost'] / ba_runs:.2f} per local BA"}
    return time_kernels(calls, work, rec, launched, per)


def phase_partials_kernel_time(rec, launched):
    """B5's partials entry at the fleet ring's per-shard shape (world 4,
    rank 0) beside its plain version, with its bound; gslam_schur on the
    same shard is among the extra shapes (``schur_fleet_shard``)."""
    shard, lam = rec["schur_partials"]["args"]
    calls = {"schur_partials": (
        lambda: schur.schur_partials_kernel(shard, lam, 0.01),
        lambda: schur.schur_partials_plain(shard, lam, 0.01))}
    return time_kernels(calls, {"schur_partials": schur_work(shard)}, rec,
                        launched, {"schur_partials": "on the fleet path"})


def random_words(rng, n):
    """(n, 8) random descriptors as uint32 words."""
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def descent_case(voc, N, seed, p_invalid=0.0):
    """B7 inputs on the card: N descriptors, a third of them node
    centres of ``voc`` with a few bits flipped (they descend to known
    words), the rest random; a share ``p_invalid`` masked."""
    rng = np.random.default_rng(seed)
    nodes = vocab.vocabulary_to_numpy(voc)["node_desc"]
    desc = random_words(rng, N)
    near = rng.integers(1, nodes.shape[0], N // 3)
    desc[:N // 3] = nodes[near] ^ (np.uint32(1) << rng.integers(
        0, 32, (N // 3, 8)).astype(np.uint32))
    valid = rng.random(N) >= p_invalid
    return (torch.as_tensor(desc.view(np.int32), device=DEVICE),
            torch.as_tensor(valid, device=DEVICE))


def deep_tree(k, L, seed):
    """A complete tree of random centres on the card whose first two
    children of every node are equal (tied distances at every level)."""
    rng = np.random.default_rng(seed)
    nodes = random_words(rng, vocab._level_offset(k, L + 1))
    for l in range(1, L + 1):
        lo, hi = vocab._level_offset(k, l), vocab._level_offset(k, l + 1)
        nodes[lo + 1:hi:k] = nodes[lo:hi:k]
    return vocab.vocabulary_from_numpy(nodes, np.ones(k ** L, np.float32),
                                       k, L, device=DEVICE)


def vocab_cases():
    """B7's cases: label -> (tree, N, share of invalid rows).  A
    keyframe's descriptors and the verification's slab on the loop
    path's tree shape, the top of the JAX package's table contract (and
    N off any block multiple), and the deep tree."""
    rng = np.random.default_rng(11)
    voc_loop = vocab.train_vocabulary(
        random_words(rng, 4000), k=LOOP_VOC["k"], L=LOOP_VOC["L"], seed=0,
        device=DEVICE)
    voc_big = vocab.train_vocabulary(random_words(rng, 40000), seed=0,
                                     device=DEVICE, **VOC_BIG)
    voc_deep = deep_tree(**VOC_DEEP, seed=12)
    return {"loop": (voc_loop, LOOP_CFG["max_kps"], 0.1),
            "slab": (voc_loop, VERIFY_SLAB, 0.1),
            "big": (voc_big, 512, 0.0), "big_odd": (voc_big, 509, 0.2),
            "deep": (voc_deep, LOOP_CFG["max_kps"], 0.1)}


def phase_check_vocab():
    """B7 against its plain version, word for word, at every case of
    vocab_cases."""
    t0 = time.perf_counter()
    cases = vocab_cases()
    log(f"vocabularies made in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{label} {voc.node_desc.shape[0]} nodes"
                    for label, (voc, _, _) in cases.items()))
    rec = {}
    for i, (label, (voc, N, p_inv)) in enumerate(cases.items()):
        desc, valid = descent_case(voc, N, 20 + i, p_inv)
        w_k = vocab_k.transform_words_kernel(voc.node_desc, desc, valid,
                                             voc.k, voc.L)
        w_p = vocab._transform_words(voc.node_desc, desc, valid, voc.k,
                                     voc.L)
        torch.cuda.synchronize()
        err = (w_k.long() - w_p.long()).abs().max().item()
        log(f"B7 bow_descent {label}: N={N}, k={voc.k}, L={voc.L}, "
            f"{int((~valid).sum())} invalid rows, "
            f"{len(torch.unique(w_p))} distinct words, max_abs_err {err}")
        if err != 0 or not torch.equal(w_k, w_p) \
                or not torch.equal(w_k < 0, ~valid):
            raise AssertionError(f"B7 disagrees with its plain version "
                                 f"({label})")
        rec[label] = dict(max_abs_err=float(err), voc=voc,
                          args=(desc, valid), words=w_p)
    return rec


def train_loop_vocabulary(ds):
    """The loop run's vocabulary: the first frames' descriptors, as
    tests/test_longrun.py:41-49 trains it."""
    v = LOOP_VOC
    descs = []
    for _ in range(v["frames"]):
        fr = ds.grab_frame()
        f = frontend.extract_features(
            torch.as_tensor(fr.image, device=DEVICE), max_kps=v["max_kps"],
            threshold=v["threshold"])
        descs.append(f.desc[f.valid].cpu().numpy().view(np.uint32))
    return vocab.train_vocabulary(np.concatenate(descs), k=v["k"], L=v["L"],
                                  seed=v["seed"], device=DEVICE)


def phase_loop():
    """KeyframeSLAM with a vocabulary over the two-lap sequence (its
    views rendered ahead, each frame finished as it is read); launch
    counters around the run; the gates
    of tests/test_longrun.py::test_kitti00_shaped_two_lap_run; then the
    kidnap and its relocalization."""
    ds = SyntheticDataset(**LOOP_SEQUENCE)
    ds.open("synth://")
    t0 = time.perf_counter()
    voc = train_loop_vocabulary(ds)
    log(f"loop vocabulary: k={voc.k}, L={voc.L}, {voc.n_words} words, "
        f"trained in {time.perf_counter() - t0:.1f} s")
    ds.open("synth://")                      # rewind
    t0 = time.perf_counter()
    ds.render_ahead(RENDER_THREADS)
    ahead_s = time.perf_counter() - t0
    n = LOOP_SEQUENCE["n_frames"]
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**LOOP_CFG), vocabulary=voc,
                        device=DEVICE)
    lc = slam.loop_closer
    ts, gt, kept, closure_s = [], [], {}, []
    track_s = prev_loop_s = 0.0
    render_s = ahead_s
    torch.cuda.synchronize()
    reset_counts()
    for i in range(n):
        t0 = time.perf_counter()
        fr = ds.grab_frame()
        t1 = time.perf_counter()
        slam.track(fr)
        track_s += time.perf_counter() - t1
        render_s += t1 - t0
        ts.append(fr.timestamp)
        gt.append(fr.gt_pose[:3])
        if KIDNAP_FRAME <= i < KIDNAP_FRAME + KIDNAP_TRIES:
            kept[i] = fr
        if len(lc.closed) > len(closure_s):
            loop_s = slam.timer.stats()["slam/loop"]["total"]
            closure_s.append(loop_s - prev_loop_s)
            prev_loop_s = loop_s
    torch.cuda.synchronize()
    launched = counts()
    log(f"loop run path launches over {n} frames: {launched} "
        f"({track_s:.2f} s in track, {render_s:.2f} s rendering)")
    missing = [k for k in LOOP_PATH if launched[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the loop path never ran: "
                             f"{missing}")
    n_kf = int(slam.arena.n_frames)
    n_pts = int(slam.arena.point_valid.sum())
    overflow = bool(slam.arena.overflow)
    ts, gt = np.asarray(ts), np.stack(gt)
    corrected = slam.corrected_positions()
    m = evaluate_trajectory(ts, corrected, ts, gt, with_scale=False)
    m_raw = evaluate_trajectory(ts, slam.positions(), ts, gt,
                                with_scale=False)
    tracked = tracked_frames(slam)
    st = slam.timer.stats()
    split = split_ms(slam, n)
    log(f"loop run: {tracked}/{n} frames tracked, {n_kf} keyframes, "
        f"{n_pts} points, overflow {overflow}, closures {lc.closed}, "
        f"verifications {len(lc.verify_log)} "
        f"({sum(v[4] for v in lc.verify_log)} accepted), global BA runs "
        f"{st.get('slam/loop_gba', {}).get('count', 0)}; ATE corrected "
        f"{m.ate_rmse:.6f} m (gate {LOOP_ATE_GATE} m), as tracked "
        f"{m_raw.ate_rmse:.6f} m, RPE {m.rpe_rmse:.6f} m")
    log(f"loop run: {track_s * 1e3 / n:.3f} ms/frame "
        f"({n / track_s:.2f} frames/s); split ms/frame: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; rest (host glue) {rest_ms(track_s * 1e3 / n, split):.3f}; "
          f"seconds per closure {[round(x, 3) for x in closure_s]}")
    if not np.isfinite(corrected).all() or corrected.shape != (n, 3):
        raise AssertionError("trajectory not finite or of the wrong shape")
    if n_kf < LOOP_MIN_KEYFRAMES or overflow or n_pts >= slam.cfg.cap_points:
        raise AssertionError(f"{n_kf} keyframes, {n_pts} points, overflow "
                             f"{overflow}")
    if len(lc.closed) < LOOP_MIN_CLOSURES:
        raise AssertionError(f"only {len(lc.closed)} loop closures")
    if not m.ate_rmse < LOOP_ATE_GATE:
        raise AssertionError(f"ATE {m.ate_rmse} m above {LOOP_ATE_GATE} m")

    # kidnap: a far-away pose and a dead motion model; a lost tracker
    # gets a stream of frames, as in
    # tests/test_loop_closure.py::TestRelocalization
    slam.pose_wc = torch.tensor([50.0, 50.0, 50.0, 1.0, 0, 0, 0],
                                device=DEVICE)
    slam.velocity = slam._identity()
    slam._lost_frames = 0
    before = vocab_k.launches
    t0 = time.perf_counter()
    for tries, (i, fr) in enumerate(sorted(kept.items()), 1):
        slam.track(fr)
        est = slam.pose_wc[:3].cpu().numpy()
        if np.linalg.norm(est) < 40.0:          # left the kidnap pose
            break
    reloc_s = time.perf_counter() - t0
    dist = float(np.linalg.norm(est - corrected[i]))
    b7_reloc = vocab_k.launches - before
    log(f"kidnap: relocalized after {tries} frame(s) in {reloc_s:.3f} s, "
        f"{dist:.3f} m from where the run placed frame {i} (tolerance "
        f"{KIDNAP_TOL_M} m), B7 launches {b7_reloc}")
    if not dist < KIDNAP_TOL_M or b7_reloc < 1:
        raise AssertionError("relocalization failed")
    return launched, dict(
        frames=n, tracked=tracked, keyframes=n_kf, points=n_pts,
        closures=[list(c) for c in lc.closed],
        verifications=len(lc.verify_log), ate_m=m.ate_rmse,
        ate_uncorrected_m=m_raw.ate_rmse, rpe_m=m.rpe_rmse,
        ms_per_frame=track_s * 1e3 / n, frames_per_s=n / track_s,
        split_ms_per_frame=split, seconds_per_closure=closure_s,
        render_s=render_s, reloc_frames=tries, reloc_s=reloc_s,
        reloc_dist_m=dist, reloc_b7_launches=b7_reloc)


def descent_work(voc, words):
    """(bytes, float operations, Hamming steps) of the descent that gave
    ``words``: descriptors and validity in, words out, and the children
    of every node the valid rows passed through, read once each; 8 steps
    (xor, popc, add) per valid row, level and child.  Invalid rows
    descend no level."""
    k, L, N = voc.k, voc.L, words.shape[0]
    w = words[words >= 0].long()
    parents = sum(len(torch.unique(w // k ** (L - l))) for l in range(L))
    return N * 37 + parents * k * 32, 0, len(w) * k * L * 8


def phase_vocab_kernel_times(rec_v, launched, n_keyframes):
    """B7's device time beside its plain version at each timed case:
    {label: kernels-line record}; "loop" is the kernels line's."""
    out = {}
    for label in VOCAB_TIMED:
        voc = rec_v[label]["voc"]
        desc, valid = rec_v[label]["args"]
        calls = {"bow_descent": (
            lambda: vocab_k.transform_words_kernel(
                voc.node_desc, desc, valid, voc.k, voc.L),
            lambda: vocab._transform_words(voc.node_desc, desc, valid,
                                           voc.k, voc.L))}
        log(f"B7 at N={desc.shape[0]}, k={voc.k}, L={voc.L} "
            f"({voc.node_desc.shape[0]} nodes):")
        out[label], = time_kernels(
            calls, {"bow_descent": descent_work(voc, rec_v[label]["words"])},
            {"bow_descent": rec_v[label]}, launched,
            {"bow_descent": f"{launched['bow_descent'] / n_keyframes:.2f} "
             "per keyframe"})
    return out


def time_pair(kfn, pfn, work):
    """Device times of a kernel and its plain version by CUDA graph
    replay, in turns (plain, kernel, kernel, plain), and the bound of
    ``work`` (the arguments of bound_ms)."""
    p1 = graph_ms(pfn)
    k1 = graph_ms(kfn)
    k2 = graph_ms(kfn)
    p2 = graph_ms(pfn)
    b_ms, b_by = bound_ms(*work)
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                bound_by=b_by), (k1, k2, p1, p2)


def time_kernels(calls, work, rec, launched, per=None):
    """Device time of each kernel and its plain version (time_pair) and
    the kernel's eager call from Python; the kernels-line records."""
    out = []
    for name, (kfn, pfn) in calls.items():
        t, (k1, k2, p1, p2) = time_pair(kfn, pfn, work[name])
        eager = cuda_ms(kfn)
        out.append(dict(name=name, route="cuda", **KERNELS[name],
                        launches=launched[name],
                        max_abs_err=rec[name]["max_abs_err"], **t,
                        library_ms=None))
        log(f"{name}: kernel {k1:.6f}/{k2:.6f} ms, plain {p1:.6f}/"
            f"{p2:.6f} ms (device, graph replay); eager call "
            f"{eager:.4f} ms; bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}; work {work[name]}); launch floor "
            f"{LAUNCH_FLOOR_MS[0]:.6f} ms; launches {launched[name]}"
            + (f" ({per[name]})" if per else ""))
    return out


def phase_extra_kernel_times(rec):
    """B5, B6, B3, B4, B1 and B2 at their extra shapes: device times
    beside the plain versions and the bounds, for the lines before the
    kernels line."""
    pairs = {}
    for label in SCHUR_EXTRA:
        entry = rec["schur_" + label]
        prob, lam = entry["args"]
        pairs["schur_" + label] = (
            entry, lambda p=prob: schur.schur_reduce_kernel(p, lam, 0.01),
            lambda p=entry["plain"]: ba.schur_reduce(p, lam, 0.01),
            schur_work(prob))
        entry = rec["ba_cost_" + label]
        pairs["ba_cost_" + label] = (
            entry, lambda p=prob: schur.ba_cost_kernel(p, 0.01),
            lambda p=entry["plain"]: ba.ba_cost(p, 0.01), cost_work(prob))
    entry = rec[f"brief_K{BRIEF_LOOP_K}"]
    pairs[f"brief_K{BRIEF_LOOP_K}"] = (
        entry, lambda: brief.brief(*entry["args"]),
        lambda: frontend.brief_from_rotation(*entry["args"]),
        brief_work(entry["args"][0], BRIEF_LOOP_K))
    entry = rec["matcher_extra"]
    pairs["matcher_N{N}_M{M}".format(**MATCHER_EXTRA)] = (
        entry, lambda: matcher.hamming_top2_kernel(*entry["args"]),
        lambda: hamming_top2(*entry["args"]), matcher_work(**MATCHER_EXTRA))
    for label in GATED_EXTRA:
        entry = rec[label]
        pairs[label] = (
            entry, lambda a=entry["args"]: matcher.gated_top2_kernel(*a),
            lambda a=entry["args"]: hamming_top2_gated(*a),
            gated_matcher_work(*entry["args"]))
    entry = rec["fast_nms_slam_frame"]
    pairs["fast_nms_slam_frame"] = (
        entry, lambda: fastnms.fast_nms_raw(*entry["args"]),
        lambda: fastnms.fast_nms_plain(*entry["args"]),
        fast_work(*entry["args"]))
    # B1 at the pyramid's level shapes, B2 at their budgets; the other
    # systems' shapes carry their own (kernel, plain, work)
    for label, entry in rec.items():
        a = entry.get("args")
        if "timing" in entry:
            pairs[label] = (entry, *entry["timing"])
        elif label.startswith("pyramid_fast_nms_"):
            pairs[label] = (entry, lambda a=a: fastnms.fast_nms_raw(*a),
                            lambda a=a: fastnms.fast_nms_plain(*a),
                            fast_work(*a))
        elif label.startswith("pyramid_brief_"):
            pairs[label] = (entry, lambda a=a: brief.brief(*a),
                            lambda a=a: frontend.brief_from_rotation(*a),
                            brief_work(a[0], entry["K"]))
    out = {}
    for label, (entry, kfn, pfn, work) in pairs.items():
        out[label], ks = time_pair(kfn, pfn, work)
        out[label]["max_abs_err"] = entry["max_abs_err"]
        if "hex" in entry:
            out[label]["float32_hex"] = entry["hex"]
        log(f"{label}: kernel {ks[0]:.6f}/{ks[1]:.6f} ms, plain "
            f"{ks[2]:.6f}/{ks[3]:.6f} ms; bound "
            f"{out[label]['bound_ms']:.6f} ms ({out[label]['bound_by']}); "
            f"launch floor {LAUNCH_FLOOR_MS[0]:.6f} ms")
    return out


# ---------------------------------------------------------------------------
# the other SLAM systems: frame-to-frame odometry, stereo, direct, SfM


def timed_run(system, frames):
    """``system.track`` over ``frames``; seconds, the card synchronized
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr in frames:
        system.track(fr)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class ReplayedTwoView:
    """A ``uniforms`` hook that replays a recorded run's two-view draws
    in order (``two_view_e`` (n, 256, 8), ``two_view_h`` (n, 256, 4) of
    an npz that ``tests/test_torch_slam.py`` writes): one pair a call,
    or with ``n`` the next ``n`` pairs as a list.  Raises when more are
    asked for than were recorded."""

    def __init__(self, path, device=None):
        device = device or DEVICE
        with np.load(path) as d:
            self.pairs = list(zip(torch.as_tensor(d["two_view_e"],
                                                  device=device),
                                  torch.as_tensor(d["two_view_h"],
                                                  device=device)))
        self.taken = 0

    def _next(self):
        if self.taken >= len(self.pairs):
            raise AssertionError(f"asked for draw {self.taken + 1}; "
                                 f"{len(self.pairs)} were recorded")
        self.taken += 1
        return self.pairs[self.taken - 1]

    def __call__(self, n=None):
        return self._next() if n is None else [self._next()
                                                for _ in range(n)]


def without_depth(frames):
    return [dataclasses.replace(fr, depth=None) for fr in frames]


def check_matcher_at(desc_a, valid_a, desc_b, valid_b, what):
    """B3 against its plain version, bit for bit (best, second, index,
    back and the match decisions), two calls the same bits; the record
    for timing."""
    top_k = matcher.hamming_top2_kernel(desc_a, valid_a, desc_b, valid_b)
    top_p = hamming_top2(desc_a, valid_a, desc_b, valid_b)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(top_k, top_p))
    m_k = matcher.match_hamming(desc_a, valid_a, desc_b, valid_b)
    m_p = match_descriptors(desc_a, valid_a, desc_b, valid_b)
    same = (torch.equal(m_k.idx, m_p.idx) and torch.equal(m_k.valid,
                                                          m_p.valid))
    log(f"B3 matcher ({what}): max_abs_err {err:.3g}, {int(m_k.count)} "
        f"matches, decisions equal {same}")
    if err != 0.0 or not same:
        raise AssertionError(f"matcher kernel disagrees ({what})")
    args = (desc_a, valid_a, desc_b, valid_b)
    assert_same_bits(lambda: matcher.hamming_top2_kernel(*args),
                     f"B3 matcher ({what})")
    return dict(max_abs_err=err, timing=(
        lambda: matcher.hamming_top2_kernel(*args),
        lambda: hamming_top2(*args),
        matcher_work(desc_a.shape[0], desc_b.shape[0])))


def run_odometry(camera, frames, use_kernels=True, draws=None):
    odom = FrameToFrameOdometry(camera, **ODOM_CFG, use_kernels=use_kernels,
                                device=DEVICE, uniforms=draws)
    return odom, timed_run(odom, frames)


def odometry_record(odom, frames, with_scale):
    m = slam_metrics(odom, frames, with_scale=with_scale)
    return dict(ate_m=m.ate_rmse, rpe_m=m.rpe_rmse,
                tracked=sum(st["n_inliers"] >= 10 for st in odom.stats),
                finite=bool(np.isfinite(odom.positions()).all()),
                inliers=[st["n_inliers"] for st in odom.stats])


ODOM_PATH = ("fast_nms", "brief", "matcher")


def phase_odometry(camera, frames, rec):
    """FrameToFrameOdometry over the 64 frames with depth, then without
    (the JAX package's draws replayed), counters around each: B1 and B2
    once a frame, B3 once a frame after the first; >= 90% of frames with
    10 inliers, the ATE gates, each run twice bit for bit; ms/frame in
    turns (kernels, plain, kernels).  B3 held against its plain version
    on frames 0 and 1's descriptors."""
    n = len(frames)
    f0, f1 = (frontend.extract_features(
        torch.as_tensor(fr.image, device=DEVICE),
        max_kps=ODOM_CFG["max_kps"], threshold=ODOM_CFG["fast_threshold"])
        for fr in frames[:2])
    entry = check_matcher_at(f0.desc, f0.valid, f1.desc, f1.valid,
                             "odometry frames 0 and 1")
    entry["launched_in"] = [("odometry", "matcher"),
                            ("odometry_mono", "matcher")]
    rec[f"matcher_odometry_N{f0.desc.shape[0]}_M{f1.desc.shape[0]}"] = entry
    out, launched = {}, {}
    for mode, fr_in, with_scale, gate, ref in (
            ("depth", frames, False, ATE_GATE_ODOM, REF_ATE_ODOM),
            ("mono", without_depth(frames), True, ATE_GATE_ODOM_MONO,
             REF_ATE_ODOM_MONO)):
        draws = ReplayedTwoView(ODOM_MONO_DRAWS) if mode == "mono" else None
        reset_counts()
        odom, secs = run_odometry(camera, fr_in, draws=draws)
        launched[mode] = counts()
        r = odometry_record(odom, fr_in, with_scale)
        again = odometry_record(run_odometry(
            camera, fr_in, draws=ReplayedTwoView(ODOM_MONO_DRAWS)
            if mode == "mono" else None)[0], fr_in, with_scale)
        log(f"odometry ({mode}) launches over {n} frames: "
            f"{launched[mode]} ({secs:.2f} s); {r['tracked']}/{n} frames "
            f"with 10 inliers, ATE{' after Sim3 alignment' if with_scale else ''}"
            f" {r['ate_m']!r} m (gate {gate:.4f} m; JAX reference "
            f"{ref:.6f} m), second run {again['ate_m']!r} m"
            + (f", {draws.taken} draws replayed" if draws else "")
            + f"; inliers {r['inliers']}")
        want = {"fast_nms": n, "brief": n, "matcher": n - 1}
        got = {k: launched[mode][k] for k in want}
        if got != want or any(launched[mode][k] for k in launched[mode]
                              if k not in want):
            raise AssertionError(f"odometry ({mode}) launches {launched[mode]}"
                                 f", want {want} and no other kernel")
        if not r["finite"] or r["tracked"] < 0.9 * n:
            raise AssertionError(f"odometry ({mode}): {r['tracked']} of {n} "
                                 "frames tracked, or a trajectory not finite")
        if not r["ate_m"] <= gate:
            raise AssertionError(f"odometry ({mode}) ATE {r['ate_m']} m above "
                                 f"{gate} m")
        if again["ate_m"] != r["ate_m"]:
            raise AssertionError(f"odometry ({mode}) second run: ATE "
                                 f"{again['ate_m']!r} m, first {r['ate_m']!r}")
        out[mode] = dict(**r, ms_per_frame=secs * 1e3 / n,
                         split_ms_per_frame=split_ms(odom, n))
    turns = {}
    for label, uk in (("kernels", True), ("plain", False),
                      ("kernels2", True)):
        odom, secs = run_odometry(camera, frames, use_kernels=uk)
        turns[label] = dict(ms_per_frame=secs * 1e3 / n,
                            split_ms_per_frame=split_ms(odom, n))
        log(f"odometry (depth) {label}: {secs * 1e3 / n:.3f} ms/frame; split "
            "ms/frame: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     turns[label]["split_ms_per_frame"]
                                     .items()))
    out["turns"] = turns
    return launched, out


def phase_stereo(rec):
    """StereoSLAM over 48 frames of KITTI 00's rectified geometry,
    counters around it: two B1 and two B2 launches a frame, B4-B6
    launched, >= 90% tracked, > 50 valid map points, the ATE gates, a
    second run bit for bit; slam/stereo beside slam/track_fused.  B1 and
    B2 held bit for bit on the first left and right images (1241
    columns, K = 512)."""
    camera, frames, render_s = render(STEREO_SEQUENCE)
    n = len(frames)
    H, W = frames[0].image.shape
    for side, image in (("left", frames[0].image),
                        ("right", frames[0].image_right)):
        fast, brf = check_frame_at(
            torch.as_tensor(image, device=DEVICE), SLAM_CFG["fast_threshold"],
            SLAM_CFG["max_kps"], f"stereo {side} frame {H}x{W}", "stereo")
        if side == "left":
            rec["fast_nms_stereo_frame"] = fast
            rec[f"brief_stereo_frame_K{SLAM_CFG['max_kps']}"] = brf

    def run():
        slam = SLAMS.create("stereo", camera, device=DEVICE, **SLAM_CFG)
        return slam, timed_run(slam, frames)

    reset_counts()
    slam, secs = run()
    launched = counts()
    m = slam_metrics(slam, frames)
    tracked = tracked_frames(slam)
    points = int(slam.arena.point_valid.sum())
    split = split_ms(slam, n)
    slam2, secs2 = run()
    ate2 = slam_metrics(slam2, frames).ate_rmse
    log(f"stereo path launches over {n} frames: {launched} ({secs:.2f} s, "
        f"{render_s:.1f} s rendering)")
    log(f"stereo SLAM {STEREO_SEQUENCE['height']}x{STEREO_SEQUENCE['width']}"
        f": {tracked}/{n} tracked, {slam._n_frames_host} keyframes, "
        f"{points} valid points, ATE {m.ate_rmse!r} m (gate "
        f"{ATE_GATE_STEREO:.4f} m; JAX reference {REF_ATE_STEREO:.6f} m), "
        f"second run {ate2!r} m; {secs * 1e3 / n:.3f} / "
        f"{secs2 * 1e3 / n:.3f} ms/frame; split ms/frame: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    missing = [k for k in SLAM_PATH if launched[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the stereo path never ran: "
                             f"{missing}")
    if launched["fast_nms"] != 2 * n or launched["brief"] != 2 * n:
        raise AssertionError(f"stereo: B1 / B2 launches {launched}, want "
                             f"{2 * n} each")
    if not np.isfinite(slam.positions()).all() or tracked < 0.9 * n \
            or points <= 50:
        raise AssertionError(f"stereo: {tracked} of {n} tracked, {points} "
                             "points, or a trajectory not finite")
    if not m.ate_rmse <= ATE_GATE_STEREO:
        raise AssertionError(f"stereo ATE {m.ate_rmse} m above "
                             f"{ATE_GATE_STEREO} m")
    if ate2 != m.ate_rmse:
        raise AssertionError(f"stereo second run: ATE {ate2!r} m, first "
                             f"{m.ate_rmse!r}")
    return launched, dict(frames=n, tracked=tracked,
                          keyframes=slam._n_frames_host, valid_points=points,
                          ate_m=m.ate_rmse, rpe_m=m.rpe_rmse,
                          ms_per_frame_runs=[secs * 1e3 / n,
                                             secs2 * 1e3 / n],
                          split_ms_per_frame=split, render_s=render_s)


def direct_cell(camera, frames, ref, gate, what):
    """DirectOdometry (defaults) over ``frames``, counters around it (no
    kernel of B1-B7 on this path): >= 90% of frames with a valid
    fraction of at least min_valid_frac, the ATE gate, a second run bit
    for bit; (launches, record, the first run's system)."""
    n = len(frames)
    reset_counts()
    slam = DirectOdometry(camera, DirectConfig(), device=DEVICE)
    secs = timed_run(slam, frames)
    launched = counts()
    m = slam_metrics(slam, frames)
    c = slam.cfg
    valid = sum(st["n_inliers"] >= c.min_valid_frac * c.n_points
                for st in slam.stats)
    slam2 = DirectOdometry(camera, DirectConfig(), device=DEVICE)
    secs2 = timed_run(slam2, frames)
    ate2 = slam_metrics(slam2, frames).ate_rmse
    split = split_ms(slam, n)
    log(f"direct ({what}) path launches over {n} frames: {launched} "
        f"({secs:.2f} s)")
    log(f"direct odometry ({what}): {valid}/{n} frames with valid fraction "
        f">= {c.min_valid_frac}, ATE {m.ate_rmse!r} m (gate {gate:.4f} m; "
        f"JAX reference {ref:.6f} m), RPE {m.rpe_rmse:.6f} m, second run "
        f"{ate2!r} m; {secs * 1e3 / n:.3f} / {secs2 * 1e3 / n:.3f} ms/frame;"
        " split ms/frame: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    if any(launched.values()):
        raise AssertionError(f"direct odometry ({what}) launched {launched}")
    if not np.isfinite(slam.positions()).all() or valid < 0.9 * n:
        raise AssertionError(f"direct ({what}): {valid} of {n} frames valid, "
                             "or a trajectory not finite")
    if not m.ate_rmse <= gate:
        raise AssertionError(f"direct ({what}) ATE {m.ate_rmse} m above "
                             f"{gate} m")
    if ate2 != m.ate_rmse:
        raise AssertionError(f"direct ({what}) second run: ATE {ate2!r} m, "
                             f"first {m.ate_rmse!r}")
    return launched, dict(frames=n, valid_frames=valid, ate_m=m.ate_rmse,
                          rpe_m=m.rpe_rmse,
                          ms_per_frame_runs=[secs * 1e3 / n,
                                             secs2 * 1e3 / n],
                          split_ms_per_frame=split)


def phase_direct(camera, frames):
    """DirectOdometry over the 64 frames of the KeyframeSLAM cell and
    over 64 frames of the line motion (direct_cell's gates each); the
    device busy share and device operations a frame over 8 warm frames
    of the line run."""
    launched, ring = direct_cell(camera, frames, REF_ATE_DIRECT,
                                 ATE_GATE_DIRECT, "ring_out")
    camera_l, frames_l, render_s = render(DIRECT_LINE_SEQUENCE)
    launched_l, line = direct_cell(camera_l, frames_l, REF_ATE_DIRECT_LINE,
                                   ATE_GATE_DIRECT_LINE, "line")
    line["render_s"] = render_s
    n_prof = min(8, len(frames_l) - 8)
    warm = DirectOdometry(camera_l, DirectConfig(), device=DEVICE)
    timed_run(warm, frames_l[:8])
    it = iter(frames_l[8:8 + n_prof])
    line["profile"] = device_profile(lambda: warm.track(next(it)), n_prof,
                                     "DirectOdometry (line)")
    return launched, dict(ring_out=ring, line=dict(**line,
                                                   launches=launched_l))


SFM_PATH = ("fast_nms", "brief", "matcher", "schur", "ba_cost")


def run_sfm(camera, frames, kw, draws, use_kernels=True):
    """GlobalSfM over ``frames`` and its ``finalize``; (sfm, result,
    seconds)."""
    sfm = GlobalSfM(camera, **kw, use_kernels=use_kernels, device=DEVICE,
                    uniforms=draws)
    secs = timed_run(sfm, frames)
    t0 = time.perf_counter()
    res = sfm.finalize()
    torch.cuda.synchronize()
    return sfm, res, secs + time.perf_counter() - t0


def sfm_cell(sequence, kw, ref, gate, tag, rec):
    """GlobalSfM over the first SFM_FRAMES frames of ``sequence`` with
    the JAX package's pair draws replayed, counters around it: B3 once a
    pair, B1 / B2 once a frame, B5 ba_iters times and B6 ba_iters + 1
    times in each of the three global BA rounds (bundle_adjust runs a
    fixed count, so the totals 3 ba_iters and 3 (ba_iters + 1) with
    four costs mean every round ran both); >= 9 edges, the ATE after
    Sim3 alignment within ``gate`` (None: printed beside the JAX
    reference, not gated), a second run bit for bit; seconds per sfm/*
    section; then, printed, the plain path on the same draws and the
    system's own draws.  B1, B2 held bit for bit on the first frame, B3
    on the pair of frames 0 and 1, B5 / B6 on the global BA's problem."""
    camera, frames, render_s = render(sequence)
    frames = frames[:SFM_FRAMES]
    n, iters = len(frames), kw["ba_iters"]
    n_pairs = n * (n - 1) // 2
    img = torch.as_tensor(frames[0].image, device=DEVICE)
    thr, K = kw["fast_threshold"], kw["max_kps"]
    H, W = img.shape
    rec[f"fast_nms_{tag}_frame"], rec[f"brief_{tag}_frame_K{K}"] = \
        check_frame_at(img, thr, K, f"{tag} frame {H}x{W}", tag)
    f0, f1 = (frontend.extract_features(
        torch.as_tensor(fr.image, device=DEVICE), max_kps=K, threshold=thr)
        for fr in frames[:2])
    entry = check_matcher_at(f0.desc, f0.valid, f1.desc, f1.valid,
                             f"{tag} pair 0-1")
    entry["launched_in"] = [(tag, "matcher")]
    rec[f"matcher_{tag}_N{f0.desc.shape[0]}_M{f1.desc.shape[0]}"] = entry
    reset_counts()
    sfm, res, secs = run_sfm(camera, frames, kw, ReplayedTwoView(SFM_DRAWS))
    launched = counts()
    m = slam_metrics(sfm, frames, with_scale=True)
    sections = {k: v["total"] for k, v in sfm.timer.stats().items()}
    m2 = slam_metrics(run_sfm(camera, frames, kw,
                              ReplayedTwoView(SFM_DRAWS))[0],
                      frames, with_scale=True)
    plain = slam_metrics(run_sfm(camera, frames, kw,
                                 ReplayedTwoView(SFM_DRAWS),
                                 use_kernels=False)[0],
                         frames, with_scale=True)
    own, res_own, _ = run_sfm(camera, frames, kw, None)
    m_own = slam_metrics(own, frames, with_scale=True)
    gt = np.stack([fr.gt_pose[:3] for fr in frames])
    spread = float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean()))
    prob = sfm.ba_problem
    log(f"{tag} path launches over {n} frames, {n_pairs} pairs: {launched} "
        f"({secs:.2f} s, {render_s:.1f} s rendering)")
    log(f"{tag} {H}x{W}: {res['n_edges']} edges, {prob.point_xyz.shape[0]} "
        f"tracks of up to {prob.obs_cam.shape[1]} observations "
        f"({int(prob.obs_valid.sum())} valid), BA costs {sfm.ba_costs}, "
        f"ATE after Sim3 alignment {m.ate_rmse!r} m (gate "
        + (f"{gate:.4f} m" if gate is not None else "none")
        + f"; JAX reference {ref:.6f} m; a constant trajectory "
        f"{spread:.6f} m), second run {m2.ate_rmse!r} m; the plain path on "
        f"the same draws (not gated): ATE {plain.ate_rmse!r} m; the "
        f"system's own draws (not gated): {res_own['n_edges']} edges, ATE "
        f"{m_own.ate_rmse!r} m; seconds per section: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sections.items()))
    missing = [k for k in SFM_PATH if launched[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the {tag} path never ran: "
                             f"{missing}")
    want = {"fast_nms": n, "brief": n, "matcher": n_pairs,
            "schur": 3 * iters, "ba_cost": 3 * (iters + 1)}
    if any(launched[k] != v for k, v in want.items()) \
            or len(sfm.ba_costs) != 4:
        raise AssertionError(f"{tag} launches {launched}, want {want}; BA "
                             f"costs {sfm.ba_costs}, want four")
    if res["n_edges"] < n - 1 or not np.isfinite(res["centers"]).all():
        raise AssertionError(f"{tag}: {res['n_edges']} edges")
    if gate is not None and not m.ate_rmse <= gate:
        raise AssertionError(f"{tag} ATE {m.ate_rmse} m above {gate} m")
    if m2.ate_rmse != m.ate_rmse:
        raise AssertionError(f"{tag} second run: ATE {m2.ate_rmse!r} m, "
                             f"first {m.ate_rmse!r}")
    # B5 / B6 at the global BA's shape
    lam = torch.tensor(1e-4, device=DEVICE)
    label = (f"C{prob.cam_pose.shape[0]}_P{prob.point_xyz.shape[0]}"
             f"_O{prob.obs_cam.shape[1]}")
    e = assert_schur_close(schur.schur_reduce_kernel(prob, lam, 0.01),
                           ba.schur_reduce(prob, lam, 0.01), prob,
                           f"{tag} {label}")
    log(f"B5 schur vs plain ({tag} {label}): max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    assert_same_bits(lambda: schur.schur_reduce_kernel(prob, lam, 0.01),
                     f"B5 schur ({tag} {label})")
    rec[f"schur_{tag}_{label}"] = dict(
        max_abs_err=max(e.values()), launched_in=[(tag, "schur")], timing=(
            lambda: schur.schur_reduce_kernel(prob, lam, 0.01),
            lambda: ba.schur_reduce(prob, lam, 0.01), schur_work(prob)))
    cost = check_cost(prob, prob, tuple(x.cpu().numpy() for x in prob),
                      f"{tag} {label}")
    cost["timing"] = (lambda: schur.ba_cost_kernel(prob, 0.01),
                      lambda: ba.ba_cost(prob, 0.01), cost_work(prob))
    cost["launched_in"] = [(tag, "ba_cost")]
    rec[f"ba_cost_{tag}_{label}"] = cost
    return launched, dict(
        shape=[H, W], frames=n, pairs=n_pairs, edges=res["n_edges"],
        tracks=int(prob.point_xyz.shape[0]),
        valid_obs=int(prob.obs_valid.sum()), ba_costs=sfm.ba_costs,
        ate_m=m.ate_rmse, rpe_m=m.rpe_rmse, ate_gate_m=gate,
        ref_ate_m=ref, constant_trajectory_ate_m=spread,
        plain_ate_m=plain.ate_rmse, seconds=secs, section_s=sections,
        render_s=render_s,
        own_draws=dict(edges=res_own["n_edges"], ate_m=m_own.ate_rmse))


def phase_sfm(rec):
    """The SfM cell at tests/test_sfm.py's 256 x 192 (ATE gated) and the
    same frames at 640 x 480 (ATE printed, not gated: the JAX package's
    own run there is lost, and 2 ref + 0.01 lies above a constant
    trajectory's ATE); sfm_cell's other gates on both."""
    launched, small = sfm_cell(SFM_SEQUENCE, SFM_KW, REF_ATE_SFM,
                               ATE_GATE_SFM, "sfm", rec)
    launched_w, wide = sfm_cell(SFM_WIDE_SEQUENCE, SFM_WIDE_KW,
                                REF_ATE_SFM_WIDE, None, "sfm_wide", rec)
    return {"sfm": launched, "sfm_wide": launched_w}, dict(small=small,
                                                           wide=wide)


# ---------------------------------------------------------------------------
# the fleet: two sequences merged, distributed global BA, sharded tracking


def fleet_rank(rank, world, job):
    """One rank of a fleet world (``launch.spawn``): the jobs named in
    ``job``, on ``job["device"]``, each with the launch counters set to
    0 just before it and read just after.  ``gba``: global BA over the
    merged map through the psum variant on a (world, 1) mesh; ``ring``:
    the ring variant with the kernels on the global problem, twice;
    ``track``: ``sharded_track_batch`` over a 'dp' mesh."""
    entered = time.time()        # the rank has started and joined its group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job["device"])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    out = {}
    if "gba" in job:
        g = job["gba"]
        arena = arena_from_numpy(g["arena"], device=dev)
        reset_counts()
        t0 = time.perf_counter()
        res, costs = ba.global_bundle_adjust(
            arena, g["camera"], max_cams=g["n"],
            mesh=make_mesh((world, 1), device=dev), **g["kw"])
        sync()
        out["gba"] = dict(frame_pose=res.frame_pose[:g["n"]],
                          point_xyz=res.point_xyz, point_valid=res.point_valid,
                          costs=costs, seconds=time.perf_counter() - t0,
                          launches=counts())
    if "ring" in job:
        r = job["ring"]
        prob = ba.BundleProblem(*(torch.as_tensor(x, device=dev)
                                  for x in r["fields"]))
        mesh = make_mesh((world, 1), device=dev)
        out["ring"] = []
        for _ in range(2):
            reset_counts()
            dist_ba.ring_hops = 0
            sync()
            t0 = time.perf_counter()
            res, costs = distributed_bundle_adjust_ring(
                prob, mesh, iters=r["iters"], use_kernels=True)
            sync()
            out["ring"].append(dict(
                cam_pose=res.cam_pose, point_xyz=res.point_xyz, costs=costs,
                seconds=time.perf_counter() - t0, launches=counts(),
                hops=dist_ba.ring_hops))
    if "track" in job:
        t = job["track"]
        args = [torch.as_tensor(x, device=dev) for x in t["args"]]
        reset_counts()
        poses, n_inl, n_feat = sharded_track_batch(
            make_dp_mesh(device=dev), *args, **t["kw"])
        sync()
        out["track"] = dict(poses=poses, n_inliers=n_inl, n_features=n_feat,
                            launches=counts())
    out["clock"] = (entered, time.time())
    return out


def fleet_problem(arena, camera, n_a, n):
    """The merged map's global problem, as global_bundle_adjust's first
    solve builds it: every keyframe, the 4096 landmarks with the most
    observations, 16 slots a point; each sequence's first keyframe
    fixed (each holds its own gauge)."""
    dev = arena.device
    order = ba.landmark_order(arena)[:FLEET_GBA["max_points"]]
    fixed = torch.zeros(n, dtype=torch.bool, device=dev)
    fixed[[0, n_a]] = True
    prob, _ = ba.build_problem_from_arena(
        arena, torch.arange(n, dtype=torch.int32, device=dev),
        torch.as_tensor(order.astype(np.int32), device=dev), fixed, camera,
        max_obs_per_point=FLEET_GBA["max_obs_per_point"])
    return prob


def check_partials(rec, shard):
    """B5's partials entry against its plain version on ba_case's
    problems at C = 4, 8, 32 and on a ring shard with pad cameras (C =
    29 padded to 32, dist_ba.ring_shard), each twice for the same bits;
    assembled, gslam_schur's S and b bit for bit; the partials of the
    problem's four ring shards, summed, within tests/test_pallas.py's
    tolerances of them.  Also on ``shard``, the fleet ring's problem at
    world 4.  Records for the kernels line and the extra shapes."""
    lam = torch.tensor(1e-3, device=DEVICE)
    errs_all = {}
    for C, P in ((4, 384), (8, 1024), (32, 1024), (29, 1024)):
        prob = to_problem(ba_case(C, P, 8, seed=2, window=6), DEVICE)
        label = f"C{C}_P{P}_O8"
        if C % 4:
            # rank 1 of a ring of 4: 3 fixed identity cameras appended,
            # 256 of the points
            prob = dist_ba.ring_shard(prob, 4, 1)
            label = f"C{C}+{prob.cam_pose.shape[0] - C}pads_P256_O8"
        out_k = schur.schur_partials_kernel(prob, lam, 0.01)
        e = assert_partials_close(out_k, schur.schur_partials_plain(
            prob, lam, 0.01), prob, label)
        assert_same_bits(lambda: schur.schur_partials_kernel(prob, lam, 0.01),
                         f"B5 partials ({label})")
        S, b = schur.schur_reduce_kernel(prob, lam, 0.01)[:2]
        S1, b1 = assemble_partials(out_k, lam, prob.cam_fixed)
        if not (torch.equal(S1, S) and torch.equal(b1, b)):
            raise AssertionError(f"B5 partials ({label}), assembled: not "
                                 "gslam_schur's S and b bit for bit")
        parts = [schur.schur_partials_kernel(dist_ba.ring_shard(prob, 4, r),
                                             lam, 0.01) for r in range(4)]
        S4, b4 = assemble_partials([sum(p[i] for p in parts)
                                    for i in range(3)], lam, prob.cam_fixed)
        torch.testing.assert_close(S4, S, rtol=1e-4,
                                   atol=1e-4 * S.abs().max().item())
        torch.testing.assert_close(b4, b, rtol=0, atol=1e-4 * max(
            b.abs().max().item(), 1e-6))
        e["four_blocks_S"] = (S4 - S).abs().max().item()
        log(f"B5 partials vs plain ({label}): max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in e.items())
            + "; assembled = gslam_schur bit for bit")
        errs_all[label] = e
        rec["schur_partials_" + label] = dict(
            max_abs_err=max(e.values()),
            launched_in=[("fleet", "schur_partials")], timing=(
                lambda p=prob: schur.schur_partials_kernel(p, lam, 0.01),
                lambda p=prob: schur.schur_partials_plain(p, lam, 0.01),
                schur_work(prob)))
    # the fleet ring's shard: its kernels-line entry, and gslam_schur on it
    e = assert_partials_close(
        schur.schur_partials_kernel(shard, lam, 0.01),
        schur.schur_partials_plain(shard, lam, 0.01), shard, "fleet shard")
    rec["schur_partials"] = dict(max_abs_err=max(e.values()),
                                 args=(shard, lam))
    rec["schur_fleet_shard"] = dict(
        max_abs_err=0.0, launched_in=[("fleet", "schur")], timing=(
            lambda: schur.schur_reduce_kernel(shard, lam, 0.01),
            lambda: ba.schur_reduce(shard, lam, 0.01), schur_work(shard)))
    return errs_all


def phase_fleet(rec):
    """Two sequences tracked, merged and bundle-adjusted across ranks
    (module docstring, phase 17); launch counters around each run."""
    t0 = time.perf_counter()
    seqs = []
    for seed in FLEET_SEEDS:
        ds = SyntheticDataset(**dict(SEQUENCE, seed=seed))
        ds.open("synth://")
        ds.render_ahead(RENDER_THREADS, SLAM_FRAMES)
        seqs.append((ds.camera, [ds.grab_frame() for _ in range(SLAM_FRAMES)]))
    render_s = time.perf_counter() - t0
    camera = seqs[0][0]
    reset_counts()
    slams = [run_slam(cam, frames)[0] for cam, frames in seqs]
    launched = counts()
    ates = [slam_metrics(s, fr).ate_rmse for s, (_, fr) in zip(slams, seqs)]
    n_a, n_b = (s._n_frames_host for s in slams)
    n = n_a + n_b
    merged = merge_arenas(slams[0].arena, slams[1].arena,
                          transform_b=torch.tensor(FLEET_ALIGN,
                                                   device=DEVICE))
    log(f"fleet: sequences of seeds {FLEET_SEEDS}, {n_a} + {n_b} keyframes, "
        f"ATE {ates[0]!r} / {ates[1]!r} m; merged "
        f"{ta_stats(merged)} ({render_s:.1f} s rendering)")
    if not 3 <= n <= ba.MAX_CAMS:
        raise AssertionError(f"fleet: {n} keyframes (3 to {ba.MAX_CAMS})")
    t1 = time.perf_counter()
    plain, plain_costs = ba.global_bundle_adjust(
        merged, camera, max_cams=n, use_kernels=False, **FLEET_GBA)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    prob = fleet_problem(merged, camera, n_a, n)
    single, st = ba.bundle_adjust(prob, iters=FLEET_RING_ITERS,
                                  use_kernels=True)
    img, cam, xyz, desc, valid, _ = example_inputs(H, W, M, K, device=DEVICE)
    images = torch.stack([img + 1e-4 * i for i in range(FLEET_TRACK_B)])
    uniforms = torch.rand((FLEET_TRACK_B, B, 4),
                          generator=torch.Generator().manual_seed(0))
    per_frame = [track_forward(images[i], cam, xyz, desc, valid,
                               uniforms=uniforms[i], max_kps=K, ransac_b=B,
                               device=DEVICE)
                 for i in range(FLEET_TRACK_B)]
    errs = check_partials(rec, dist_ba.ring_shard(prob, 4, 0))
    ring_job = dict(fields=tuple(x.cpu().numpy() for x in prob),
                    iters=FLEET_RING_ITERS)
    # the camera without its cache of device copies: a job carries no
    # CUDA tensor (the ranks make their own)
    host_camera = Camera(camera.model, camera.width, camera.height,
                         camera.params)
    jobs = {1: dict(gba=dict(arena=arena_to_numpy(merged),
                             camera=host_camera, n=n, kw=FLEET_GBA),
                    ring=ring_job,
                    track=dict(args=[x.cpu().numpy() for x in (
                        images, cam, xyz, desc, valid, uniforms)],
                        kw=dict(max_kps=K, ransac_b=B)))}
    worlds, spawn_s = {}, {}
    for world in FLEET_WORLDS:
        # a world of one on the card's own backend (NCCL); more ranks on
        # one card share it through gloo (NCCL takes one rank a card)
        t1 = time.time()
        worlds[world] = launch.spawn(
            fleet_rank, world, device=DEVICE,
            backend=launch.default_backend(DEVICE) if world == 1 else "gloo",
            args=(dict(jobs.get(world, dict(ring=ring_job)),
                       device=DEVICE),), timeout_s=300.0)
        # wall seconds: until the last rank had joined its group, its
        # jobs, and from the last rank's end to every process joined
        t2 = time.time()
        joined, done = (max(r["clock"][k] for r in worlds[world])
                        for k in (0, 1))
        spawn_s[world] = dict(total=t2 - t1, start=joined - t1,
                              jobs=done - joined, end=t2 - done)

    # psum variant, world of one, against the plain path on the same map
    g = worlds[1][0]["gba"]
    for name, got, want in (("costs", g["costs"], plain_costs.cpu()),
                            ("poses", g["frame_pose"],
                             plain.frame_pose[:n].cpu())):
        if name == "costs":
            torch.testing.assert_close(got, want, rtol=0.05, atol=1e-8)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    same_as_plain = bool(torch.equal(g["costs"], plain_costs.cpu())
                         and torch.equal(g["frame_pose"],
                                         plain.frame_pose[:n].cpu()))
    centres = se3_inverse(g["frame_pose"][:, :7])[:, :3].numpy()
    times = merged.frame_time[:n].cpu().numpy()

    def gt(frames):
        return (np.asarray([fr.timestamp for fr in frames]),
                np.stack([fr.gt_pose[:3] for fr in frames]))

    ate = fleet_ate(centres, times, n_a, gt(seqs[0][1]), gt(seqs[1][1]))
    px = g["point_xyz"][g["point_valid"]].numpy()
    log(f"fleet global BA, psum variant, world 1 "
        f"({launch.default_backend(DEVICE)}): costs "
        f"{g['costs'].tolist()}, {g['seconds']:.2f} s; plain path "
        f"{plain_costs.tolist()}, {plain_s:.2f} s; bit for bit the plain "
        f"path: {same_as_plain}; keyframe ATE {ate!r} m (gate "
        f"{ATE_GATE_FLEET:.4f} m, JAX reference {REF_ATE_FLEET:.6f} m); "
        f"centres x: a within {np.abs(centres[:n_a, 0]).max():.3f}, b from "
        f"{centres[n_a:, 0].min():.3f}; points x up to {px[:, 0].max():.3f}")
    if not ate <= ATE_GATE_FLEET:
        raise AssertionError(f"fleet keyframe ATE {ate} m above "
                             f"{ATE_GATE_FLEET} m")
    if not (np.abs(centres[:n_a, 0]).max() < 25.0
            and centres[n_a:, 0].min() > 25.0 and px[:, 0].max() > 25.0):
        raise AssertionError("fleet: a sequence left its neighbourhood")

    # the ring with the kernels, worlds 1, 2, 4, against bundle_adjust
    ring = {}
    for world, res in worlds.items():
        runs = res[0]["ring"]
        for r in res[1:]:
            if not all(torch.equal(x[k], y[k]) for x, y in zip(runs, r["ring"])
                       for k in ("cam_pose", "point_xyz", "costs")):
                raise AssertionError(f"ring world {world}: ranks differ")
        first, again = runs
        if not all(torch.equal(first[k], again[k])
                   for k in ("cam_pose", "point_xyz", "costs")):
            raise AssertionError(f"ring world {world}: two runs differ")
        torch.testing.assert_close(first["cam_pose"], single.cam_pose.cpu(),
                                   rtol=0, atol=1e-3)
        torch.testing.assert_close(first["costs"], st.cost.cpu(), rtol=0.05,
                                   atol=1e-8)
        lau = {k: sum(r["ring"][0]["launches"][k] for r in res)
               for k in KERNELS}
        if any(lau[k] < 1 for k in FLEET_RING_PATH):
            raise AssertionError(f"ring world {world}: launches {lau}")
        ring[world] = dict(
            pose_gap=(first["cam_pose"] - single.cam_pose.cpu()).abs().max()
            .item(),
            cost_gap_rel=((first["costs"] - st.cost.cpu()).abs()
                          / st.cost.cpu().abs().clamp_min(1e-30)).max().item(),
            same_bits_as_single=bool(torch.equal(first["cam_pose"],
                                                 single.cam_pose.cpu())),
            costs=first["costs"].tolist(),
            seconds=[x["seconds"] for x in runs],
            hops=first["hops"], launches=lau, spawn_s=spawn_s[world])
        log(f"fleet ring world {world} "
            f"({launch.default_backend(DEVICE) if world == 1 else 'gloo'}): "
            f"pose gap {ring[world]['pose_gap']:.3g}, cost gap (relative) "
            f"{ring[world]['cost_gap_rel']:.3g} to bundle_adjust with the "
            f"kernels (bit for bit: {ring[world]['same_bits_as_single']}); "
            f"two runs bit for bit; {first['hops']} hops a rank; B5 partials "
            f"{lau['schur_partials']}, B6 {lau['ba_cost']} launches; "
            f"{runs[0]['seconds']:.2f} / {runs[1]['seconds']:.2f} s; spawn "
            + ", ".join(f"{k} {v:.1f}" for k, v in spawn_s[world].items())
            + " s")

    # sharded tracking, world of one: bit for bit the per-frame step
    tr = worlds[1][0]["track"]
    for i, (T, n_inl, n_feat) in enumerate(per_frame):
        if not (torch.equal(tr["poses"][i], T.cpu())
                and int(tr["n_inliers"][i]) == int(n_inl)
                and int(tr["n_features"][i]) == int(n_feat)):
            raise AssertionError(f"sharded_track_batch frame {i} differs "
                                 "from track_forward")
    log(f"sharded_track_batch B={FLEET_TRACK_B} {H}x{W}: bit for bit the "
        f"{FLEET_TRACK_B} track_forward calls; inliers "
        f"{tr['n_inliers'].tolist()}; launches {tr['launches']}")

    for part in (worlds[1][0]["gba"]["launches"], tr["launches"],
                 *(r["ring"][0]["launches"] for res in worlds.values()
                   for r in res)):
        for k in launched:
            launched[k] += part[k]
    missing = [k for k in FLEET_PATH if launched[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the fleet path never ran: "
                             f"{missing}")
    return launched, dict(
        keyframes=[n_a, n_b], sequence_ate_m=ates, keyframe_ate_m=ate,
        ate_gate_m=ATE_GATE_FLEET, ref_ate_m=REF_ATE_FLEET,
        gba_costs=g["costs"].tolist(), gba_s=g["seconds"],
        plain_gba_costs=plain_costs.tolist(), plain_gba_s=plain_s,
        psum_same_bits_as_plain=same_as_plain,
        problem=dict(C=n, P=int(prob.point_xyz.shape[0]),
                     O=int(prob.obs_cam.shape[1])),
        ring=ring, partials_errors=errs, render_s=render_s,
        track=dict(inliers=tr["n_inliers"].tolist(),
                   launches=tr["launches"]))


def ta_stats(arena):
    st = arena_stats(arena)
    return {k: st[k] for k in ("n_frames", "valid_points", "valid_obs")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    def phase(name, t0):
        log(f"[phase {name}: {time.perf_counter() - t0:.1f} s]")
        return time.perf_counter()

    t = time.perf_counter()
    phase_build()
    t = phase("build", t)
    probe = phase_probe()
    t = phase("probe", t)
    inputs = example_inputs(H, W, M, K, device=DEVICE)
    torch.cuda.synchronize()
    rec = phase_check(inputs)
    launched_track, main_out = phase_main_path(inputs)
    ms_k = time_frame(inputs, use_kernels=True, reps=20)
    ms_p = time_frame(inputs, use_kernels=False, reps=20)
    ms_k2 = time_frame(inputs, use_kernels=True, reps=20)
    log(f"track_forward {H}x{W} M={M} K={K} B={B}: kernels "
        f"{ms_k:.3f}/{ms_k2:.3f} ms/frame "
        f"({1e3 / min(ms_k, ms_k2):.1f} frames/s), plain path "
        f"{ms_p:.3f} ms/frame")
    stages = phase_stages(inputs)
    log("stages (device ms): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in stages.items()))
    prof = phase_profile(inputs)
    t = phase("track_forward", t)

    rec.update(phase_check_slam_kernels())
    t = phase("check B4-B6", t)
    camera, frames = load_frames()
    rec.update(phase_check_fast_frame(frames[0]))
    launched_slam, slam_checks = phase_slam(camera, frames[:SLAM_FRAMES])
    t = phase("KeyframeSLAM main path", t)
    slam_times = phase_slam_timing(camera, frames[:SLAM_FRAMES],
                                   slam_checks["ate_m"])
    t = phase("KeyframeSLAM timing", t)
    rec.update(phase_check_pyramid(frames[0]))
    launched_pyr, pyr_checks = phase_pyramid(camera, frames[:SLAM_FRAMES])
    t = phase("pyramid main path", t)
    launched_batch, batch_checks = phase_batched(camera, frames)
    t = phase("track_batch main path", t)
    batch_checks["graph_vs_eager"] = phase_graph_vs_eager(camera, frames)
    batch_times = phase_batch_timing(camera, frames)
    t = phase("track_batch timing", t)
    launched_odom, odom_checks = phase_odometry(camera, frames[:SLAM_FRAMES],
                                                rec)
    t = phase("odometry main path", t)
    launched_direct, direct_checks = phase_direct(camera,
                                                  frames[:SLAM_FRAMES])
    t = phase("direct main path", t)
    launched_mono, mono_checks = phase_mono()
    t = phase("mono main path", t)
    launched_vi, vi_checks = phase_vi()
    t = phase("visual-inertial main path", t)
    lens = phase_lens()
    t = phase("lens models", t)
    camera_d, frames_d, render_s = render(DISTORTED_SEQUENCE)
    launched_dist, launched_dist_b, dist_checks = phase_distorted(camera_d,
                                                                  frames_d)
    dist_checks["render_s"] = render_s
    del frames_d
    t = phase("distorted main path", t)
    with tempfile.TemporaryDirectory() as tmp:
        launched_tum, tum_checks, tum_run = phase_tum_disk(tmp)
        t = phase("TUM RGB-D from disk", t)
        launched_app, launched_app_voc, app_checks = phase_app(
            tum_run, main_out, frames)
        del tum_run, frames
    t = phase("app layer", t)
    launched_stereo, stereo_checks = phase_stereo(rec)
    t = phase("stereo main path", t)
    launched_sfm, sfm_checks = phase_sfm(rec)
    t = phase("SfM main path", t)
    launched_fleet, fleet_checks = phase_fleet(rec)
    t = phase("fleet main path", t)
    rec_v = phase_check_vocab()
    t = phase("check B7", t)
    launched_loop, loop_run = phase_loop()
    t = phase("loop closure main path", t)

    # B1, B2, B4-B6 report their launches on the 64-frame SLAM path, B3
    # on track_forward, B7 on the loop run, B5's partials entry on the
    # fleet path
    launched = {k: (launched_track[k] if k == "matcher"
                    else launched_loop[k] if k == "bow_descent"
                    else launched_fleet[k] if k == "schur_partials"
                    else launched_slam[k]) for k in KERNELS}
    kern = phase_kernel_times(rec, launched)
    kern += phase_slam_kernel_times(rec, launched, SLAM_FRAMES,
                                    slam_checks["local_ba_runs"])
    b7 = phase_vocab_kernel_times(rec_v, launched, loop_run["keyframes"])
    kern.append(b7["loop"])
    kern += phase_partials_kernel_time(rec, launched)
    # launches of each kernel on each phase's main path (the kernels
    # line's ``launches`` keep the phases named above)
    by_phase = {"track_forward": launched_track, "keyframe": launched_slam,
                "pyramid": launched_pyr, "batched": launched_batch,
                "mono": launched_mono, "vi": launched_vi,
                "distorted": launched_dist, "tum_disk": launched_tum,
                "loop": launched_loop, "odometry": launched_odom["depth"],
                "odometry_mono": launched_odom["mono"],
                "stereo": launched_stereo, "direct": launched_direct,
                **launched_sfm, "fleet": launched_fleet,
                "app": launched_app, "app_vocabulary": launched_app_voc}
    for k in kern:
        k["launches_by_phase"] = {ph: lau[k["name"]]
                                  for ph, lau in by_phase.items()}
    extra = phase_extra_kernel_times(rec)
    for label, r in extra.items():
        for ph, name in rec.get(label, {}).get("launched_in", ()):
            r.setdefault("launches", {})[ph] = by_phase[ph][name]
    t = phase("kernel times", t)
    log(json.dumps({"probe": probe, "kernels_at_extra_shapes": extra}))
    log(json.dumps({"slice": "track_forward", "shape": [H, W],
                    "map": M, "kps": K, "ransac_b": B,
                    "ms_per_frame": min(ms_k, ms_k2),
                    "frames_per_s": 1e3 / min(ms_k, ms_k2),
                    "plain_ms_per_frame": ms_p, "stages_ms": stages,
                    "profile": prof, "launches": launched_track}))
    log(json.dumps({"slice": "keyframe_slam", "frames": SLAM_FRAMES,
                    "shape": [SEQUENCE["height"], SEQUENCE["width"]],
                    **slam_checks, **slam_times,
                    "launches": launched_slam}))
    log(json.dumps({"slice": "keyframe_slam_batched",
                    "shape": [SEQUENCE["height"], SEQUENCE["width"]],
                    **batch_checks, **batch_times,
                    "launches": launched_batch,
                    "launches_per_frame": {
                        k: v / batch_checks["frames"]
                        for k, v in launched_batch.items()}}))
    log(json.dumps({"slice": "keyframe_slam_mono",
                    "shape": [MONO_SEQUENCE["height"],
                              MONO_SEQUENCE["width"]],
                    **mono_checks, "launches": launched_mono}))
    log(json.dumps({"slice": "keyframe_slam_pyramid",
                    "shape": [SEQUENCE["height"], SEQUENCE["width"]],
                    "levels": PYRAMID_CFG["n_levels"],
                    "scale": PYRAMID_CFG["pyramid_scale"], **pyr_checks,
                    "launches": launched_pyr}))
    log(json.dumps({"slice": "keyframe_slam_vi",
                    "shape": [VI_SEQUENCE["height"], VI_SEQUENCE["width"]],
                    **vi_checks, "launches": launched_vi}))
    log(json.dumps({"slice": "lens", **lens}))
    log(json.dumps({"slice": "keyframe_slam_distorted",
                    "shape": [DISTORTED_SEQUENCE["height"],
                              DISTORTED_SEQUENCE["width"]],
                    **dist_checks, "launches": launched_dist,
                    "launches_batched": launched_dist_b}))
    log(json.dumps({"slice": "keyframe_slam_tum_disk",
                    "shape": [TUM_SEQUENCE["height"], TUM_SEQUENCE["width"]],
                    **tum_checks, "launches": launched_tum}))
    log(json.dumps({"slice": "app",
                    "shape": [TUM_SEQUENCE["height"], TUM_SEQUENCE["width"]],
                    "frames": TUM_SEQUENCE["n_frames"], **app_checks,
                    "launches": launched_app,
                    "launches_vocabulary": launched_app_voc}))
    log(json.dumps({"slice": "odometry",
                    "shape": [SEQUENCE["height"], SEQUENCE["width"]],
                    "frames": SLAM_FRAMES, **odom_checks,
                    "launches": launched_odom}))
    log(json.dumps({"slice": "stereo",
                    "shape": [STEREO_SEQUENCE["height"],
                              STEREO_SEQUENCE["width"]],
                    **stereo_checks, "launches": launched_stereo}))
    log(json.dumps({"slice": "direct",
                    "shape": [SEQUENCE["height"], SEQUENCE["width"]],
                    **direct_checks, "launches": launched_direct}))
    for cell, checks in sfm_checks.items():
        log(json.dumps({"slice": "sfm_" + cell, **checks,
                        "launches": launched_sfm[
                            "sfm" if cell == "small" else "sfm_wide"]}))
    log(json.dumps({"slice": "fleet",
                    "shape": [SEQUENCE["height"], SEQUENCE["width"]],
                    "frames": [SLAM_FRAMES] * len(FLEET_SEEDS),
                    **fleet_checks, "launches": launched_fleet}))
    log(json.dumps({"slice": "loop_closure",
                    "shape": [LOOP_SEQUENCE["height"],
                              LOOP_SEQUENCE["width"]],
                    **loop_run, "launches": launched_loop,
                    "bow_descent_at": {label: {k: r[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by")}
                        for label, r in b7.items() if label != "loop"}}))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card_name_and_power_limit())
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
