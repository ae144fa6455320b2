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
   both maps, twice for the same bits), B2 BRIEF and B3 matcher against
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
   ``bench.py`` (C = 8, P = 1024, O = 8); B5 also at C = 32, P = 1024,
   O = 8 (the widest camera count of its contract; six cameras per
   point, repeated cameras, pad slots) and at the loop run's C = 4,
   P = 384, each twice for the same bits; and ``bundle_adjust`` with
   the kernels against the plain LM for 6 iterations;
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
   version, its bound and the launch floor, B5, B3, B4 and B1 (the
   SLAM frame) at their extra shapes too; B1's bound counts the arc
   sums only at the starts that qualify on its input;
6. hold B7 (BoW tree descent) against its plain version, word for
   word, at the loop path's shape (N = 384 descriptors, k = 6, L = 2)
   and at k = 8, L = 4 (4681 nodes; N = 512, and an odd N with invalid
   rows), on vocabularies trained here from seeded random descriptors;
7. drive ``KeyframeSLAM`` with a vocabulary over the two-lap sequence
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
8. print the slices' JSON lines (the probes and the extra shapes'
   times among them), the ``kernels`` JSON line, then the device JSON
   as the last line.

Needs a CUDA card and ``nvcc``; without a card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import ctypes
import glob
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from gslam_tpu_torch.core.camera import pinhole_unproject
from gslam_tpu_torch.estimation.pnp import (
    _p3p_grunert, pnp_reproj_error, refine_pose_gn,
)
from gslam_tpu_torch.estimation.ransac import run_ransac
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.models.graft import example_inputs, track_forward
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.ops import frontend, vocab
from gslam_tpu_torch.ops.cuda import brief, build, fastnms, matcher, schur
from gslam_tpu_torch.ops.cuda import vocab as vocab_k
from gslam_tpu_torch.ops.matching import (
    gate_squared, hamming_top2, hamming_top2_gated, match_descriptors,
)
from gslam_tpu_torch.opt import ba
from gslam_tpu_torch.utils.platform import card_name_and_power_limit

H, W, M, K, B = 480, 640, 2048, 512, 256
DEVICE = "cuda"
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
# B7 at the top of the JAX package's contract (4681 nodes, 4096 words)
VOC_BIG = dict(k=8, L=4)

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
    "bow_descent": dict(source="gslam_tpu_torch/csrc/vocab.cu",
                        replaces="gslam_tpu/ops/pallas/vocab.py:69"),
}
# (wrapper module, its launch counter) per kernel
COUNTERS = {"fast_nms": (fastnms, "launches"), "brief": (brief, "launches"),
            "matcher": (matcher, "launches"),
            "gated_matcher": (matcher, "gated_launches"),
            "schur": (schur, "schur_launches"),
            "ba_cost": (schur, "cost_launches"),
            "bow_descent": (vocab_k, "launches")}
TRACK_PATH = ("fast_nms", "brief", "matcher")
SLAM_PATH = ("fast_nms", "brief", "gated_matcher", "schur", "ba_cost")
LOOP_PATH = SLAM_PATH + ("bow_descent",)


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


def assert_schur_close(out_k, out_p, what):
    """B5's outputs against the plain version's, within
    tests/test_pallas.py:180-191's tolerances; the max abs error of
    each."""
    (S1, b1, W1, Hi1, bp1), (S0, b0, W0, Hi0, bp0) = out_k, out_p
    checks = [
        ("S", S1, S0, 1e-4, 1e-4 * S0.abs().max().item()),
        ("b", b1, b0, 0.0, 1e-4 * max(b0.abs().max().item(), 1e-6)),
        ("W_e", W1.W_e, W0.W_e, 0.0, 1e-4),
        ("Hpp_inv", Hi1, Hi0, 1e-3, 1e-3),
        ("bp", bp1, bp0, 0.0, 1e-5)]
    errs = {}
    for name, k, p, rtol, atol in checks:
        errs[name] = (k - p).abs().max().item()
        torch.testing.assert_close(k, p, rtol=rtol, atol=atol,
                                   msg=f"B5 {name} disagrees ({what})")
    return errs


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
    nms_p, raw_p = fastnms.fast_nms_plain(img, THRESH)

    # B2: BRIEF on that frame's K keypoints (plain detector path)
    uv, _, kvalid, _ = frontend.select_keypoints(nms_p, max_kps=K,
                                                 raw_score=raw_p)
    angle = frontend.compute_orientations(img, uv)
    blur = frontend.gaussian_blur(img, sigma=2.0)
    ca, sa = torch.cos(angle), torch.sin(angle)
    d_k = brief.brief(blur, uv, ca, sa)
    d_p = frontend.brief_from_rotation(blur, uv, ca, sa)
    torch.cuda.synchronize()
    bad_words = (d_k != d_p)[kvalid].sum().item()
    bit_err = 0.0 if bad_words == 0 else 1.0
    log(f"B2 brief: {int(kvalid.sum())} valid keypoints, "
        f"{bad_words} differing words")
    if bad_words:
        raise AssertionError("BRIEF kernel is not bit-equal")
    rec["brief"] = dict(max_abs_err=bit_err, args=(blur, uv, ca, sa))

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


def phase_check_fast_frame(frame):
    """B1 on the first frame of the 64-frame SLAM sequence, at the SLAM
    path's threshold."""
    img = torch.as_tensor(frame.image, device=DEVICE)
    return {"fast_nms_slam_frame": check_fast_nms(
        img, SLAM_CFG["fast_threshold"], "first SLAM frame")}


def phase_main_path(inputs):
    """One track_forward through the kernels, launch counts around it;
    then the plain path on the card from the same generator seed."""
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
    return launched


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


def device_profile(step, frames: int, label: str):
    """Device busy share of ``step()``: kernel time that torch.profiler
    records over ``frames`` calls, over their wall time; and the kernels
    that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
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
    Kn = uv.shape[0]
    # per bit: 8 products, 6 sums, 4 roundings, 8 clamps, 2 addresses
    # (2 ops each), 1 compare
    brief_ops = Kn * 256 * 31
    brief_bytes = 4 * (blur.numel() + Kn * 4 + 256 * 4) + Kn * 32
    work = {
        "fast_nms": fast_work(img, thresh),
        "brief": (brief_bytes, brief_ops),
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


def bench_problem():
    """The local-BA problem of bench.py:199-218 (C = 8 cameras, P = 1024
    points, O = 8 observation slots), drawn in the same order."""
    rng = np.random.default_rng(0)
    C, P, O = 8, 1024, 8
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(3, 9, P)], -1).astype(np.float32)
    poses = np.tile(np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32), (C, 1))
    poses[:, 0] = 0.1 * np.arange(C)
    obs_cam = rng.integers(0, C, (P, O)).astype(np.int32)
    pc = X[:, None] + poses[obs_cam][..., :3]
    uv = (pc[..., :2] / pc[..., 2:3]).astype(np.float32)
    uv += rng.normal(0, 5e-4, uv.shape).astype(np.float32)
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    xyz = X + rng.normal(0, 0.01, X.shape).astype(np.float32)
    fields = (poses, cam_fixed, xyz, np.zeros(P, bool), obs_cam, uv,
              np.ones((P, O), bool), np.ones((P, O), np.float32))
    return ba.BundleProblem(*(torch.as_tensor(x, device=DEVICE)
                              for x in fields))


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

    prob = bench_problem()
    lam = torch.tensor(1e-3, device=DEVICE)
    S1, b1, W1, Hi1, bp1 = schur.schur_reduce_kernel(prob, lam, 0.01)
    S0, b0, W0, Hi0, bp0 = ba.schur_reduce(prob, lam, 0.01)
    c1 = schur.ba_cost_kernel(prob, 0.01)
    c0 = ba.ba_cost(prob, 0.01)
    torch.cuda.synchronize()
    errs = assert_schur_close((S1, b1, W1, Hi1, bp1),
                              (S0, b0, W0, Hi0, bp0), "C=8, P=1024, O=8")
    errs["cost"] = (c1 - c0).abs().max().item()
    torch.testing.assert_close(c1, c0, rtol=1e-5, atol=0.0,
                               msg="B6 cost disagrees")
    log("B5 schur / B6 cost vs plain (C=8, P=1024, O=8): max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    assert_same_bits(lambda: schur.schur_reduce_kernel(prob, lam, 0.01),
                     "B5 schur")
    rec["schur"] = dict(max_abs_err=max(v for k, v in errs.items()
                                        if k != "cost"),
                        args=(prob, lam))
    rec["ba_cost"] = dict(max_abs_err=errs["cost"], args=(prob,))

    # B5 at the widest camera count of its contract and at the loop
    # run's window, few cameras per point, repeated cameras, pad slots
    for label, case in SCHUR_EXTRA.items():
        fields = ba_case(**case, seed=1)
        wide = to_problem(fields, DEVICE)
        plain = to_problem(without_pad_indices(fields), DEVICE)
        out_k = schur.schur_reduce_kernel(wide, lam, 0.01)
        out_p = ba.schur_reduce(plain, lam, 0.01)
        torch.cuda.synchronize()
        e = assert_schur_close(out_k, out_p, label)
        log(f"B5 schur vs plain ({label}): max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
        assert_same_bits(lambda: schur.schur_reduce_kernel(wide, lam, 0.01),
                         f"B5 schur ({label})")
        rec["schur_" + label] = dict(max_abs_err=max(e.values()),
                                     args=(wide, lam), plain=plain)

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


def load_frames():
    t0 = time.perf_counter()
    ds = SyntheticDataset(**SEQUENCE)
    ds.open("synth://")
    frames = [ds.grab_frame() for _ in range(SLAM_FRAMES)]
    log(f"sequence: {SLAM_FRAMES} frames {SEQUENCE['height']}x"
        f"{SEQUENCE['width']} rendered in {time.perf_counter() - t0:.1f} s")
    return ds.camera, frames


def run_slam(camera, frames, use_kernels=True, seed=0):
    """A fresh KeyframeSLAM over ``frames``; (slam, seconds)."""
    slam = KeyframeSLAM(camera, SLAMConfig(**SLAM_CFG,
                                           use_kernels=use_kernels,
                                           seed=seed), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr in frames:
        slam.track(fr)
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0


def slam_metrics(slam, frames):
    """Trajectory metrics of a run over ``frames`` against their ground
    truth."""
    ts = np.asarray([fr.timestamp for fr in frames])
    gt = np.stack([fr.gt_pose[:3] for fr in frames])
    return evaluate_trajectory(ts, slam.positions(), ts, gt,
                               with_scale=False)


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
    cfg = slam.cfg
    tracked = sum(st["n_inliers"] >= cfg.min_track_inliers
                  for st in slam.stats)
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


def split_ms(slam, n):
    """Wall ms per frame of each timer section, and the rest (host)."""
    st = slam.timer.stats()
    out = {k.split("/")[1]: v["total"] * 1e3 / n for k, v in st.items()}
    return out


def phase_slam_timing(camera, frames, first_ate):
    """Warm runs in turns (kernels, plain, kernels) and a profile; the
    runs with the kernels must repeat the first run's ATE bit for bit
    (no float atomics anywhere on the path)."""
    n = len(frames)
    runs = {}
    for label, uk in (("kernels", True), ("plain", False),
                      ("kernels2", True)):
        slam, secs = run_slam(camera, frames, use_kernels=uk)
        runs[label] = (secs * 1e3 / n, split_ms(slam, n))
        ate = slam_metrics(slam, frames).ate_rmse
        if uk and ate != first_ate:
            raise AssertionError(f"SLAM {label}: ATE {ate!r} m differs from "
                                 f"the first run's {first_ate!r} m")
        log(f"SLAM {label}: ATE {ate!r} m")
        log(f"SLAM {label}: {secs * 1e3 / n:.3f} ms/frame "
            f"({n / secs:.2f} frames/s); split ms/frame: "
            + ", ".join(f"{k} {v:.3f}" for k, v in runs[label][1].items())
            + f"; rest (host glue) "
              f"{secs * 1e3 / n - sum(runs[label][1].values()):.3f}")
    # device busy share over the first 24 frames of a fresh run (the
    # bootstrap keyframe, 23 tracked frames, two keyframes with BA)
    n_prof = min(24, n)
    slam = KeyframeSLAM(camera, SLAMConfig(**SLAM_CFG), device=DEVICE)
    it = iter(frames[:n_prof])
    prof = device_profile(lambda: slam.track(next(it)), n_prof,
                          "KeyframeSLAM")
    best = min(runs["kernels"][0], runs["kernels2"][0])
    return dict(ms_per_frame=best, frames_per_s=1e3 / best,
                ms_per_frame_runs=[runs["kernels"][0], runs["kernels2"][0]],
                plain_ms_per_frame=runs["plain"][0],
                split_ms_per_frame=runs["kernels"][1],
                plain_split_ms_per_frame=runs["plain"][1], profile=prof)


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
    C = prob.cam_pose.shape[0]
    P, O = prob.obs_cam.shape
    n_obs = int(prob.obs_valid.sum())
    # B6 per observation: residual, norm and Huber weight, w e^2 (40)
    cost_work = (C * 64 + P * 12 + P * O * 16 + 4, n_obs * 40)
    work = {"gated_matcher": gated_matcher_work(*g),
            "schur": schur_work(prob), "ba_cost": cost_work}
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


def phase_check_vocab():
    """B7 against its plain version, word for word, at the loop path's
    shape and at the top of the JAX package's table contract."""
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    voc_loop = vocab.train_vocabulary(
        random_words(rng, 4000), k=LOOP_VOC["k"], L=LOOP_VOC["L"], seed=0,
        device=DEVICE)
    voc_big = vocab.train_vocabulary(random_words(rng, 40000), seed=0,
                                     device=DEVICE, **VOC_BIG)
    log(f"vocabularies trained in {time.perf_counter() - t0:.1f} s: "
        f"{voc_loop.node_desc.shape[0]} and {voc_big.node_desc.shape[0]} "
        "nodes")
    cases = {"loop": (voc_loop, LOOP_CFG["max_kps"], 0.1),
             "big": (voc_big, 512, 0.0), "big_odd": (voc_big, 509, 0.2)}
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
                          args=(desc, valid))
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
    """KeyframeSLAM with a vocabulary over the two-lap sequence, frames
    rendered one at a time; launch counters around the run; the gates
    of tests/test_longrun.py::test_kitti00_shaped_two_lap_run; then the
    kidnap and its relocalization."""
    ds = SyntheticDataset(**LOOP_SEQUENCE)
    ds.open("synth://")
    t0 = time.perf_counter()
    voc = train_loop_vocabulary(ds)
    log(f"loop vocabulary: k={voc.k}, L={voc.L}, {voc.n_words} words, "
        f"trained in {time.perf_counter() - t0:.1f} s")
    ds.open("synth://")                      # rewind
    n = LOOP_SEQUENCE["n_frames"]
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**LOOP_CFG), vocabulary=voc,
                        device=DEVICE)
    lc = slam.loop_closer
    ts, gt, kept, closure_s = [], [], {}, []
    render_s = track_s = prev_loop_s = 0.0
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
    tracked = sum(st["n_inliers"] >= slam.cfg.min_track_inliers
                  for st in slam.stats)
    st = slam.timer.stats()
    split = {k.split("/")[1]: v["total"] * 1e3 / n for k, v in st.items()}
    top = sum(v for k, v in split.items() if k != "loop_gba")  # nested
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
        + f"; rest (host glue) {track_s * 1e3 / n - top:.3f}; seconds per "
          f"closure {[round(x, 3) for x in closure_s]}")
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


def descent_work(voc, N):
    """(bytes, float operations, Hamming steps) of one descent:
    descriptors and validity in, words out, the nodes touched (at most
    k L per descriptor, at most the table); 8 steps (xor, popc, add) per
    descriptor, level and child."""
    touched = min(voc.node_desc.shape[0], N * voc.k * voc.L)
    return N * 32 + touched * 32 + N * 5, 0, N * voc.k * voc.L * 8


def phase_vocab_kernel_times(rec_v, launched, n_keyframes):
    """B7's device time beside its plain version at both shapes: (the
    kernels-line record, at the loop path's shape; the record at the
    larger tree)."""
    out = []
    for label in ("loop", "big"):
        voc = rec_v[label]["voc"]
        desc, valid = rec_v[label]["args"]
        calls = {"bow_descent": (
            lambda: vocab_k.transform_words_kernel(
                voc.node_desc, desc, valid, voc.k, voc.L),
            lambda: vocab._transform_words(voc.node_desc, desc, valid,
                                           voc.k, voc.L))}
        log(f"B7 at N={desc.shape[0]}, k={voc.k}, L={voc.L} "
            f"({voc.node_desc.shape[0]} nodes):")
        out += time_kernels(
            calls, {"bow_descent": descent_work(voc, desc.shape[0])},
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
    """B5 and B3 at their extra shapes: device times beside the plain
    versions and the bounds, for the lines before the kernels line."""
    pairs = {}
    for label in SCHUR_EXTRA:
        entry = rec["schur_" + label]
        prob, lam = entry["args"]
        pairs["schur_" + label] = (
            entry, lambda p=prob: schur.schur_reduce_kernel(p, lam, 0.01),
            lambda p=entry["plain"]: ba.schur_reduce(p, lam, 0.01),
            schur_work(prob))
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
    out = {}
    for label, (entry, kfn, pfn, work) in pairs.items():
        out[label], ks = time_pair(kfn, pfn, work)
        out[label]["max_abs_err"] = entry["max_abs_err"]
        log(f"{label}: kernel {ks[0]:.6f}/{ks[1]:.6f} ms, plain "
            f"{ks[2]:.6f}/{ks[3]:.6f} ms; bound "
            f"{out[label]['bound_ms']:.6f} ms ({out[label]['bound_by']}); "
            f"launch floor {LAUNCH_FLOOR_MS[0]:.6f} ms")
    return out


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
    launched_track = phase_main_path(inputs)
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
    launched_slam, slam_checks = phase_slam(camera, frames)
    t = phase("KeyframeSLAM main path", t)
    slam_times = phase_slam_timing(camera, frames, slam_checks["ate_m"])
    t = phase("KeyframeSLAM timing", t)
    del frames
    rec_v = phase_check_vocab()
    t = phase("check B7", t)
    launched_loop, loop_run = phase_loop()
    t = phase("loop closure main path", t)

    # B1, B2, B4-B6 report their launches on the 64-frame SLAM path, B3
    # on track_forward, B7 on the loop run
    launched = {k: (launched_track[k] if k == "matcher"
                    else launched_loop[k] if k == "bow_descent"
                    else launched_slam[k]) for k in KERNELS}
    kern = phase_kernel_times(rec, launched)
    kern += phase_slam_kernel_times(rec, launched, SLAM_FRAMES,
                                    slam_checks["local_ba_runs"])
    b7, b7_big = phase_vocab_kernel_times(rec_v, launched,
                                          loop_run["keyframes"])
    kern.append(b7)
    extra = phase_extra_kernel_times(rec)
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
    log(json.dumps({"slice": "loop_closure",
                    "shape": [LOOP_SEQUENCE["height"],
                              LOOP_SEQUENCE["width"]],
                    **loop_run, "launches": launched_loop,
                    "bow_descent_k8_L4": {k: b7_big[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by")}}))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card_name_and_power_limit())
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
