"""DVO's deployment of the port's direct odometry (``slambench/configs/
tum_fr3_dvo.json``: 76,800 points a keyframe, levels 3 to 1 of 640x480)
against its plain reference, ``slambench/plain_direct.py`` (PyTorch in
float64, one frame at a time, nothing of the program).

* On the CPU, at a quarter of the sensor (160x120, the intrinsics scaled
  about the pixel centres) on the cell's own scene rendered by
  ``slambench.scene.World``, 4800 points over 3 levels aligned down to
  level 1, 24 frames:

  - teacher-forced: each frame's reference step starts from the state the
    program held before it (its keyframe's frame and pose, the previous
    pose and the velocity).  The pose agrees within 1e-5 m and 5e-4
    degrees, the valid fraction within one point, and the keyframe and
    lost decisions are equal.  Over six seeds the float32 program reads
    3e-8 m from the float64 reference at the median frame and at most
    1.8e-6 m and 8.9e-5 degrees, in one frame of two of the seeds (a
    depth sample's nearest pixel or a point at the image border decided
    the other way); the tolerances are about 5 times those largest gaps,
    while the reference in bfloat16 (the precision below the program's)
    reads 8.9 mm and 0.40 degrees and fails them by far;
  - free-running, each on its own: the trajectories within 2e-5 m and
    1e-3 degrees, about 10 times the largest gap over the six seeds
    (1.8e-6 m, 9.0e-5 degrees), since the frames' gaps carry over.

* ``finest_level``: 0 gives the bits of a configuration without the
  field; a value outside the pyramid raises; the levels under it are not
  aligned, nor their gradients or depth computed.
* The harness's ``lost_frames`` counts exactly the frames that coasted,
  on a sequence with a jump; the counters observe each aligned frame once.
* Every key of the configuration's ``slam`` table is a ``DirectConfig``
  field (``SLAMS.create`` drops unknown keys silently).
* The six readers of the cell's per-layer metrics: a value on a hand-built
  run and on a short CPU run of the harness, None where the program has no
  such span or counter.
* On the card (marker ``cuda``; skips without one): the frames of a 15 s
  window of the cell (two episodes and more) as the timed path of
  ``slambench.run`` processed them, at the published sizes, teacher-forced
  against the reference on the card in float64: the pose within 2e-6 m
  and 5e-5 degrees, the valid fraction within one point, the decisions
  equal; the reference in bfloat16 fails.  A frame's alignment replayed
  from its CUDA graph gives the eager path's bits, and one graph serves
  every system of the process.  Run there by

      python -m pytest --noconftest -m cuda tests/test_torch_direct_dvo.py

  or, for the numbers, ``python tests/test_torch_direct_dvo.py --card``
  (this file imports neither JAX nor the JAX package).
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gslam_tpu_torch.models  # noqa: F401  (registers the systems)
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.models import direct
from slambench import reference
from slambench import run as bench_run
from slambench.plain_direct import Keyframe, PlainDirect
from slambench.scene import World

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CELL = "tum_fr3_dvo.live"
CONFIG = json.loads((ROOT / "slambench/configs/tum_fr3_dvo.json")
                    .read_text())
SMALL_SLAM = dict(CONFIG["slam"], n_points=4800, n_levels=3, finest_level=1)
SEED = 2147483917
N_FRAMES = 24
# teacher-forced and free-running tolerances at the quarter size (above)
TOL_T, TOL_R = 1e-5, 5e-4
FREE_T, FREE_R = 2e-5, 1e-3
TOL_FRAC = 0.01


def quarter_sensor(sensor: dict, q: int = 4) -> dict:
    """The sensor at 1/q of its size, intrinsics about the pixel
    centres."""
    return dict(sensor, width=sensor["width"] // q,
                height=sensor["height"] // q, fx=sensor["fx"] / q,
                fy=sensor["fy"] / q, cx=(sensor["cx"] + 0.5) / q - 0.5,
                cy=(sensor["cy"] + 0.5) / q - 0.5)


SMALL = dict(CONFIG, sensor=quarter_sensor(CONFIG["sensor"]),
             slam=SMALL_SLAM)


def render(config, n, seed, device="cpu"):
    ep = World(config["scene"], config["sensor"], device).episode(n, seed)
    return bench_run.make_frames(config, ep)


@pytest.fixture(scope="module")
def frames():
    return render(SMALL, N_FRAMES, SEED)


def matrix(pose) -> torch.Tensor:
    """A (7,) [t, q wxyz] pose -> (4, 4) float64 on the host."""
    p = pose.detach().cpu().double().numpy()[None]
    return torch.from_numpy(reference.poses_to_matrices(p)[0])


def gaps(A: torch.Tensor, B: torch.Tensor):
    """Translation (m) and rotation (degrees) between two 4x4 poses; the
    angle from the chord, which keeps its precision near 0."""
    A, B = A.cpu().double(), B.cpu().double()
    chord = float((A[:3, :3] - B[:3, :3]).norm()) / (2 * math.sqrt(2))
    return (float((A[:3, 3] - B[:3, 3]).norm()),
            math.degrees(2 * math.asin(min(chord, 1.0))))


def counter(slam, name) -> float:
    return slam.timer.stats().get(name, {"total": 0.0})["total"]


class Recorder:
    """Keeps, for each frame a ``DirectOdometry`` tracks, the state it held
    before the frame and what the frame did."""

    def __init__(self):
        self.rows = []

    def wrap(self, track):
        def kept(slam, frame):
            before = dict(pose=matrix(slam.pose_wc),
                          velocity=matrix(slam.velocity),
                          kf_pose=None if slam.kf_pose_cw is None
                          else matrix(slam.kf_pose_cw),
                          kf_X=slam.kf_X, gap=slam.frames_since_kf,
                          inb=counter(slam, "direct/inbounds"),
                          pts=counter(slam, "direct/points"),
                          lost=counter(slam, "direct/lost"))
            pose = track(slam, frame)
            pts = counter(slam, "direct/points") - before["pts"]
            self.rows.append(dict(
                system=id(slam), frame=frame, before=before,
                pose=matrix(pose),
                frac=(counter(slam, "direct/inbounds") - before["inb"])
                / pts if pts else None,
                made=slam.kf_X is not before.pop("kf_X"),
                lost=counter(slam, "direct/lost") - before["lost"] > 0))
            return pose
        return kept


def teacher_forced(rows, ref: PlainDirect):
    """The reference's step for every aligned frame of ``rows`` (one
    system's frames in order) from the program's state before it: its
    gaps to the program's pose and valid fraction, and the decisions."""
    out = []
    kf_frame, kf_cache = None, {}
    for r in rows:
        b = r["before"]
        if b["kf_pose"] is not None:
            if id(kf_frame) not in kf_cache:
                kf_cache.clear()
                kf_cache[id(kf_frame)] = ref.keyframe(
                    ref.pyramid(kf_frame.image), kf_frame.depth,
                    torch.eye(4, dtype=torch.float64))
            k = kf_cache[id(kf_frame)]
            kf = Keyframe(k.X, k.valid, k.refs,
                          b["kf_pose"].to(ref.device, ref.dtype))
            s = ref.step(kf, ref.pyramid(r["frame"].image), r["frame"].depth,
                         b["pose"].to(ref.device),
                         b["velocity"].to(ref.device), b["gap"] + 1)
            dt, dr = gaps(s.pose_wc, r["pose"])
            out.append(dict(dt=dt, dr=dr, dfrac=abs(s.frac - r["frac"]),
                            made=(s.new_keyframe, r["made"]),
                            lost=(not s.tracked, r["lost"])))
        if r["made"]:
            kf_frame = r["frame"]
    return out


def program_run(frames, slam_cfg, device="cpu"):
    rec = Recorder()
    slam = SLAMS.create("direct", frames[0].camera, device=device,
                        **slam_cfg)
    track = rec.wrap(direct.DirectOdometry.track)
    for fr in frames:
        track(slam, fr)
    return slam, rec.rows


@pytest.fixture(scope="module")
def program(frames):
    return program_run(frames, SMALL_SLAM)


def test_teacher_forced_against_the_plain_reference(program):
    slam, rows = program
    got = teacher_forced(rows, PlainDirect(SMALL["sensor"], SMALL_SLAM))
    assert len(got) == N_FRAMES - 1
    assert max(g["dt"] for g in got) < TOL_T, got
    assert max(g["dr"] for g in got) < TOL_R, got
    assert max(g["dfrac"] for g in got) <= TOL_FRAC, got
    assert all(a == b for g in got for a, b in (g["made"], g["lost"]))
    # keyframes were made along the way, and every frame tracked
    assert sum(g["made"][1] for g in got) >= 2
    assert not any(g["lost"][1] for g in got)


def test_the_tolerance_fails_a_bfloat16_reference(program):
    """The control: the reference computed in bfloat16 is outside the
    teacher-forced tolerances."""
    _, rows = program
    got = teacher_forced(rows[:9], PlainDirect(SMALL["sensor"], SMALL_SLAM,
                                               dtype=torch.bfloat16))
    assert max(g["dt"] for g in got) > 100 * TOL_T
    assert max(g["dr"] for g in got) > 100 * TOL_R


def test_free_running_against_the_plain_reference(frames, program):
    slam, _ = program
    steps = PlainDirect(SMALL["sensor"], SMALL_SLAM).run(frames)
    worst = [gaps(s.pose_wc, matrix(p))
             for s, p in zip(steps, slam.trajectory)]
    assert len(worst) == N_FRAMES
    assert max(t for t, _ in worst) < FREE_T, worst
    assert max(r for _, r in worst) < FREE_R, worst
    # and both follow the scene: 24 frames of 8.3 mm
    gt = reference.relative_truth(SMALL["scene"], N_FRAMES)
    P = torch.stack([matrix(p) for p in slam.trajectory]).numpy()
    assert np.abs(P[:, :3, 3] - gt[:, :3, 3]).max() < 0.02


def test_finest_level_zero_is_the_default_bit_for_bit(frames):
    cfg = {k: v for k, v in SMALL_SLAM.items() if k != "finest_level"}
    a = SLAMS.create("direct", frames[0].camera, device="cpu", **cfg)
    b = SLAMS.create("direct", frames[0].camera, device="cpu",
                     **dict(cfg, finest_level=0))
    c = SLAMS.create("direct", frames[0].camera, device="cpu",
                     **dict(cfg, finest_level=1))
    assert a.cfg.finest_level == 0
    for fr in frames[:10]:
        for s in (a, b, c):
            s.track(fr)
    assert torch.equal(torch.stack(a.trajectory), torch.stack(b.trajectory))
    assert a.stats == b.stats
    assert not torch.equal(torch.stack(a.trajectory),
                           torch.stack(c.trajectory))


@pytest.mark.parametrize("level", [-1, 3, 4])
def test_finest_level_outside_the_pyramid_raises(frames, level):
    with pytest.raises(ValueError, match="finest_level"):
        SLAMS.create("direct", frames[0].camera, device="cpu",
                     **dict(SMALL_SLAM, finest_level=level))


def test_levels_under_the_finest_are_not_aligned(frames, monkeypatch):
    shapes = {"align": [], "depth": []}

    def align(img, *a, **kw):
        shapes["align"].append(tuple(img.shape))
        return align_level(img, *a, **kw)

    def resize(depth, shape):
        shapes["depth"].append(tuple(shape))
        return resize_nearest(depth, shape)

    align_level, resize_nearest = direct._align_level, direct._resize_nearest
    monkeypatch.setattr(direct, "_align_level", align)
    monkeypatch.setattr(direct, "_resize_nearest", resize)
    slam = SLAMS.create("direct", frames[0].camera, device="cpu",
                        **SMALL_SLAM)
    for fr in frames[:3]:
        slam.track(fr)
    levels = [(60, 80), (30, 40)]          # levels 1 and 2 of 120 x 160
    assert shapes["align"] == shapes["depth"] == levels[::-1] * 2
    # the keyframe slab is still sampled on every level, level 0 included
    assert slam.kf_shapes == [(120, 160)] + levels


def test_lost_frames_counts_the_frames_that_coasted():
    """A jump of 140 frames (48 degrees) in a sequence, under a
    ``min_valid_frac`` that the program's fractions (0.90 to 0.98) straddle
    and whose product with ``n_points`` is not a whole number: the
    harness's count is the frames the tracker coasted."""
    seq = render(SMALL, 156, SEED + 1)
    seq = seq[:10] + seq[150:156]
    cfg = dict(SMALL_SLAM, n_points=4799, min_valid_frac=0.93)
    slam, rows = program_run(seq, cfg)
    assert cfg["min_valid_frac"] * cfg["n_points"] % 1 != 0
    coasted = [r["frac"] < cfg["min_valid_frac"] for r in rows[1:]]
    assert [r["lost"] for r in rows[1:]] == coasted
    assert 0 < sum(coasted) < len(coasted)
    assert bench_run.lost_frames(slam, len(seq)) == sum(coasted)
    assert slam.cfg.min_track_inliers == math.ceil(0.93 * 4799)
    # the counters observe every aligned frame once
    st = slam.timer.stats()
    for name in ("direct/inbounds", "direct/points", "direct/keyframes",
                 "direct/lost"):
        assert st[name]["count"] == len(seq) - 1
    assert st["direct/lost"]["total"] == sum(coasted)
    assert st["direct/keyframes"]["total"] == sum(r["made"]
                                                  for r in rows[1:])
    assert st["direct/keyframe"]["count"] == sum(r["made"] for r in rows)


def test_the_plain_reference_loads_nothing_of_the_program():
    code = ("import sys, slambench.plain_direct\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert not {"jax", "jaxlib", "flax", "gslam_tpu",
                "gslam_tpu_torch"} & set(out.stdout.split())


def test_every_slam_key_is_a_direct_config_field():
    fields = set(direct.DirectConfig.__dataclass_fields__)
    assert set(CONFIG["slam"]) == fields
    cfg = direct.DirectConfig(**CONFIG["slam"])
    assert cfg.min_track_inliers == 19200
    assert (cfg.n_points, cfg.n_levels, cfg.finest_level) == (76800, 4, 1)


# ---------------------------------------------------------------------------
# the cell's readers


def hand_run():
    """A ``Run`` of 100 frames, the first 40 in the traced part."""
    def s(count, total):
        return {"count": count, "total": total}

    run = bench_run.Run(config={}, traffic={}, device="cpu", episode=None)
    run.frames, run.traced_frames = 100, 40
    run.sections = {
        "direct/align": s(99, 3.0),
        "direct/align:device": s(40, 1.6),
        "direct/align/fetch": s(99, 1.2),
        "direct/keyframe": s(14, 0.7),
        "direct/inbounds": s(99, 95000),
        "direct/points": s(99, 99000),
        "direct/keyframes": s(99, 12),
    }
    run.traced_sections = {
        "direct/align": s(39, 1.4),
        "direct/align:device": s(40, 1.6),
        "direct/align/fetch": s(39, 0.6),
        "direct/keyframe": s(6, 0.4),
        "direct/inbounds": s(39, 38000),
        "direct/points": s(39, 39000),
        "direct/keyframes": s(39, 6),
    }
    return run


READ = {
    "direct_align_ms": 1.6 / 60 * 1e3,
    "direct_align_device_ms": 1.6 / 40 * 1e3,
    "direct_wait_ms": 0.6 / 60 * 1e3,
    "direct_keyframe_ms": 0.3 / 60 * 1e3,
    "direct_inbounds_pct": 100.0 * 57000 / 60000,
    "direct_kf_pct": 100.0 * 6 / 60,
}


@pytest.mark.parametrize("metric", sorted(READ))
def test_reader_on_a_hand_built_run(metric):
    got = bench_run.reader(metric)(hand_run())
    assert got == pytest.approx(READ[metric], rel=1e-12)
    empty = bench_run.Run(config={}, traffic={}, device="cpu", episode=None)
    empty.frames, empty.traced_frames = 100, 40
    empty.sections = {"direct/pyramid": {"count": 100, "total": 1.0}}
    empty.traced_sections = {"direct/pyramid": {"count": 40, "total": 0.4}}
    assert bench_run.reader(metric)(empty) is None


def test_readers_on_a_short_cpu_run_of_the_harness():
    bench = bench_run.load_benchmark()
    cell, _, traffic, _ = bench_run.cell_files(bench, CELL)
    assert cell["config"] == "tum_fr3_dvo" and cell["chips"] == 1
    config = dict(SMALL, episode_frames=24, draws=1)
    run = bench_run.run_cell(config, dict(traffic, warm_frames=4), SEED,
                             4.0, False, device="cpu")
    assert run.frames >= 24 and run.lost == 0
    got = {m: bench_run.reader(m)(run) for m in READ}
    for m in ("direct_align_ms", "direct_wait_ms", "direct_keyframe_ms"):
        assert got[m] > 0.0, got
    assert got["direct_wait_ms"] < got["direct_align_ms"]
    assert 80.0 < got["direct_inbounds_pct"] <= 100.0
    # a keyframe every 8 tracked frames when the overlap stays above 0.6:
    # 2 of a 24-frame episode's 23 aligned frames
    assert 5.0 < got["direct_kf_pct"] <= 12.5
    # no card, so no span on its timeline
    assert got["direct_align_device_ms"] is None


# ---------------------------------------------------------------------------
# the published sizes, on the card

CARD_SEED = 2147500027
CARD_SECONDS = 15.0
# about 5 times the largest float32-against-float64 gap of three episodes
# at the published sizes (3.9e-7 m, 1.03e-5 degrees), three orders of
# magnitude under the bfloat16 reference's (6.0 mm, 0.27 degrees)
CARD_T, CARD_R = 2e-6, 5e-5


def card_comparison(dev, seed=CARD_SEED, seconds=CARD_SECONDS,
                    monkeypatch=None, bf16_frames=9):
    """The frames of the cell's window as ``slambench.run`` drove them on
    ``dev``, each system's frames teacher-forced against the reference on
    ``dev`` in float64, and the first ``bf16_frames`` of the first system
    against the reference in bfloat16: the gaps of each."""
    bench = bench_run.load_benchmark()
    _, config, traffic, _ = bench_run.cell_files(bench, CELL)
    rec = Recorder()
    kept = rec.wrap(direct.DirectOdometry.track)
    monkeypatch.setattr(direct.DirectOdometry, "track", kept)
    run = bench_run.run_cell(config, traffic, seed, seconds, False,
                             device=dev)
    monkeypatch.undo()
    systems = []
    for r in rec.rows:
        if not systems or systems[-1][0]["system"] != r["system"]:
            systems.append([])
        systems[-1].append(r)
    systems = systems[1:]          # the warm episode of the set-up out
    ref = PlainDirect(config["sensor"], config["slam"], device=dev)
    out = {"frames": run.frames, "lost": run.lost,
           "card": torch.cuda.get_device_name(0), "episodes": []}
    for rows in systems:
        got = teacher_forced(rows, ref)
        out["episodes"].append(dict(
            frames=len(rows), dt_max=max(g["dt"] for g in got),
            dr_max=max(g["dr"] for g in got),
            dt_p50=float(np.median([g["dt"] for g in got])),
            dfrac_max=max(g["dfrac"] for g in got),
            decisions_equal=all(a == b for g in got
                                for a, b in (g["made"], g["lost"])),
            keyframes=sum(g["made"][1] for g in got),
            lost=sum(g["lost"][1] for g in got)))
    low = teacher_forced(systems[0][:bf16_frames], PlainDirect(
        config["sensor"], config["slam"], device=dev, dtype=torch.bfloat16))
    out["bfloat16"] = dict(dt_max=max(g["dt"] for g in low),
                           dr_max=max(g["dr"] for g in low),
                           dfrac_max=max(g["dfrac"] for g in low))
    return out


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_published_sizes_on_the_card(dev, monkeypatch):
    got = card_comparison(dev, monkeypatch=monkeypatch)
    assert len(got["episodes"]) >= 2, got
    for ep in got["episodes"]:
        assert ep["dt_max"] < CARD_T and ep["dr_max"] < CARD_R, got
        assert ep["dfrac_max"] <= TOL_FRAC and ep["decisions_equal"], got
    assert got["bfloat16"]["dt_max"] > CARD_T or \
        got["bfloat16"]["dr_max"] > CARD_R, got


@pytest.mark.cuda
def test_the_graph_replays_the_eager_alignment_on_the_card(dev):
    """At the published sizes, a frame's alignment replayed from its CUDA
    graph gives the eager path's bits, pose and statistics, frame by
    frame, and one graph of the process serves every later system."""
    bench = bench_run.load_benchmark()
    _, config, _, _ = bench_run.cell_files(bench, CELL)
    feed = render(config, 40, CARD_SEED, dev)
    runs = []
    for use_graphs in (False, True, True):
        slam = SLAMS.create("direct", feed[0].camera, device=dev,
                            **config["slam"])
        slam.use_graphs = use_graphs
        poses = torch.stack([slam.track(fr) for fr in feed]).cpu()
        runs.append((poses, slam.stats, set(slam.timer.stats())))
    for poses, stats, _ in runs[1:]:
        assert torch.equal(poses, runs[0][0])
        assert stats == runs[0][1]
    assert "direct/align/capture" not in runs[0][2] | runs[2][2]
    keys = [k for k in direct.graphs.PROCESS if k[0] == "direct"]
    assert len(keys) == 1, keys


if __name__ == "__main__" and "--card" in sys.argv:
    with pytest.MonkeyPatch.context() as mp:
        print(json.dumps(card_comparison(torch.device("cuda"),
                                         monkeypatch=mp)))
