"""A tracked frame's PnP RANSAC + GN refine as one CUDA graph a process
(``KeyframeSLAM._track_pnp``) against the eager call.

* On the CPU: the uniforms drawn before the call from a generator give
  ``find_pnp_ransac`` the bits that the same generator gives it inside
  the call, and leave the generator where the eager call leaves it; and
  ``track`` stays eager there (the counter ``slam/track_fused/pnp_graph``
  observes 0 a tracked frame, no graph is cached).
* On the card (marker ``cuda``; skips without one): a ``KeyframeSLAM``
  over 32 synthetic RGB-D frames with ``use_graphs`` True (graph
  replays) and False (eager) on the same seed gives the same poses,
  match counts and inlier counts bit for bit, with draws from the
  generator or from a ``uniforms`` hook; the counter observes 1 on every
  tracked frame, and a second system of the process replays the first
  one's graph without a capture of its own.  Stereo, monocular,
  visual-inertial and pyramid systems take the same path, with the same
  bits as their eager runs.  Run there by

      python -m pytest --noconftest -m cuda tests/test_torch_pnp_graph.py

  (this file imports neither JAX nor the JAX package).
"""

import numpy as np
import pytest
import torch

import gslam_tpu_torch.models  # noqa: F401  (registers the systems)
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.core.se3 import se3_apply
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.estimation.pnp import find_pnp_ransac
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.ops.cuda.graphs import PROCESS

SCENE = dict(n_frames=32, n_points=300, width=192, height=144,
             motion="line", depth=True)
CFG = dict(max_kps=192, fast_threshold=0.1, ba_window=4, ba_points=256,
           ba_iters=3, cap_frames=32, cap_points=2048, cap_obs=8192)


def pnp_case(seed, N=2048):
    """N world points seen from a known pose: normalized rays with pixel
    noise, a third of them outliers, an eighth masked out."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                    rng.uniform(2, 8, N)], -1).astype(np.float32)
    T = torch.tensor([0.05, -0.02, 0.1, 0.9997, 0.01, 0.02, -0.015])
    T[3:] = T[3:] / T[3:].norm()
    pc = se3_apply(T, torch.from_numpy(xyz))
    rays = pc[:, :2] / pc[:, 2:]
    rays += torch.from_numpy(rng.normal(0, 5e-4, (N, 2)).astype(np.float32))
    out = torch.from_numpy(rng.random(N) < 1 / 3)
    rays[out] = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (int(out.sum()), 2)).astype(np.float32))
    valid = torch.from_numpy(rng.random(N) >= 1 / 8)
    return torch.from_numpy(xyz), rays, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hoisted_draw_equals_the_generator_draw(seed):
    """track's graph path draws (B, 4) uniforms before the call; the
    eager call draws them inside ``ransac_sample_indices`` from the same
    generator.  Same T, inlier mask and count, same generator state."""
    xyz, rays, valid = pnp_case(seed)
    g1 = torch.Generator().manual_seed(1000 + seed)
    g2 = torch.Generator().manual_seed(1000 + seed)
    thr = (2.0 / 535.4) ** 2
    T1, inl1, n1 = find_pnp_ransac(xyz, rays, valid, threshold=thr, B=256,
                                   generator=g1)
    u = torch.rand((256, 4), generator=g2)
    T2, inl2, n2 = find_pnp_ransac(xyz, rays, valid, threshold=thr, B=256,
                                   uniforms=u)
    assert torch.equal(T1, T2)
    assert torch.equal(inl1, inl2)
    assert torch.equal(n1, n2)
    assert int(n1) > 1000          # the case is solved, not degenerate
    assert torch.equal(g1.get_state(), g2.get_state())


def run(device, frames, camera, graphs, uniforms=None):
    slam = KeyframeSLAM(camera, SLAMConfig(**CFG), device=device,
                        uniforms=uniforms)
    slam.use_graphs = graphs
    for f in frames:
        slam.track(f)
    return slam


def pnp_graphs():
    """The process's PnP graphs."""
    return [g for k, g in PROCESS.items() if k[0] == "pnp"]


def scene():
    ds = SyntheticDataset(**SCENE)
    ds.open("synth://")
    return list(ds), ds.camera


def test_cpu_track_stays_eager():
    frames, camera = scene()
    PROCESS.clear()
    slam = run("cpu", frames[:6], camera, graphs=True)
    st = slam.timer.stats()
    assert st["slam/track_fused/pnp_graph"]["count"] == 5
    assert st["slam/track_fused/pnp_graph"]["total"] == 0
    assert "slam/track_fused/capture_s" not in st
    assert PROCESS == {}


class Draws:
    """A ``uniforms`` hook: host draws from a numpy stream, one (256, 4)
    block a tracked frame."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self):
        return torch.from_numpy(self.rng.random((256, 4), dtype=np.float32))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("draws", ["generator", "hook"])
def test_graph_replay_equals_eager_on_the_card(dev, draws):
    frames, camera = scene()
    PROCESS.clear()

    def hook():
        return None if draws == "generator" else Draws(7)

    graph = run(dev, frames, camera, graphs=True, uniforms=hook())
    eager = run(dev, frames, camera, graphs=False, uniforms=hook())
    again = run(dev, frames, camera, graphs=True, uniforms=hook())
    tracked = len(frames) - 1
    assert torch.equal(torch.stack(graph.trajectory),
                       torch.stack(eager.trajectory))
    assert torch.equal(torch.stack(again.trajectory),
                       torch.stack(eager.trajectory))
    assert graph.stats == eager.stats == again.stats
    assert all(s["n_inliers"] >= 12 for s in eager.stats[1:])
    for slam, total in ((graph, tracked), (eager, 0), (again, tracked)):
        st = slam.timer.stats()["slam/track_fused/pnp_graph"]
        assert (st["count"], st["total"]) == (tracked, total)
    assert graph.timer.stats()["slam/track_fused/capture_s"]["count"] == 1
    assert "slam/track_fused/capture_s" not in again.timer.stats()
    assert len(pnp_graphs()) == 1


# scene overrides, system, config overrides: the other systems whose
# ``track`` goes through ``_track_local_map``
VARIANTS = {
    "stereo": (dict(depth=False, stereo=True, baseline=0.3), "stereo", {}),
    "mono": (dict(depth=False, n_points=3000), "keyframe", {}),
    "vi": (dict(imu=True), "keyframe",
           dict(vi_min_factors=3, kf_min_gap=2, kf_max_gap=6)),
    "pyramid": ({}, "keyframe", dict(n_levels=2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_other_systems_take_the_graph_on_the_card(dev, variant):
    over_scene, system, over_cfg = VARIANTS[variant]
    ds = SyntheticDataset(**{**SCENE, **over_scene})
    ds.open("synth://")
    frames = list(ds)
    runs = []
    for graphs in (True, False):
        slam = SLAMS.create(system, ds.camera, device=dev, **CFG, **over_cfg)
        slam.use_graphs = graphs
        for f in frames:
            slam.track(f)
        runs.append(slam)
    graph, eager = runs
    assert torch.equal(torch.stack(graph.trajectory),
                       torch.stack(eager.trajectory))
    assert graph.stats == eager.stats
    g = graph.timer.stats()["slam/track_fused/pnp_graph"]
    e = eager.timer.stats()["slam/track_fused/pnp_graph"]
    assert g["count"] == e["count"] >= len(frames) - 2
    assert (g["total"], e["total"]) == (g["count"], 0)
