"""The benchmark's copy of the synthetic world: the same seeds give the
same frames and truth, another ``--seed`` changes only the sensor noise,
and the copy renders what the program's own numpy renderer does."""

import numpy as np
import pytest
import torch

from slambench.scene import World

SCENE = dict(scene_seed=3, lap_frames=384, motion="ring_out", n_points=300,
             n_texture=1500, world_extent=2.0, radius=2.0, dot_half=1,
             noise=0.01, exposure=0.0, depth=True, stereo=False)
SENSOR = dict(width=160, height=120, rate_hz=30, fx=133.85, fy=134.8,
              cx=80.025, cy=61.9, depth_scale=5000)


def render(seed, scene=SCENE, n=6):
    return World(scene, SENSOR, "cpu").episode(n, seed)


def test_same_seeds_same_frames():
    a, b = render(7), render(7)
    assert np.array_equal(a.images, b.images)
    assert np.array_equal(a.depths, b.depths)
    assert np.array_equal(a.R_wc, b.R_wc) and np.array_equal(a.t_wc, b.t_wc)


def test_another_seed_changes_only_the_noise():
    a, b = render(7), render(8)
    assert not np.array_equal(a.images, b.images)
    assert np.abs(a.images - b.images).max() < 0.1        # 0.01 noise
    assert np.array_equal(a.depths, b.depths)
    assert np.array_equal(a.t_wc, b.t_wc)
    quiet = dict(SCENE, noise=0.0)
    assert np.array_equal(render(7, quiet).images, render(8, quiet).images)


def test_stereo_right_view_sees_the_baseline():
    scene = dict(SCENE, motion="line", step=0.08, lap_frames=96,
                 depth=False, stereo=True)
    ep = World(scene, dict(SENSOR, baseline=0.537), "cpu").episode(3, 1)
    assert ep.rights.shape == ep.images.shape and ep.depths is None
    assert not np.array_equal(ep.rights, ep.images)


def test_matches_the_programs_renderer():
    from gslam_tpu_torch.datasets.synthetic import SyntheticDataset

    W, H, fov = 160, 120, 70.0
    f = W / (2 * np.tan(np.radians(fov) / 2))
    ds = SyntheticDataset(n_frames=384, n_points=300, width=W, height=H,
                          motion="ring_out", depth=True, texture=True,
                          radius=2.0, world_extent=2.0, noise=0.0,
                          n_texture=1500, fov_deg=fov)
    ds.open("synth://bench")
    scene = dict(SCENE, noise=0.0)
    w = World(scene, dict(SENSOR, fx=f, fy=f, cx=W / 2, cy=H / 2), "cpu")
    w.X = torch.from_numpy(np.concatenate([ds.X, ds.X_bg]))
    w.I = torch.from_numpy(np.concatenate([ds.I, ds.I_bg])).float()
    w.grid = torch.from_numpy(ds._tex)
    ep = w.episode(40, 0)
    for i in (0, 13, 39):
        fr = ds._grab(i)
        assert np.array_equal(fr.image, ep.images[i])
        np.testing.assert_allclose(fr.depth, ep.depths[i], atol=1e-4)
        np.testing.assert_allclose(fr.gt_pose[:3], ep.t_wc[i], atol=1e-6)


@pytest.mark.parametrize("bad", ["spiral"])
def test_unknown_motion_is_refused(bad):
    with pytest.raises(ValueError):
        render(1, dict(SCENE, motion=bad))
