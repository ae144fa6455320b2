"""The port's dataset players (gslam_tpu_torch.datasets) against the JAX
package's, on fixtures written as tests/test_datasets_eval.py writes
them, each opened by both packages' ``open_dataset`` by extension.

Bit for bit: images (gray float32), colour, depth, right images, cameras
(model, size, float32 parameters), ground truth, IMU windows, GPS rows
and ENU ground truth, timestamps; EuRoC's rectified images to 1.2e-7
(one float32 ulp of values below 1: equal remap tables, see
test_torch_undistort.py, but XLA fuses the JAX package's jitted bilinear
blend).
The port decodes through its own build of native/gslam_native.cpp, the
JAX package through PIL (TUM, EuRoC, image folder, drone map) or its
native library (KITTI), so this also holds the decoders equal on these
formats.  Synthetic frames through the distorted OpenCV camera: the
textured ray table goes through each package's unproject (equal bits on
the CPU here; the maximum pixel difference is asserted 0).  Trajectory
files: the port's TUM writer gives the JAX package's text, its KITTI
writer the same numbers to 2 float32 ulps.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import gslam_tpu.datasets.dronemap  # noqa: F401  (registers ".dronemap")
from chip_smoke import write_tum_sequence
from gslam_tpu.app.registry import open_dataset as j_open
from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
from gslam_tpu.eval import trajectory as jt
from gslam_tpu_torch.app.registry import DATASETS, open_dataset
from gslam_tpu_torch.core.image import to_gray_f32
from gslam_tpu_torch.datasets import FrameData
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval import trajectory as tt
from gslam_tpu_torch.utils.png import write_png as stdlib_png

FIELDS = ("image", "color", "depth", "image_right", "gt_pose", "imu", "gps")


def write_png(path, arr):
    Image.fromarray(arr).save(path)


def assert_same_camera(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)


def assert_same_frames(path, n, remap_atol=0.0):
    """Both packages' players over ``path``: n frames, every field equal
    bit for bit (images to ``remap_atol`` where a rectification remap
    made them); returns the port's player and frames."""
    dj, dt = j_open(path), open_dataset(path)
    assert dj.is_opened() and dt.is_opened()
    assert len(dt) == len(dj) == n
    assert_same_camera(dt.camera, dj.camera)
    fj, ft = list(dj), list(dt)
    assert len(ft) == len(fj) == n
    for a, b in zip(fj, ft):
        assert isinstance(b, FrameData)
        assert (b.id, b.timestamp, b.stereo_baseline) \
            == (a.id, a.timestamp, a.stereo_baseline)
        assert_same_camera(b.camera, a.camera)
        assert_same_camera(b.camera_right, a.camera_right)
        for name in FIELDS:
            va, vb = getattr(a, name), getattr(b, name)
            assert (va is None) == (vb is None), name
            if va is not None:
                va, vb = np.asarray(va), np.asarray(vb)
                assert vb.dtype == va.dtype and vb.shape == va.shape, name
                if remap_atol and name in ("image", "image_right"):
                    np.testing.assert_allclose(vb, va, rtol=0,
                                               atol=remap_atol, err_msg=name)
                else:
                    np.testing.assert_array_equal(vb, va, err_msg=name)
    return dt, ft


def tum_fixture(tmp_path, rng, calib=None):
    root = tmp_path / "fr1_tiny"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, d_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(5):
        t = 1000.0 + i * 0.05
        write_png(root / "rgb" / f"{t:.6f}.png",
                  rng.integers(0, 256, (48, 64, 3), np.uint8))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        if i != 3:        # frame 3's depth is missing: depth None
            d16 = (rng.uniform(0, 3, (48, 64)) * 5000).astype(np.uint16)
            write_png(root / "depth" / f"{t + 0.01:.6f}.png", d16)
            d_lines.append(f"{t + 0.01:.6f} depth/{t + 0.01:.6f}.png")
        if i != 1:
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            gt_lines.append(f"{t:.6f} {0.1 * i} {rng.normal()} 0.5 "
                            + " ".join(f"{v:.9f}" for v in q))
    (root / "rgb.txt").write_text("\n".join(rgb_lines))
    (root / "depth.txt").write_text("\n".join(d_lines))
    (root / "groundtruth.txt").write_text("\n".join(gt_lines))
    if calib is not None:
        (root / "calib.txt").write_text(calib)
    return str(root)


@pytest.mark.parametrize("calib", [
    None, "520.1 521.2 319.5 239.5", "520 521 320 240 0.1 -0.2 0.001 0.002",
    "520 521 320 240 0.1 -0.2 0.001 0.002 0.05"],
    ids=["freiburg1", "pinhole", "opencv8", "opencv9"])
def test_tum_rgbd(tmp_path, rng, calib):
    root = tum_fixture(tmp_path, rng, calib)
    dt, ft = assert_same_frames(root + ".tumrgbd", 5)
    assert dt.camera.model == ("pinhole" if calib and len(calib.split()) == 4
                               else "opencv")
    assert ft[3].depth is None and ft[1].gt_pose is None
    assert ft[0].color.shape == (48, 64, 3) and ft[0].depth.max() <= 3.1
    # a bare directory holding rgb.txt opens too
    ds = DATASETS.create("tumrgbd")
    assert ds.open(root) and len(ds) == 5


def test_tum_rgbd_written_by_the_stdlib_writer(tmp_path):
    """chip_smoke.py's fixture: synthetic distorted frames written as 8-bit
    RGB and 16-bit depth PNGs with calib.txt, read back by both players;
    the decoded frames are what was written."""
    src = SyntheticDataset(n_frames=3, n_points=120, width=96, height=72,
                           motion="line", texture=True,
                           distortion=[-0.25, 0.08])
    src.open("synth://")
    frames = list(src)
    root = str(tmp_path / "synth")
    written = write_tum_sequence(root, frames, src.camera)
    dt, ft = assert_same_frames(root + ".tumrgbd", 3)
    assert dt.camera.model == "opencv"
    np.testing.assert_array_equal(dt.camera.params, src.camera.params)
    for fr, src_fr, (rgb, d16) in zip(ft, frames, written):
        np.testing.assert_array_equal(fr.color, rgb)
        np.testing.assert_array_equal(fr.depth,
                                      d16.astype(np.float32) / 5000.0)
        np.testing.assert_array_equal(fr.gt_pose, src_fr.gt_pose)
        assert np.abs(fr.image - src_fr.image).max() <= 0.5 / 255 + 1e-6


def test_tum_mono(tmp_path, rng):
    root = tmp_path / "mono"
    root.mkdir()
    lines = []
    for i in range(3):
        write_png(root / f"{i:05d}.png",
                  rng.integers(0, 256, (40, 50), np.uint8))
        lines.append(f"{i * 0.05:.6f} {i:05d}.png")
    (root / "images.txt").write_text("\n".join(lines))
    (root / "camera.txt").write_text("0.53 0.71 0.49 0.51 0.89 50 40\n")
    dt, ft = assert_same_frames(str(root) + ".tummono", 3)
    assert dt.camera.model == "atan" and dt.camera.width == 50
    assert ft[0].depth is None and ft[0].color is None


def kitti_fixture(tmp_path, rng):
    root = tmp_path / "00"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir()
    for i in range(3):
        for sub in ("image_0", "image_1"):
            write_png(root / sub / f"{i:06d}.png",
                      rng.integers(0, 256, (40, 120), np.uint8))
    (root / "times.txt").write_text("\n".join(f"{i * 0.1:.6e}"
                                              for i in range(3)))
    fx = 100.0
    (root / "calib.txt").write_text(
        f"P0: {fx} 0 60 0 0 {fx} 20 0 0 0 1 0\n"
        f"P1: {fx} 0 60 {-fx * 0.5} 0 {fx} 20 0 0 0 1 0\n")
    poses = []
    for i in range(3):
        a = 0.3 * i
        c, s = np.cos(a), np.sin(a)
        poses.append(f"{c} 0 {s} {0.5 * i} 0 1 0 0.1 {-s} 0 {c} 0.2")
    (root / "poses.txt").write_text("\n".join(poses))
    return str(root)


def test_kitti(tmp_path, rng):
    dt, ft = assert_same_frames(kitti_fixture(tmp_path, rng) + ".kitti", 3)
    assert dt.camera.model == "pinhole"
    assert (dt.camera.width, dt.camera.height) == (120, 40)
    assert abs(ft[0].stereo_baseline - 0.5) < 1e-6
    assert ft[0].image_right is not None
    np.testing.assert_allclose(ft[1].gt_pose[:3], [0.5, 0.1, 0.2], atol=1e-6)


def yaml(res, intr, dist, R, t):
    rows = [list(R[i]) + [t[i]] for i in range(3)] + [[0, 0, 0, 1]]
    data = ",\n         ".join(", ".join(repr(float(v)) for v in r)
                                   for r in rows)
    return (f"resolution: [{res[0]}, {res[1]}]\n"
            f"intrinsics: [{', '.join(map(str, intr))}]\n"
            f"distortion_coefficients: [{', '.join(map(str, dist))}]\n"
            f"T_BS:\n  data: [{data}]\n")


def euroc_fixture(tmp_path, rng, cam1_deg):
    """tests/test_datasets_eval.py's EuRoC fixture (R_BS = Rz(90)), with
    cam1 turned ``cam1_deg`` about its y axis (0: an already rectified
    pair)."""
    root = tmp_path / "MH_tiny" / "mav0"
    Rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    a = np.radians(cam1_deg)
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    t0 = np.array([0.05, 0.02, 0.01])
    b = 0.110042
    t1 = t0 + Rz @ np.array([b, 0.0, 0.0])
    for cam, R, t in (("cam0", Rz, t0), ("cam1", Rz @ Ry, t1)):
        (root / cam / "data").mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(3):
            ts = 1403636579763555584 + i * 50_000_000
            write_png(root / cam / "data" / f"{ts}.png",
                      rng.integers(0, 256, (30, 40), np.uint8))
            lines.append(f"{ts},{ts}.png")
        (root / cam / "data.csv").write_text("\n".join(lines))
        (root / cam / "sensor.yaml").write_text(yaml(
            (40, 30), (35.0, 35.0, 20.0, 15.0),
            (-0.01, 0.005, 0.0001, -0.0002), R, t))
    (root / "imu0").mkdir()
    imu = ["#ts,wx,wy,wz,ax,ay,az"]
    for j in range(24):
        ts = 1403636579763555584 - 10_000_000 + j * 5_000_000
        w = rng.normal(0, 0.1, 3)
        acc = rng.normal([0.1, 0.2, 9.8], 0.05)
        imu.append(f"{ts}," + ",".join(f"{v:.6f}" for v in (*w, *acc)))
    (root / "imu0" / "data.csv").write_text("\n".join(imu))
    (root / "state_groundtruth_estimate0").mkdir()
    gt = ["#ts,px,py,pz,qw,qx,qy,qz,..."]
    for i in range(3):
        ts = 1403636579763555584 + i * 50_000_000
        gt.append(f"{ts},{0.2 * i},0,1.5,1,0,0,0,0,0,0")
    (root / "state_groundtruth_estimate0" / "data.csv").write_text(
        "\n".join(gt))
    return str(tmp_path / "MH_tiny")


@pytest.mark.parametrize("cam1_deg", [0.0, 2.0], ids=["rectified",
                                                      "rotated"])
def test_euroc(tmp_path, rng, cam1_deg):
    # a rectified frame is a bilinear remap: the JAX package's jitted
    # gather rounds its fused blend differently, by an ulp (values <= 1)
    dt, ft = assert_same_frames(
        euroc_fixture(tmp_path, rng, cam1_deg) + ".euroc", 3,
        remap_atol=1.2e-7 if cam1_deg else 0.0)
    dj = j_open(str(tmp_path / "MH_tiny") + ".euroc")
    assert abs(dt.baseline - dj.baseline) < 1e-12
    np.testing.assert_array_equal(dt.R_cb, dj.R_cb)
    np.testing.assert_array_equal(dt.T_c1c0, dj.T_c1c0)
    assert (dt.rectifier is None) == (cam1_deg == 0.0)
    if cam1_deg:
        # frames carry the rectified pinhole; the player's ``camera``
        # keeps the raw OpenCV cam0, as the JAX package's does
        assert ft[0].camera.model == "pinhole"
        assert dt.camera.model == "opencv"
        np.testing.assert_array_equal(dt.rectifier.R_rect,
                                      dj.rectifier.R_rect)
    else:
        assert ft[0].camera.model == "opencv"
    assert all(len(fr.imu) > 0 for fr in ft)
    # the boundary sample sits in both adjacent windows
    assert ft[0].imu[-1, 0] == ft[1].imu[0, 0]


def test_image_folder(tmp_path, rng):
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(3):
        write_png(d / f"{i:03d}.png", rng.integers(0, 256, (20, 30, 3),
                                                   np.uint8))
    Image.fromarray(rng.integers(0, 256, (20, 30, 3), np.uint8)).save(
        d / "003.bmp")
    (d / "calib.txt").write_text("25 25 15 10 0.01 -0.02 0 0 0.001")
    dt, ft = assert_same_frames(str(d) + ".imgs", 4)
    assert dt.camera.model == "opencv" and dt.camera.width == 30
    assert ft[3].color.shape == (20, 30, 3)


def test_dronemap(tmp_path, rng):
    root = tmp_path / "flight"
    (root / "images").mkdir(parents=True)
    rows = []
    lat, lon, alt = 47.3977, 8.5456, 488.0
    for i in range(4):
        write_png(root / "images" / f"img_{i:03d}.png",
                  rng.integers(0, 256, (24, 32), np.uint8))
        rows.append(f"{i * 0.5} {lat + 1e-5 * i:.8f} {lon - 2e-5 * i:.8f} "
                    f"{alt + 0.3 * i} 12.5")
    (root / "gps.txt").write_text("# t lat lon alt yaw\n" + "\n".join(rows))
    (root / "calib.txt").write_text("30 30 16 12")
    dt, ft = assert_same_frames(str(root) + ".dronemap", 4)
    np.testing.assert_array_equal(dt.enu, j_open(
        str(root) + ".dronemap").enu)
    assert ft[0].gps.shape == (4,) and ft[0].color is None
    np.testing.assert_allclose(ft[0].gt_pose[:3], 0.0, atol=1e-9)
    assert np.linalg.norm(ft[3].gt_pose[:3]) > 1.0
    # ".rtm" names the same player; as in the JAX package the path is the
    # directory itself (the extension is not stripped)
    assert DATASETS.get("rtm") is type(dt)
    rtm = tmp_path / "flight.rtm"
    root.rename(rtm)
    assert len(open_dataset(str(rtm))) == 4


def test_video_file(tmp_path, rng):
    """An MJPG .avi named by a .cvmono file, decoded by cv2 in both
    packages; the camera from the video directory's calib.txt."""
    import cv2

    frames = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(4)]
    w = cv2.VideoWriter(str(tmp_path / "clip.avi"),
                        cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
    for fr in frames:
        w.write(fr)
    w.release()
    (tmp_path / "calib.txt").write_text("60 60 32 24")
    (tmp_path / "seq.cvmono").write_text("clip.avi")
    dt, ft = assert_same_frames(str(tmp_path / "seq.cvmono"), 4)
    assert dt.camera.model == "pinhole" and dt.fps == 10.0
    assert ft[0].color.shape == (48, 64, 3) and ft[1].timestamp == 0.1
    assert len(open_dataset(str(tmp_path / "clip.avi"))) == 4


def test_video_without_cv2_reads_through_imageio(tmp_path, rng,
                                                 monkeypatch):
    import imageio

    frames = [rng.integers(0, 256, (24, 32, 3), np.uint8) for _ in range(3)]
    imageio.mimsave(str(tmp_path / "clip.gif"), frames)
    (tmp_path / "seq.cvmono").write_text("clip.gif")
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    ds = open_dataset(str(tmp_path / "seq.cvmono"))
    assert ds.is_opened() and len(ds) == 3
    assert (ds.camera.width, ds.camera.height) == (32, 24)
    got = list(ds)
    ref = [np.asarray(f)[..., :3] for f in imageio.get_reader(
        str(tmp_path / "clip.gif"))]
    assert len(got) == 3
    for fr, r in zip(got, ref):
        np.testing.assert_array_equal(fr.color, r)
        np.testing.assert_array_equal(fr.image, to_gray_f32(r))
    monkeypatch.setitem(__import__("sys").modules, "imageio", None)
    with pytest.raises(RuntimeError, match="cv2 or imageio"):
        open_dataset(str(tmp_path / "seq.cvmono"))


def test_open_by_extension_and_failures(tmp_path):
    names = DATASETS.names()
    for ext in ("synth", "tumrgbd", "tummono", "kitti", "euroc", "cvmono",
                "mp4", "avi", "mov", "imgs", "dronemap", "rtm"):
        assert ext in names
    with pytest.raises(KeyError, match="no dataset named"):
        open_dataset(str(tmp_path / "seq.nosuchformat"))
    with pytest.raises(KeyError, match="already registered"):
        DATASETS.register("tumrgbd")(object)
    # a path that holds no sequence opens as not opened
    assert not open_dataset(str(tmp_path / "missing") + ".tumrgbd") \
        .is_opened()
    assert not open_dataset(str(tmp_path / "missing") + ".kitti").is_opened()
    cfg = tmp_path / "tiny.synth"
    cfg.write_text('{"n_frames": 3, "n_points": 50, "width": 64, '
                   '"height": 48}')
    ds = open_dataset(str(cfg))
    assert ds.is_opened() and len(ds) == 3
    assert ds.grab_frame().image.shape == (48, 64)


@pytest.mark.parametrize("motion", ["line", "orbit"])
def test_synthetic_distortion_frames(motion):
    cfg = dict(n_frames=3, n_points=300, width=160, height=120,
               motion=motion, texture=True, exposure=0.15,
               distortion=[-0.25, 0.08], stereo=motion == "orbit")
    a, b = JData(**cfg), SyntheticDataset(**cfg)
    assert a.open("synth://") and b.open("synth://")
    assert b.camera.model == a.camera.model == "opencv"
    np.testing.assert_array_equal(b.camera.params, a.camera.params)
    # the ray table through each package's unproject
    assert np.abs(b._ray_lut - a._ray_lut).max() == 0.0
    for fa, fb in zip(a, b):
        for name in ("image", "depth", "gt_pose", "image_right"):
            va, vb = getattr(fa, name), getattr(fb, name)
            assert (va is None) == (vb is None), name
            if va is not None:
                assert np.abs(vb - va).max() == 0.0, name
        assert fb.camera is b.camera


RENDER_AHEAD_CASES = {
    "ring_two_laps": dict(n_frames=8, n_points=300, width=160, height=120,
                          motion="ring_out", texture=True, noise=0.01,
                          laps=2, radius=14.0, world_extent=8.0),
    "line_stereo_imu": dict(n_frames=6, n_points=300, width=160,
                            height=120, motion="line", texture=True,
                            noise=0.01, stereo=True, imu=True,
                            imu_noise=0.01, exposure=0.2),
}


@pytest.mark.parametrize("frames", [None, 3])
@pytest.mark.parametrize("case", sorted(RENDER_AHEAD_CASES))
def test_render_ahead_frames_equal_the_reference(case, frames):
    """Views rendered ahead on threads, then finished in order with the
    sequence's draws: every frame bit for bit the JAX package's, the
    first read before, frames past the ahead window rendered as read."""
    cfg = RENDER_AHEAD_CASES[case]
    a, b = JData(**cfg), SyntheticDataset(**cfg)
    assert a.open("synth://") and b.open("synth://")
    got = [b.grab_frame()]
    b.render_ahead(3, frames)
    assert len(b._ahead) == (cfg["n_frames"] - 1 if frames is None
                             else frames) * (2 if cfg.get("stereo") else 1)
    got += list(b)
    assert b._ahead == {}
    want = list(a)
    assert len(got) == len(want) == cfg["n_frames"]
    for fa, fb in zip(want, got):
        for name in ("image", "depth", "gt_pose", "image_right", "imu"):
            va, vb = getattr(fa, name), getattr(fb, name)
            assert (va is None) == (vb is None), name
            if va is not None:
                np.testing.assert_array_equal(vb, va, err_msg=name)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_image_helpers(dtype):
    from gslam_tpu.core import image as ji
    from gslam_tpu_torch.core import image as ti

    rng = np.random.default_rng(8)
    hi = 1.0 if dtype == np.float32 else np.iinfo(dtype).max
    for shape in ((7, 9), (7, 9, 3)):
        img = (rng.random(shape) * hi).astype(dtype)
        np.testing.assert_array_equal(ti.to_gray_f32(img),
                                      ji.to_gray_f32(img))
        assert ti.channels(img) == ji.channels(img)
        code = ti.type_code(dtype, ti.channels(img))
        assert code == ji.type_code(dtype, ji.channels(img))
        assert ti.decode_type(code) == ji.decode_type(code)
        c = ti.clone(img)
        assert c is not img and np.array_equal(c, img)
    gray = rng.random((5, 6)).astype(np.float32)
    t = ti.to_device(gray, "cpu", pad_to=(8, 8))
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(ji.to_device(gray, (8, 8))))
    assert ti.to_device(gray, "cpu").dtype == torch.float32


def test_trajectory_files(tmp_path):
    rng = np.random.default_rng(7)
    n = 20
    ts = 1.0 + np.arange(n) / 30.0
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([rng.normal(0, 2, (n, 3)), q], 1).astype(
        np.float32)
    tt.save_tum_trajectory(str(tmp_path / "t.tum"), ts, poses)
    jt.save_tum_trajectory(str(tmp_path / "j.tum"), ts, poses)
    assert (tmp_path / "t.tum").read_text() \
        == (tmp_path / "j.tum").read_text()
    # KITTI: float32 rotation matrices from the quaternions, whose
    # normalization rounds differently in the two packages (a last digit
    # of the 7 printed moves): the same numbers to 2 float32 ulps
    tt.save_kitti_trajectory(str(tmp_path / "t.kitti"), poses)
    jt.save_kitti_trajectory(str(tmp_path / "j.kitti"), poses)
    a = np.loadtxt(tmp_path / "t.kitti")
    b = np.loadtxt(tmp_path / "j.kitti")
    assert a.shape == b.shape == (n, 12)
    np.testing.assert_allclose(a, b, rtol=2.5e-7, atol=2.5e-7)
    t2, p2 = tt.load_tum_trajectory(str(tmp_path / "t.tum"))
    tj, pj2 = jt.load_tum_trajectory(str(tmp_path / "t.tum"))
    np.testing.assert_array_equal(t2, tj)
    np.testing.assert_array_equal(p2, pj2)
    assert p2.dtype == np.float32
    np.testing.assert_allclose(t2, ts, atol=1e-6)
    np.testing.assert_allclose(p2, poses, atol=1e-6)
    M = np.loadtxt(tmp_path / "t.kitti").reshape(n, 3, 4)
    np.testing.assert_allclose(M[:, :, 3], poses[:, :3], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(M[:, :, :3] @ np.swapaxes(M[:, :, :3], 1, 2),
                               np.broadcast_to(np.eye(3), (n, 3, 3)),
                               atol=1e-5)
