"""The port's build of native/gslam_native.cpp
(gslam_tpu_torch.datasets.native_loader) against the JAX package's
native_loader and PIL.

Bit for bit: the float32 gray of PNG (8-bit gray and RGB, 16-bit gray),
PGM, BMP and baseline JPEG (4:2:0, odd sizes, restart markers) equal to
the JAX package's build of the same source; the raw samples
(``decode_rgb_u8``) equal to PIL's for the lossless formats and to the
arrays written, 16-bit samples in their big-endian order read as such;
NativeLoader's frames equal to the one-shot decode in order, then None
at the end.  Also where the library is built, that a failed build
raises with the compiler's messages, and the zlib link fallback.
"""

import numpy as np
import pytest
from PIL import Image

from gslam_tpu.datasets import native_loader as jn
from gslam_tpu_torch.datasets import native_loader as tn
from gslam_tpu_torch.ops.cuda.build import BUILD_DIR
from gslam_tpu_torch.utils.png import write_png as stdlib_png


def pil_png(path, arr):
    Image.fromarray(arr).save(path)


def smooth(rng, shape):
    """A smooth image with noise (JPEG keeps it close)."""
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    base = (128 + 80 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
            + rng.normal(0, 4, shape[:2]))
    if len(shape) == 3:
        base = np.stack([base, np.roll(base, 3, 0), np.roll(base, 5, 1)], -1)
    return base.clip(0, 255).astype(np.uint8)


def fixtures(tmp_path, rng):
    """(name, path, samples written or None for lossy) of every format."""
    out = []
    for name, arr, writer in (
            ("gray8.png", rng.integers(0, 256, (37, 53), np.uint8), pil_png),
            ("rgb8.png", rng.integers(0, 256, (24, 31, 3), np.uint8),
             pil_png),
            ("gray16.png", rng.integers(0, 65536, (16, 20), np.uint16),
             pil_png),
            ("std_gray8.png", rng.integers(0, 256, (19, 23), np.uint8),
             stdlib_png),
            ("std_rgb8.png", rng.integers(0, 256, (21, 17, 3), np.uint8),
             stdlib_png),
            ("std_gray16.png", rng.integers(0, 65536, (13, 29), np.uint16),
             stdlib_png)):
        p = str(tmp_path / name)
        writer(p, arr)
        out.append((name, p, arr))
    pgm = rng.integers(0, 256, (12, 17), np.uint8)
    p = str(tmp_path / "x.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n17 12\n255\n" + pgm.tobytes())
    out.append(("x.pgm", p, pgm))
    bmp = rng.integers(0, 256, (10, 14, 3), np.uint8)
    p = str(tmp_path / "b.bmp")
    Image.fromarray(bmp).save(p)
    out.append(("b.bmp", p, bmp))
    for name, shape, kw in (
            ("g.jpg", (40, 56), dict(quality=92)),
            ("c420.jpg", (48, 64, 3), dict(quality=90, subsampling=2)),
            ("o444.jpg", (41, 53, 3), dict(quality=95, subsampling=0)),
            ("r.jpg", (32, 48, 3), dict(quality=90, restart_marker_rows=1))):
        p = str(tmp_path / name)
        Image.fromarray(smooth(rng, shape)).save(p, **kw)
        out.append((name, p, None))
    return out


def test_built_into_the_ignored_build_directory():
    lib = tn.build()
    assert lib == tn.library_path() and lib.is_file()
    assert lib.parent == BUILD_DIR and lib.name.startswith("gslam_native-")
    assert tn._load()._name == str(lib)


def test_gray_bit_for_bit_with_the_reference_build(tmp_path, rng):
    if not jn.available():
        pytest.skip("the JAX package's native library did not build")
    for name, p, _ in fixtures(tmp_path, rng):
        got, ref = tn.decode_gray_f32(p), jn.decode_gray_f32(p)
        assert got is not None and ref is not None, name
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert tn.decode_gray_f32(str(tmp_path / "missing.png")) is None


def test_raw_samples_equal_what_was_written(tmp_path, rng):
    for name, p, arr in fixtures(tmp_path, rng):
        got = tn.decode_rgb_u8(p)
        assert got is not None, name
        if arr is None:      # JPEG: the same size as PIL's decode
            assert got.shape[:2] == np.asarray(Image.open(p)).shape[:2]
            assert got.dtype == np.uint8
            continue
        assert got.dtype == arr.dtype, name
        np.testing.assert_array_equal(got, arr, err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(Image.open(p)),
                                      err_msg=name)
    assert tn.decode_rgb_u8(str(tmp_path / "missing.png")) is None
    with pytest.raises(IOError, match="cannot decode"):
        tn.read_rgb_u8(str(tmp_path / "missing.png"))
    with pytest.raises(IOError, match="cannot decode"):
        tn.read_gray_f32(str(tmp_path / "missing.png"))


def test_sixteen_bit_pnm(tmp_path, rng):
    """A PGM with maxval > 255 holds 16-bit big-endian samples: the size
    query, then the 8-bit buffer refused, then the 16-bit one."""
    arr = rng.integers(0, 65536, (9, 11), np.uint16)
    p = str(tmp_path / "d.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n11 9\n65535\n" + arr.astype(">u2").tobytes())
    got = tn.decode_rgb_u8(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("n_threads,ring", [(1, 1), (3, 4)])
def test_native_loader_order_and_end(tmp_path, rng, n_threads, ring):
    paths = []
    for i in range(12):
        p = str(tmp_path / f"{i:03d}.png")
        stdlib_png(p, rng.integers(0, 256, (20 + i, 30), np.uint8))
        paths.append(p)
    ld = tn.NativeLoader(paths, n_threads=n_threads, ring=ring)
    try:
        for p in paths:
            np.testing.assert_array_equal(ld.next(), tn.decode_gray_f32(p))
        assert ld.next() is None
    finally:
        ld.close()
    if jn.available():
        ref = jn.NativeLoader(paths, n_threads=2, ring=4)
        ld = tn.NativeLoader(paths, n_threads=2, ring=4)
        try:
            for _ in paths:
                np.testing.assert_array_equal(ld.next(), ref.next())
        finally:
            ld.close()
            ref.close()


def test_decode_failure_in_the_stream_raises(tmp_path, rng):
    good = str(tmp_path / "a.png")
    stdlib_png(good, rng.integers(0, 256, (8, 8), np.uint8))
    bad = str(tmp_path / "b.png")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    ld = tn.NativeLoader([good, bad])
    try:
        assert ld.next() is not None
        with pytest.raises(IOError):
            ld.next()
        assert ld.next() is None
    finally:
        ld.close()


def test_failed_build_raises_with_the_compiler_messages(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(tn, "SOURCE", src)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        tn.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_zlib_runtime_link_when_the_dev_link_fails(tmp_path, monkeypatch):
    """Where ``-lz`` cannot link, the build links the runtime zlib that
    ctypes.util.find_library names (``-l:libz.so.1``)."""
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn, "LDLIBS", ("-lgslam_no_such_zlib", "-lpthread"))
    lib = tn.build()
    assert lib.is_file() and lib.parent == tmp_path / "build"
