"""ctypes binding of the native decode and readahead library.

Counterpart of ``gslam_tpu/datasets/native_loader.py``: the same C
library, ``native/gslam_native.cpp`` (PNG 8 / 16-bit gray and RGB,
binary PGM / PPM, BMP and baseline JPEG decoders, and a multi-threaded
readahead loader), bound with ctypes.  The port builds its own copy at
first use, with the flags of ``native/Makefile``, into
``gslam_tpu_torch/ops/cuda/_build/gslam_native-<hash>.so`` (the hash
covers the source and the flags, so an edited source is rebuilt).  A
failed build raises with the compiler's messages; nothing falls back to
another decoder.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from gslam_tpu_torch.ops.cuda.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "gslam_native.cpp"
# native/Makefile's CXXFLAGS and LDLIBS
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
LDLIBS = ("-lz", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"gslam_native-{h[:16]}.so"


def _compile(out: str, ldlibs: Tuple[str, ...]
             ) -> subprocess.CompletedProcess:
    return subprocess.run(["g++", *CXX_FLAGS, "-o", out, str(SOURCE),
                           *ldlibs], capture_output=True, text=True,
                          timeout=600)


def build() -> Path:
    """Compile the library unless it is built; its path.  Links zlib as
    ``-lz``; where that fails (no ``libz.so`` development link) links the
    runtime library that ``ctypes.util.find_library("z")`` names.
    Raises with g++'s messages if no build succeeds."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = _compile(tmp, LDLIBS)
        if r.returncode != 0:
            z = ctypes.util.find_library("z")
            if z is None:
                raise RuntimeError(f"g++ failed building {SOURCE}:\n"
                                   f"{r.stdout}{r.stderr}")
            r2 = _compile(tmp, (f"-l:{z}", "-lpthread"))
            if r2.returncode != 0:
                raise RuntimeError(
                    f"g++ failed building {SOURCE} with -lz:\n{r.stdout}"
                    f"{r.stderr}\nand with -l:{z}:\n{r2.stdout}{r2.stderr}")
        os.replace(tmp, out)        # atomic: readers see whole files
    finally:
        Path(tmp).unlink(missing_ok=True)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.gslam_decode_gray_f32.restype = ctypes.c_int
        lib.gslam_decode_gray_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            i32p, i32p]
        lib.gslam_decode_rgb_u8.restype = ctypes.c_int
        lib.gslam_decode_rgb_u8.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            i32p, i32p, i32p]
        lib.gslam_loader_create.restype = ctypes.c_void_p
        lib.gslam_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int]
        lib.gslam_loader_next.restype = ctypes.c_int
        lib.gslam_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            i32p, i32p]
        lib.gslam_loader_destroy.restype = None
        lib.gslam_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def decode_gray_f32(path: str) -> Optional[np.ndarray]:
    """Any supported image -> (H, W) float32 gray (the library's float32
    BT.601 luma, 16-bit samples / 65535), or None if it cannot be
    decoded."""
    lib = _load()
    w, h = ctypes.c_int(), ctypes.c_int()
    if not lib.gslam_decode_gray_f32(path.encode(), None, 0,
                                     ctypes.byref(w), ctypes.byref(h)):
        return None
    out = np.empty((h.value, w.value), np.float32)
    ok = lib.gslam_decode_gray_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size, ctypes.byref(w), ctypes.byref(h))
    return out if ok else None


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_header(path: str) -> Optional[Tuple[int, int, int, int]]:
    """(width, height, channels, bytes per sample) from a PNG's IHDR, or
    None for another format."""
    with open(path, "rb") as f:
        head = f.read(26)
    if len(head) < 26 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        return None
    w, h, depth, color = struct.unpack(">IIBB", head[16:26])
    return w, h, _PNG_CHANNELS.get(color, 0), max(depth // 8, 1)


def decode_rgb_u8(path: str) -> Optional[np.ndarray]:
    """Any supported image -> its samples as stored: (H, W) or (H, W, C)
    uint8, or uint16 for 16-bit samples (PNG's big-endian order read as
    such); None if it cannot be decoded.  A PNG is decoded once (its
    header gives the size); another format is asked for its size first."""
    lib = _load()
    w, h, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    hdr = _png_header(path) if os.path.isfile(path) else None
    if hdr is not None:
        sizes = [hdr]
    else:
        if not lib.gslam_decode_rgb_u8(path.encode(), None, 0,
                                       ctypes.byref(w), ctypes.byref(h),
                                       ctypes.byref(ch)):
            return None
        # 8-bit, else a 16-bit PNM (the call refuses the smaller buffer)
        sizes = [(w.value, h.value, ch.value, 1),
                 (w.value, h.value, ch.value, 2)]
    for W, H, C, nb in sizes:
        buf = np.empty(W * H * C * nb, np.uint8)
        if lib.gslam_decode_rgb_u8(
                path.encode(),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
                ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch)) \
                and (w.value, h.value, ch.value) == (W, H, C):
            arr = buf.view(">u2").astype(np.uint16) if nb == 2 else buf
            return arr.reshape((H, W) if C == 1 else (H, W, C))
    return None


class NativeLoader:
    """Ordered readahead over a file list (gray float32 frames): worker
    threads of the library decode ahead of the consumer into a bounded
    ring."""

    def __init__(self, paths: List[str], n_threads: int = 2,
                 ring: int = 8, max_hw: Tuple[int, int] = (2048, 2048)):
        self._h = None
        lib = _load()
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._paths_keepalive = arr
        self._h = lib.gslam_loader_create(arr, len(paths), n_threads, ring)
        self._cap = max_hw[0] * max_hw[1]
        self._buf = np.empty(self._cap, np.float32)

    def next(self) -> Optional[np.ndarray]:
        """Next frame in order; None at the end; raises on a decode
        failure."""
        w, h = ctypes.c_int(), ctypes.c_int()
        r = self._lib.gslam_loader_next(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._cap, ctypes.byref(w), ctypes.byref(h))
        if r == -1:
            return None
        if r == 0:
            raise IOError("native decode failed")
        return self._buf[:w.value * h.value].reshape(h.value, w.value).copy()

    def close(self) -> None:
        if self._h:
            self._lib.gslam_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def read_rgb_u8(path: str) -> np.ndarray:
    """:func:`decode_rgb_u8`, raising ``IOError`` where it gives None."""
    arr = decode_rgb_u8(path)
    if arr is None:
        raise IOError(f"cannot decode {path}")
    return arr


def read_gray_f32(path: str) -> np.ndarray:
    """:func:`decode_gray_f32`, raising ``IOError`` where it gives None."""
    arr = decode_gray_f32(path)
    if arr is None:
        raise IOError(f"cannot decode {path}")
    return arr
