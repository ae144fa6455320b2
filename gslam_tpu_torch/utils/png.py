"""PNG output with the standard library alone (``zlib``, ``struct``).

The CLI's ``viz`` overview and the test fixtures' image files are
written through :func:`write_png`, so neither needs an imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path, arr):
    """Write ``arr`` as a PNG with the standard library alone (zlib,
    struct): uint8 gray (H, W), uint8 RGB (H, W, 3) or uint16 gray
    (H, W) as 16-bit samples, filter 0 on every row, no interlace."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, got "
                         f"{arr.dtype}")
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG image must be (H, W) or (H, W, 3), got "
                         f"{arr.shape}")
    H, W = arr.shape[:2]
    data = np.ascontiguousarray(arr, ">u2" if arr.dtype == np.uint16
                                else np.uint8)
    rows = data.view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    depth = 16 if arr.dtype == np.uint16 else 8
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))
