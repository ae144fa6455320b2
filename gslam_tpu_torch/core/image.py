"""Image helpers: cv-style type codes, gray conversion, host <-> device.

Counterpart of ``gslam_tpu/core/image.py``.  Images are plain arrays:

* gray:  (H, W) float32 in [0, 1] (numpy on the host, a tensor on the
  device); uint8 on disk;
* color: (H, W, 3) RGB uint8 on the host;
* depth: (H, W) float32 metres.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# cv-style element type codes: code = depth + 8 * (channels - 1)
_DEPTH_TO_DTYPE = {
    0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
    4: np.int32, 5: np.float32, 6: np.float64,
}
_DTYPE_TO_DEPTH = {np.dtype(v): k for k, v in _DEPTH_TO_DTYPE.items()}


def type_code(dtype, channels: int = 1) -> int:
    """(dtype, channels) -> cv-style code (uint8, 1 channel == CV_8UC1 ==
    0)."""
    return _DTYPE_TO_DEPTH[np.dtype(dtype)] + 8 * (channels - 1)


def decode_type(code: int) -> Tuple[np.dtype, int]:
    return np.dtype(_DEPTH_TO_DTYPE[code % 8]), code // 8 + 1


def channels(img: np.ndarray) -> int:
    return 1 if img.ndim == 2 else img.shape[2]


def to_gray_f32(img: np.ndarray) -> np.ndarray:
    """Any host image -> (H, W) float32 in [0, 1]: BT.601 luma for color,
    computed in float64 and cast once at the end (the datasets' frames
    depend on this order bit for bit)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        scale = 1.0 / 255.0
    elif img.dtype == np.uint16:
        scale = 1.0 / 65535.0
    else:
        scale = 1.0
    if img.ndim == 3:
        img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
               + 0.114 * img[..., 2])
    return (img * scale).astype(np.float32)


def to_device(img: np.ndarray, device,
              pad_to: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Host gray image -> float32 tensor on ``device``, optionally
    zero-padded to a fixed (H, W)."""
    x = np.asarray(img, np.float32)
    if pad_to is not None:
        H, W = pad_to
        out = np.zeros((H, W), np.float32)
        out[:min(H, x.shape[0]), :min(W, x.shape[1])] = x[:H, :W]
        x = out
    return torch.as_tensor(x, device=device)


def clone(img: np.ndarray) -> np.ndarray:
    """Deep copy."""
    return np.array(img, copy=True)
