"""The fused tracking step — the flagship forward function.

Counterpart of ``gslam_tpu/models/graft.py``: extract (FAST + NMS +
top-K + orientation + BRIEF) -> match against the local-map descriptor
slab -> batched P3P RANSAC -> Gauss-Newton pose refinement, for one
frame.  With ``use_kernels=True`` (the default) the detector, the BRIEF
sampler and the matcher run as the CUDA kernels of
:mod:`gslam_tpu_torch.ops.cuda`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gslam_tpu_torch.convert import camera_from_numpy, map_slab_from_numpy
from gslam_tpu_torch.core.camera import pinhole_unproject
from gslam_tpu_torch.estimation.pnp import find_pnp_ransac
from gslam_tpu_torch.ops.frontend import extract_features
from gslam_tpu_torch.ops.matching import match_descriptors
from gslam_tpu_torch.utils.platform import require_device


def track_forward(image: torch.Tensor, cam_params: torch.Tensor,
                  map_xyz: torch.Tensor, map_desc: torch.Tensor,
                  map_valid: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None,
                  max_kps: int = 512, threshold: float = 0.06,
                  ransac_b: int = 256, use_kernels: bool = True,
                  device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pose_cw (7,), n_inliers, n_features) for one frame.

    image: (H, W) float32 grayscale in [0, 1]
    cam_params: (4,) pinhole [fx, fy, cx, cy]
    map_xyz (M, 3) float32, map_desc (M, 8) int32, map_valid (M,) bool:
    the local-map slab (see :mod:`gslam_tpu_torch.convert`).
    RANSAC samples come from ``generator`` (on ``device``), or from
    ``uniforms`` (ransac_b, 4) when given.  Runs on ``device``, which
    defaults to the CUDA card; inputs are moved there.
    """
    dev = require_device(device)
    image, cam_params, map_xyz, map_desc, map_valid = (
        t.to(dev) for t in (image, cam_params, map_xyz, map_desc, map_valid))
    feats = extract_features(image, max_kps=max_kps, threshold=threshold,
                             use_kernels=use_kernels)
    if use_kernels:
        from gslam_tpu_torch.ops.cuda.matcher import match_hamming

        m = match_hamming(map_desc, map_valid, feats.desc, feats.valid)
    else:
        m = match_descriptors(map_desc, map_valid, feats.desc, feats.valid)
    rays = pinhole_unproject(cam_params,
                             feats.uv[m.idx.clamp_min(0).long()])[:, :2]
    T, _, n = find_pnp_ransac(map_xyz, rays, m.valid, threshold=2e-5,
                              B=ransac_b, generator=generator,
                              uniforms=uniforms)
    return T, n, feats.count


def example_image(H: int = 480, W: int = 640
                  ) -> Tuple[np.ndarray, np.ndarray, np.random.Generator]:
    """The example frame: 600 bright 3x3 squares on a dark background,
    its pinhole camera, and the numpy generator after those draws (the
    same draws as the reference's ``example_inputs``)."""
    rng = np.random.default_rng(0)
    img = np.full((H, W), 0.1, np.float32)
    for _ in range(600):
        y = rng.integers(8, H - 8)
        x = rng.integers(8, W - 8)
        img[y - 1:y + 2, x - 1:x + 2] = rng.uniform(0.6, 1.0)
    fx = W * 0.8
    cam = np.asarray([fx, fx, W / 2, H / 2], np.float32)
    return img, cam, rng


def example_inputs(H: int = 480, W: int = 640, M: int = 2048,
                   max_kps: int = 512, device="cuda",
                   use_kernels: bool = True):
    """Deterministic example args for ``track_forward``:
    (image, cam_params, map_xyz, map_desc, map_valid, generator).

    The local map is built from the example image itself with this
    package's ``extract_features`` (keypoints unprojected at a smooth
    synthetic depth field), then padded with random distractors, so the
    identity pose is the answer.  The numpy draws are the reference's.
    """
    dev = require_device(device)
    img, cam, rng = example_image(H, W)
    fx = float(cam[0])
    img_t = torch.as_tensor(img, device=dev)
    feats = extract_features(img_t, max_kps=max_kps, use_kernels=use_kernels)
    uv = feats.uv.cpu().numpy()
    z = 4.0 + 1.5 * np.sin(uv[:, 0] / 90.0) * np.cos(uv[:, 1] / 70.0)
    x3 = (uv[:, 0] - W / 2) / fx * z
    y3 = (uv[:, 1] - H / 2) / fx * z
    xyz = np.zeros((M, 3), np.float32)
    desc = np.zeros((M, 8), np.uint32)
    valid = np.zeros(M, bool)
    k = min(max_kps, M)
    xyz[:k] = np.stack([x3, y3, z], -1)[:k]
    desc[:k] = feats.desc.cpu().numpy().view(np.uint32)[:k]
    valid[:k] = feats.valid.cpu().numpy()[:k]
    nrest = M - k
    xyz[k:] = np.stack([rng.uniform(-2, 2, nrest),
                        rng.uniform(-1.5, 1.5, nrest),
                        rng.uniform(3, 9, nrest)], -1)
    desc[k:] = rng.integers(0, 2**31, (nrest, 8)).astype(np.uint32)
    valid[k:] = True
    xyz_t, desc_t, valid_t = map_slab_from_numpy(xyz, desc, valid, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return (img_t, camera_from_numpy(cam, device=dev), xyz_t, desc_t,
            valid_t, gen)
