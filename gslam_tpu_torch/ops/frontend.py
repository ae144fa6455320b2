"""ORB-style feature frontend: FAST + orientation + rotated BRIEF.

Counterpart of ``gslam_tpu/ops/frontend.py``, single-scale and pyramid.
The functions here are the plain PyTorch versions, written to round as
the jnp reference does: the separable filters are explicit
shift-multiply-adds in the reference's tap order, the FAST arc sums run
sequentially from the first arc pixel, and top-K selection is a stable
descending sort (``lax.top_k`` breaks ties by lowest index).

:func:`extract_features` with ``use_kernels=True`` routes the detector,
the orientation's centroid moments and the BRIEF sampler through the
CUDA kernels of :mod:`gslam_tpu_torch.ops.cuda`, which take these
functions' results as their gold.  :func:`extract_features_pyramid`
runs that extraction per level of an antialiased bilinear pyramid
(:func:`image_pyramid`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DESC_WORDS = 8        # 256-bit descriptors as 8 x 32-bit words

# 16-pixel Bresenham circle of radius 3 (standard FAST), (dx, dy) pairs
FAST_OFFSETS = np.array([
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
    (-1, 3)], np.int32)

PATCH_R = 15          # orientation / descriptor patch radius
BRIEF_BITS = DESC_WORDS * 32

# select_keypoints' two-stage top-K: chunk-local, then global
_CHUNK = 2048
_K_CHUNK = 64


class Features(NamedTuple):
    """Fixed-capacity keypoint set for one image."""

    uv: torch.Tensor      # (K, 2) float32 pixel coords (x, y)
    score: torch.Tensor   # (K,) response
    angle: torch.Tensor   # (K,) radians
    desc: torch.Tensor    # (K, DESC_WORDS) int32 (uint32 bit pattern)
    valid: torch.Tensor   # (K,) bool
    count: torch.Tensor   # () int32


# ---------------------------------------------------------------------------
# blur


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _sep_filter(img: torch.Tensor, krow, kcol) -> torch.Tensor:
    """Separable filter as shift-multiply-adds (SAME zero padding), in the
    reference's tap order, skipping zero taps after the first, so that
    the sums round as the reference's do."""
    krow = np.asarray(krow, np.float32)
    kcol = np.asarray(kcol, np.float32)
    rr = len(krow) // 2
    rc = len(kcol) // 2
    H, W = img.shape
    p = F.pad(img, (rr, rr))
    out = float(krow[0]) * p[:, 0:W]
    for j in range(1, len(krow)):
        if krow[j] != 0.0:
            out = out + float(krow[j]) * p[:, j:j + W]
    p = F.pad(out, (0, 0, rc, rc))
    out = float(kcol[0]) * p[0:H, :]
    for j in range(1, len(kcol)):
        if kcol[j] != 0.0:
            out = out + float(kcol[j]) * p[j:j + H, :]
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  radius: int = 4) -> torch.Tensor:
    """Separable Gaussian blur, SAME padding. img (H, W) f32."""
    k = _gauss_kernel1d(sigma, radius)
    return _sep_filter(img, k, k)


def image_pyramid(img: torch.Tensor, n_levels: int = 4,
                  scale: float = 1.25) -> list:
    """Downscaled copies of ``img`` (level 0 = the input): level i is
    (round(H / scale^i), round(W / scale^i)).  The JAX package resizes
    with ``jax.image.resize(..., "linear")``, which antialiases when it
    shrinks; so does this (a triangle filter widened by the scale), and
    the two agree to about 1e-6, not bit for bit."""
    out = [img]
    for size in pyramid_shapes(*img.shape, n_levels, scale)[1:]:
        out.append(F.interpolate(img[None, None], size=size,
                                 mode="bilinear", align_corners=False,
                                 antialias=True)[0, 0].contiguous())
    return out


def pyramid_shapes(H: int, W: int, n_levels: int, scale: float) -> list:
    """(H, W) of each level of :func:`image_pyramid`: level i is
    (round(H / scale^i), round(W / scale^i))."""
    return [(int(round(H / scale ** i)), int(round(W / scale ** i)))
            for i in range(n_levels)]


# ---------------------------------------------------------------------------
# FAST


def fast_score(img: torch.Tensor, threshold: float = 0.06,
               arc: int = 9) -> torch.Tensor:
    """FAST-N/16 corner score map (0 where not a corner).

    A corner needs >= ``arc`` contiguous circle pixels all brighter (or
    all darker) than centre +/- threshold; the score is the largest
    sum(|p_i - p| - t) over qualifying arcs, summed in arc order.
    """
    shifted = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), (0, 1))
         for (dx, dy) in FAST_OFFSETS], 0)           # (16, H, W)
    diff = shifted - img[None]
    ext = torch.cat([diff, diff[:arc]], 0)           # (16 + arc, H, W)
    win = torch.stack([ext[s:s + arc] for s in range(16)], 0)
    okb = (win > threshold).all(1)                   # (16, H, W)
    okd = (win < -threshold).all(1)
    mb = win - threshold
    md = -win - threshold
    sb = mb[:, 0]
    sd = md[:, 0]
    for k in range(1, arc):
        sb = sb + mb[:, k]
        sd = sd + md[:, k]
    zero = img.new_zeros(())
    score = torch.maximum(torch.where(okb, sb, zero).amax(0),
                          torch.where(okd, sd, zero).amax(0))
    H, W = img.shape
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    border = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(border, score, zero)


def nms(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Keep local maxima in (2r+1)^2 windows (off-image neighbours are
    -inf, as in the reference's reduce_window)."""
    w = 2 * radius + 1
    mx = F.max_pool2d(score[None, None], w, stride=1, padding=radius)[0, 0]
    return torch.where((score >= mx) & (score > 0), score,
                       score.new_zeros(()))


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Top-k along the last axis, ties broken by lowest index
    (``lax.top_k``'s rule)."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """Bilinear samples of ``img`` at (x, y): the top-left neighbour
    clamped into [0, W-2] x [0, H-2] and the fractions into [0, 1], as
    the reference's ``_bilinear``."""
    H, W = img.shape
    x0 = torch.floor(x).to(torch.int32).clamp(0, W - 2)
    y0 = torch.floor(y).to(torch.int32).clamp(0, H - 2)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    x0, y0 = x0.long(), y0.long()
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _gather2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor
              ) -> torch.Tensor:
    """``img[yi, xi]`` with the reference's gather rule: negative
    indices wrap once, then indices are clamped into range."""
    H, W = img.shape
    yi = torch.where(yi < 0, yi + H, yi).clamp(0, H - 1)
    xi = torch.where(xi < 0, xi + W, xi).clamp(0, W - 1)
    return img[yi, xi]


def select_keypoints(score: torch.Tensor, max_kps: int = 512,
                     border: int = PATCH_R + 1,
                     raw_score: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Top-K maxima -> (uv (K,2), score (K,), valid (K,), count).

    Two-stage selection as the reference: chunk-local top-64 over chunks
    of 2048 pixels, then a global top-K of the candidates, so the result
    is identical even where a chunk holds more than 64 maxima.  With
    ``raw_score`` the maxima are refined to subpixel by a 1-D quadratic
    fit per axis.
    """
    H, W = score.shape
    dev = score.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ok = ((ys >= border) & (ys < H - border)
          & (xs >= border) & (xs < W - border))
    s = torch.where(ok, score, score.new_zeros(())).reshape(-1)
    n = s.shape[0]
    pad = (-n) % _CHUNK
    sp = F.pad(s, (0, pad)).reshape(-1, _CHUNK)
    cv, ci = _topk_stable(sp, min(_K_CHUNK, max_kps))
    base = (torch.arange(sp.shape[0], device=dev) * _CHUNK)[:, None]
    cand_idx = (ci + base).reshape(-1)
    val, sel = _topk_stable(cv.reshape(-1), max_kps)
    idx = cand_idx[sel]
    yi = idx // W
    xi = idx % W
    y = yi.to(torch.float32)
    x = xi.to(torch.float32)
    if raw_score is not None:
        r = raw_score

        def parab(cm, c0, cp):
            denom = cm - 2.0 * c0 + cp
            off = 0.5 * (cm - cp) / torch.where(
                denom.abs() < 1e-9, denom.new_full((), 1e-9), denom)
            return off.clamp(-0.5, 0.5)

        c0 = _gather2d(r, yi, xi)
        x = x + parab(_gather2d(r, yi, xi - 1), c0, _gather2d(r, yi, xi + 1))
        y = y + parab(_gather2d(r, yi - 1, xi), c0, _gather2d(r, yi + 1, xi))
    valid = val > 0
    uv = torch.stack([x, y], -1)
    return uv, val, valid, valid.sum().to(torch.int32)


# ---------------------------------------------------------------------------
# orientation (intensity centroid over a square patch, separable)


def orientation_map(img: torch.Tensor, radius: int = PATCH_R
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image centroid moments (m10, m01) over a square patch, as two
    separable 31-tap filters each."""
    r = radius
    ramp = np.arange(-r, r + 1, dtype=np.float32)
    ones = np.ones((2 * r + 1,), np.float32)
    return _sep_filter(img, ramp, ones), _sep_filter(img, ones, ramp)


def centroid_moments(img: torch.Tensor, uv: torch.Tensor,
                     radius: int = PATCH_R) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(m01, m10) (K,) at the keypoints: :func:`orientation_map` read at
    ``uv`` truncated toward zero, by the reference's gather rule.  The
    plain version of the orientation kernel."""
    m10, m01 = orientation_map(img, radius=radius)
    xi = uv[:, 0].to(torch.int32).long()
    yi = uv[:, 1].to(torch.int32).long()
    return _gather2d(m01, yi, xi), _gather2d(m10, yi, xi)


def compute_orientations(img: torch.Tensor, uv: torch.Tensor,
                         radius: int = PATCH_R) -> torch.Tensor:
    """Per-keypoint patch orientation (K,) radians."""
    return torch.atan2(*centroid_moments(img, uv, radius=radius))


# ---------------------------------------------------------------------------
# rotated BRIEF


def brief_pattern(bits: int = BRIEF_BITS, radius: int = PATCH_R,
                  seed: int = 42) -> np.ndarray:
    """(bits, 4) sampling pairs [x1, y1, x2, y2], Gaussian(0, r/5)^2
    clipped to the patch, from a fixed seed (the reference's pattern,
    bit for bit)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, radius / 5.0, size=(bits, 4))
    return np.clip(p, -(radius - 2), radius - 2).astype(np.float32)


_PATTERN = brief_pattern()
_PATTERNS: Dict[torch.device, torch.Tensor] = {}


def pattern_on(device: torch.device) -> torch.Tensor:
    """The (256, 4) pattern as a float32 tensor on ``device``, copied
    there once (a copy per call would wait for the card)."""
    pat = _PATTERNS.get(device)
    if pat is None:
        pat = _PATTERNS[device] = torch.as_tensor(_PATTERN, device=device)
    return pat


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 32*DESC_WORDS) bool -> (K, DESC_WORDS) int32 words, bit j of
    word w = bits[32w + j].  Packed in int64 and masked to 32 bits, so
    bit 31 lands as the int32 sign bit."""
    K = bits.shape[0]
    w = bits.reshape(K, DESC_WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = torch.sum(w << shifts, dim=-1) & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def brief_from_rotation(img_blur: torch.Tensor, uv: torch.Tensor,
                        ca: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF given cos/sin of the keypoint angles: the plain
    version of the BRIEF kernel.  Endpoints are
    ``round(c + (px*ca - py*sa))`` (round half to even), clamped into
    the image, sampled nearest; bit = a < b."""
    pat = pattern_on(img_blur.device)
    x1 = pat[None, :, 0] * ca[:, None] - pat[None, :, 1] * sa[:, None]
    y1 = pat[None, :, 0] * sa[:, None] + pat[None, :, 1] * ca[:, None]
    x2 = pat[None, :, 2] * ca[:, None] - pat[None, :, 3] * sa[:, None]
    y2 = pat[None, :, 2] * sa[:, None] + pat[None, :, 3] * ca[:, None]
    cx = uv[:, 0:1]
    cy = uv[:, 1:2]
    xs = torch.cat([cx + x1, cx + x2], dim=1)       # (K, 2B)
    ys = torch.cat([cy + y1, cy + y2], dim=1)
    H, W = img_blur.shape
    xi = torch.round(xs).to(torch.int32).clamp(0, W - 1).long()
    yi = torch.round(ys).to(torch.int32).clamp(0, H - 1).long()
    s = img_blur.reshape(-1)[yi * W + xi]
    B = pat.shape[0]
    return pack_bits(s[:, :B] < s[:, B:])


def brief_descriptors(img_blur: torch.Tensor, uv: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF from the blurred image -> (K, DESC_WORDS) int32."""
    return brief_from_rotation(img_blur, uv, torch.cos(angle),
                               torch.sin(angle))


# ---------------------------------------------------------------------------
# full extraction


def extract_features(img: torch.Tensor, max_kps: int = 512,
                     threshold: float = 0.06,
                     use_kernels: bool = True) -> Features:
    """Single-scale ORB-style extraction of one (H, W) float32 image.

    detect (FAST + NMS) -> select top-K -> orient (centroid) -> describe
    (rotated BRIEF on the blurred image).  ``use_kernels`` routes the
    detector, the centroid moments and the BRIEF sampler through the
    CUDA kernels (on CPU tensors those wrappers take the plain
    versions); False runs the plain PyTorch versions on any device.
    """
    if use_kernels:
        from gslam_tpu_torch.ops.cuda.fastnms import fast_nms_raw

        score, raw = fast_nms_raw(img, threshold=threshold)
    else:
        raw = fast_score(img, threshold)
        score = nms(raw)
    uv, val, valid, count = select_keypoints(score, max_kps=max_kps,
                                             raw_score=raw)
    if use_kernels:
        from gslam_tpu_torch.ops.cuda import orient

        angle = torch.atan2(*orient.centroid_moments(img, uv))
    else:
        angle = compute_orientations(img, uv)
    blur = gaussian_blur(img, sigma=2.0)
    if use_kernels:
        from gslam_tpu_torch.ops.cuda.brief import brief

        desc = brief(blur, uv, torch.cos(angle), torch.sin(angle))
    else:
        desc = brief_descriptors(blur, uv, angle)
    desc = torch.where(valid[:, None], desc, desc.new_zeros(()))
    return Features(uv=uv, score=val,
                    angle=torch.where(valid, angle, angle.new_zeros(())),
                    desc=desc, valid=valid, count=count)


def pyramid_budgets(shapes, max_kps: int) -> np.ndarray:
    """Keypoints per level in proportion to level area (at least 8),
    rounded, with level 0 taking the rounding so they sum to max_kps."""
    areas = np.asarray([h * w for h, w in shapes], np.float64)
    ks = np.maximum(8, np.round(max_kps * areas / areas.sum()).astype(int))
    ks[0] += max_kps - int(ks.sum())
    return ks


def pyramid_levels(shapes, max_kps: int) -> np.ndarray:
    """(max_kps,) int64: the pyramid level of each keypoint slot of
    :func:`extract_features_pyramid`, whose levels fill their
    :func:`pyramid_budgets` slots in level order."""
    ks = pyramid_budgets(shapes, max_kps)
    return np.repeat(np.arange(len(ks), dtype=np.int64), ks)


def extract_features_pyramid(img: torch.Tensor, max_kps: int = 512,
                             threshold: float = 0.06, n_levels: int = 4,
                             scale: float = 1.25,
                             use_kernels: bool = True) -> Features:
    """Multi-scale ORB-style extraction over :func:`image_pyramid`.

    Each level gets its budget of :func:`pyramid_budgets` and runs
    :func:`extract_features` at level resolution (B1, the orientation
    kernel and B2 once per level with ``use_kernels``); uv are mapped
    back to level-0 pixels and the levels concatenated in order, so the
    set holds ``max_kps`` slots and ``count`` is the sum of the levels'
    counts."""
    pyr = image_pyramid(img, n_levels=n_levels, scale=scale)
    ks = pyramid_budgets([lvl.shape for lvl in pyr], max_kps)
    parts = []
    for lev, lvl in enumerate(pyr):
        f = extract_features(lvl, max_kps=int(ks[lev]), threshold=threshold,
                             use_kernels=use_kernels)
        parts.append(f._replace(uv=f.uv * float(np.float32(scale ** lev))))
    return Features(*(torch.cat([getattr(p, k) for p in parts])
                      for k in Features._fields[:-1]),
                    count=torch.stack([p.count for p in parts]).sum()
                    .to(torch.int32))
