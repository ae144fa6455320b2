"""B1, FAST-9 score and 3 x 3 NMS (``gslam_tpu_torch/csrc/fastnms.cu``).

One launch reads the image once and writes the raw and suppressed score
maps once (4 bytes a pixel each).  Per pixel: 16 circle differences, 32
compares, 22 mask operations and the NMS (9 maxima, 1 compare); per arc
start that qualifies on the image, 9 subtractions, 9 sums and one
maximum.  The arc starts are counted on a sample of the frames the run
handed the program (every B1 launch of a cell is on one of its frames,
left or right), with the circle and threshold the program uses.
"""

from __future__ import annotations

import torch

KERNELS = ("fast_nms_kernel",)
ARC = 9
SAMPLE = 8       # frames of the episode whose arc starts are counted
# the Bresenham circle of radius 3, (dx, dy)
CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
          (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
          (-1, 3))


def arc_starts(img: torch.Tensor, threshold: float) -> int:
    """Arc starts of ``ARC`` contiguous circle pixels all brighter or all
    darker by ``threshold``, inside the 3-pixel border."""
    H, W = img.shape
    d = torch.stack([torch.roll(img, (-dy, -dx), (0, 1))
                     for dx, dy in CIRCLE]) - img
    starts = 0
    for m in (d > threshold, d < -threshold):
        ext = torch.cat([m, m[:ARC]])
        for s in range(16):
            starts += int(ext[s:s + ARC].all(0)[3:H - 3, 3:W - 3].sum())
    return starts


def ops(img: torch.Tensor, threshold: float) -> int:
    H, W = img.shape
    return H * W * (16 + 32 + 22 + 10) + arc_starts(img, threshold) * (
        2 * ARC + 1)


def work(run):
    """(bytes, operations) of a launch on each frame of the sample."""
    imgs = [im for im in (run.episode.images, run.episode.rights)
            if im is not None]
    n = imgs[0].shape[0]
    idx = sorted({round(i * (n - 1) / max(SAMPLE - 1, 1))
                  for i in range(SAMPLE)})
    thr = run.config["slam"]["fast_threshold"]
    H, W = imgs[0].shape[1:]
    return [(3 * 4 * H * W, ops(torch.as_tensor(im[i], device=run.device),
                                thr))
            for im in imgs for i in idx]
