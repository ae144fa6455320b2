"""The benchmark's synthetic world, rendered on the card in PyTorch.

A copy of the program's host-numpy ``SyntheticDataset`` for the two
motions the cells use ("ring_out" round a textured cylinder, "line" past
a textured plane): value-noise texture quantised below the FAST
threshold, square dots that carry the trackable corners, exact depth at
every pixel, and the right view of a stereo rig.  The copy renders every
frame of an episode in a few large calls on ``device`` and takes the
sensor's published intrinsics in place of a field of view.

The world (points, intensities, texture grid) comes from the
configuration's ``scene_seed`` and is the same in every run, as one
recorded place is; ``seed`` draws only the sensor: each pixel's noise and
the phase of the exposure drift.  The camera path is
:func:`slambench.reference.camera_to_world`, the reference's own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from slambench.reference import camera_to_world

N_GRID = 64          # value-noise grid
OCTAVES = 3
FRAME_CHUNK = 32     # frames rendered together


@dataclass
class Episode:
    """One episode's frames on the host (float32, what a camera hands the
    program) and its true camera-to-world poses (float64)."""

    images: np.ndarray                    # (n, H, W) in [0, 1]
    depths: Optional[np.ndarray]          # (n, H, W) metres, or None
    rights: Optional[np.ndarray]          # (n, H, W) right view, or None
    R_wc: np.ndarray                      # (n, 3, 3)
    t_wc: np.ndarray                      # (n, 3)


class World:
    """The dots, backdrop and texture of ``scene`` (a configuration's
    ``scene`` table) seen through ``sensor`` (its ``sensor`` table)."""

    def __init__(self, scene: dict, sensor: dict, device="cuda"):
        self.scene, self.sensor = scene, sensor
        self.device = torch.device(device)
        dev = self.device
        g = torch.Generator(device=dev)
        g.manual_seed(int(scene["scene_seed"]))

        def uni(lo, hi, n):
            return lo + (hi - lo) * torch.rand(n, generator=g, device=dev,
                                               dtype=torch.float64)

        e, n, m = scene["world_extent"], scene["n_points"], scene["n_texture"]
        if scene["motion"] == "line":
            # laid along the path: ``lap_frames`` frames of ``step`` metres
            run = scene["step"] * scene["lap_frames"]
            x, y = uni(-e * 0.5, e * 2.0 + run, n), uni(-e * 0.6, e * 0.6, n)
            z = e + 0.25 * e * torch.sin(1.5 * x / e) * torch.cos(2.0 * y / e)
            bx, by = uni(-e, e * 3.0 + run, m), uni(-e * 1.2, e * 1.2, m)
            bg = torch.stack([bx, by, torch.full_like(bx, 1.35 * e)], -1)
        else:
            x, y = uni(-e, e, n), uni(-e * 0.6, e * 0.6, n)
            z = 0.25 * e * torch.sin(2.0 * x / e) * torch.cos(1.5 * y / e)
            r_cyl = 1.8 * scene["radius"]
            th, by = uni(0, 2 * np.pi, m), uni(-e * 1.2, e * 1.2, m)
            bg = torch.stack([r_cyl * torch.sin(th), by,
                              r_cyl * torch.cos(th)], -1)
        self.X = torch.cat([torch.stack([x, y, z], -1), bg])     # (n + m, 3)
        self.I = torch.cat([uni(0.55, 1.0, n), uni(0.45, 1.0, m)]).float()
        self.grid = uni(0.0, 1.0, N_GRID * N_GRID).reshape(N_GRID, N_GRID)
        W, H = sensor["width"], sensor["height"]
        u = torch.arange(W, device=dev, dtype=torch.float64) + 0.5
        v = torch.arange(H, device=dev, dtype=torch.float64) + 0.5
        # pixel-centre rays at z = 1 of the pinhole camera
        self.rays = torch.stack(torch.broadcast_tensors(
            ((u - sensor["cx"]) / sensor["fx"])[None, :],
            ((v - sensor["cy"]) / sensor["fy"])[:, None],
            torch.ones((H, W), device=dev, dtype=torch.float64)), -1)

    # ------------------------------------------------------------------
    def poses(self, n: int):
        """(R_wc (n, 3, 3), t_wc (n, 3)) float64 of an ``n``-frame
        episode."""
        sc = self.scene
        Rt = [camera_to_world(sc, i) for i in range(n)]
        return np.stack([r for r, _ in Rt]), np.stack([t for _, t in Rt])

    def episode(self, n: int, seed: int) -> Episode:
        """The ``n`` frames of an episode under the sensor draws of
        ``seed``, rendered on the device and copied to the host once."""
        sc, se = self.scene, self.sensor
        dev = self.device
        R_wc, t_wc = self.poses(n)
        R = torch.from_numpy(R_wc).to(dev)
        t = torch.from_numpy(t_wc).to(dev)
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        phase = float(torch.rand((), generator=g, device=dev)) * 2 * np.pi
        gain = 1.0 + sc["exposure"] * torch.sin(
            2 * np.pi * 3.0 * torch.arange(n, device=dev) / n + phase)
        want_depth = bool(sc["depth"])
        imgs, deps, rights = [], [], []
        for a in range(0, n, FRAME_CHUNK):
            b = min(n, a + FRAME_CHUNK)
            img, dep = self._render(R[a:b], t[a:b], want_depth)
            imgs.append(self._sensor(img, gain[a:b], g))
            if want_depth:
                q = se.get("depth_scale")
                deps.append(dep if not q else torch.round(dep * q) / q)
            if sc["stereo"]:
                off = R[a:b] @ torch.tensor([se["baseline"], 0.0, 0.0],
                                            device=dev, dtype=torch.float64)
                right, _ = self._render(R[a:b], t[a:b] + off, False)
                rights.append(self._sensor(right, gain[a:b], g))

        def host(parts):
            return torch.cat(parts).cpu().numpy() if parts else None
        return Episode(host(imgs), host(deps), host(rights), R_wc, t_wc)

    # ------------------------------------------------------------------
    def _sensor(self, img, gain, g):
        """Noise then exposure gain, clipped to [0, 1], as float32."""
        noise = self.scene["noise"]
        if noise > 0:
            img = (img + noise * torch.randn(img.shape, generator=g,
                                             device=img.device)).clamp(0, 1)
        return (img * gain[:, None, None].float()).clamp(0, 1).float()

    def _texture(self, u, v):
        """Bilinear value noise at (u, v) in texture units, 3 octaves."""
        n = N_GRID
        out = torch.zeros_like(u, dtype=torch.float32)
        amp, tot = 1.0, 0.0
        for o in range(OCTAVES):
            s = 2.0 ** o
            x, y = torch.remainder(u * s, n), torch.remainder(v * s, n)
            x0 = torch.remainder(torch.floor(x), n).long()
            y0 = torch.remainder(torch.floor(y), n).long()
            x1, y1 = (x0 + 1) % n, (y0 + 1) % n
            fx = (x - torch.floor(x)).float()
            fy = (y - torch.floor(y)).float()
            g = self.grid
            val = (g[y0, x0] * (1 - fx) * (1 - fy) + g[y0, x1] * fx * (1 - fy)
                   + g[y1, x0] * (1 - fx) * fy + g[y1, x1] * fx * fy)
            out += amp * val.float()
            tot += amp
            amp *= 0.5
        return out / tot

    def _render(self, R_wc, t_wc, want_depth: bool):
        """Noise-free views (F, H, W) from F poses, and their depth."""
        sc, se = self.scene, self.sensor
        H, W = se["height"], se["width"]
        F = R_wc.shape[0]
        e = sc["world_extent"]
        # textured backdrop: the ray through each pixel centre
        d_w = torch.einsum("hwk,fjk->fhwj", self.rays, R_wc)
        o = t_wc[:, None, None, :]
        if sc["motion"] == "line":
            dz = d_w[..., 2]
            s = (1.35 * e - o[..., 2]) / torch.where(dz.abs() < 1e-6,
                                                    torch.full_like(dz, 1e-6),
                                                    dz)
            Xw = o + s[..., None] * d_w
            tu, tv = Xw[..., 0] * 2.0, Xw[..., 1] * 2.0
        else:
            r_cyl = 1.8 * sc["radius"]
            dx, dz = d_w[..., 0], d_w[..., 2]
            ox, oz = o[..., 0], o[..., 2]
            a = dx * dx + dz * dz
            b = 2.0 * (ox * dx + oz * dz)
            cc = ox * ox + oz * oz - r_cyl * r_cyl
            disc = (b * b - 4 * a * cc).clamp_min(0.0)
            s = (-b + torch.sqrt(disc)) / (2 * a).clamp_min(1e-9)
            Xw = o + s[..., None] * d_w
            tu = torch.atan2(Xw[..., 0], Xw[..., 2]) * r_cyl * 2.0
            tv = Xw[..., 1] * 2.0
        hit = s > 0.5
        tex = torch.floor(self._texture(tu, tv) * 5.0) / 4.0
        img = torch.where(hit, 0.08 + 0.18 * tex,
                          torch.full_like(tex, 0.08)).float()
        depth = torch.where(hit, s, torch.zeros_like(s)).float() \
            if want_depth else None
        # dots: a (2r+1)^2 square each; a later dot covers an earlier one
        R_cw = R_wc.transpose(1, 2)
        pc = torch.einsum("fij,nj->fni", R_cw, self.X) \
            - torch.einsum("fij,fj->fi", R_cw, t_wc)[:, None, :]
        z = pc[..., 2]
        zs = z.clamp_min(1e-6)
        u = se["fx"] * pc[..., 0] / zs + se["cx"]
        v = se["fy"] * pc[..., 1] / zs + se["cy"]
        ui, vi = torch.round(u).long(), torch.round(v).long()
        r = sc["dot_half"]
        ok = (z > 0.5) & (ui >= r + 1) & (ui < W - r - 1) & (vi >= r + 1) \
            & (vi < H - r - 1)
        N = self.X.shape[0]
        j = torch.arange(N, device=self.device).expand(F, N)
        base = torch.arange(F, device=self.device)[:, None] * (H * W)
        owner = torch.full((F * H * W,), -1, dtype=torch.long,
                           device=self.device)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                pix = base + (vi + dy) * W + (ui + dx)
                owner.scatter_reduce_(0, pix[ok], j[ok], "amax")
        has = owner >= 0
        who = owner.clamp_min(0)
        img = torch.where(has, self.I[who], img.reshape(-1)).reshape(F, H, W)
        if want_depth:
            frame = torch.arange(F * H * W, device=self.device) // (H * W)
            zd = z.float().reshape(-1)[frame * N + who]
            depth = torch.where(has, zd, depth.reshape(-1)).reshape(F, H, W)
        return img, depth
