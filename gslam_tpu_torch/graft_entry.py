"""Entry points of the port: the single-card step and the multi-rank
dry run.

Counterpart of the repository's ``__graft_entry__.py`` (the JAX
package's).  :func:`entry` hands back the flagship per-frame step and its
example arguments on the card; :func:`dryrun_multichip` runs the
reference dry run's three phases over a world of ``n`` ranks
(:func:`gslam_tpu_torch.parallel.launch.spawn`, one process a rank):

1. one distributed Schur BA step from a perturbed start, the psum
   variant on a (n // 2, 2) mesh for even n > 2 and (n, 1) otherwise,
   and the ring variant (B5's partials entry and B6) on (n, 1): each
   cost history must fall below half its start; then the psum
   variant's LM iterations a second by the iteration-count delta,
   widened until the delta is a fifth of the longer run;
2. ``sharded_track_batch`` of 2n frames over a 'dp' mesh;
3. the fleet: two synthetic sequences tracked by ``KeyframeSLAM`` (in
   this process), their maps merged 50 m apart, one distributed global
   BA over the merged map on the mesh, the keyframe ATE under 0.5 m.

The ranks run on ``device``: with a card for each rank, NCCL; with
fewer cards than ranks, gloo with every rank on ``cuda:0`` (each
collective through the host), which the printed line says; with
``device="cpu"``, gloo on the CPU.  There is no fallback to virtual
devices: a missing card raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

FLEET_CFG = dict(max_kps=160, fast_threshold=0.1, ba_window=3,
                 ba_points=192, ba_iters=2, cap_frames=16, cap_points=1024,
                 cap_obs=4096, local_map_size=256, kf_max_gap=4)
FLEET_ALIGN = [50.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
FLEET_SEEDS = (3, 11)
TRACK = dict(H=64, W=128, M=256, max_kps=64, ransac_b=32)


def entry():
    """(fn, example_args): the fused tracking step ``track_forward``
    (extract with B1 / B2, B3 matching, P3P RANSAC, GN refine) and
    ``example_inputs()`` on the card: (image, cam, map_xyz, map_desc,
    map_valid, generator); call ``fn(*args[:5], generator=args[5])``."""
    from gslam_tpu_torch.models.graft import example_inputs, track_forward

    return track_forward, example_inputs(device="cuda")


def mesh_shape(n: int):
    """The reference's mesh: landmarks x observation slots when n is
    even and above 2, landmarks alone otherwise."""
    return (n // 2, 2) if n % 2 == 0 and n > 2 else (n, 1)


def ba_problem(shape, device):
    """The reference dry run's BA problem (C = 4, P = 4 n_pt, O = 2
    n_obs; observations from the true geometry, landmarks perturbed by
    2 cm), drawn in the same order."""
    from gslam_tpu_torch.opt.ba import BundleProblem

    rng = np.random.default_rng(0)
    C, P, O = 4, 4 * max(shape[0], 1), 2 * shape[1]
    X = np.stack([rng.uniform(-1, 1, P), rng.uniform(-1, 1, P),
                  rng.uniform(4, 8, P)], -1).astype(np.float32)
    poses = np.tile(np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32), (C, 1))
    poses[:, 0] = 0.3 * np.arange(C)
    obs_cam = rng.integers(0, C, (P, O)).astype(np.int32)
    pc = X[:, None] + poses[obs_cam][..., :3]
    uv = (pc[..., :2] / pc[..., 2:3]).astype(np.float32)
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    xyz = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    fields = (poses, cam_fixed, xyz, np.zeros(P, bool), obs_cam, uv,
              np.ones((P, O), bool), np.ones((P, O), np.float32))
    return BundleProblem(*(torch.as_tensor(x, device=device)
                           for x in fields))


def _run_fleet_sequence(seed: int, device):
    from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
    from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig

    ds = SyntheticDataset(n_frames=12, n_points=250, width=160, height=120,
                          motion="line", depth=True, seed=seed)
    ds.open("synth://")
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**FLEET_CFG), device=device)
    gts = []
    for fr in ds:
        slam.track(fr)
        gts.append((fr.timestamp, fr.gt_pose[:3]))
    return slam, ds.camera, gts


def _dryrun_rank(rank, world, job):
    """One rank of the dry run (``launch.spawn``): phases 1-3's
    collective parts on ``job["device"]``."""
    import torch.distributed as dist

    from gslam_tpu_torch.map.arena import arena_from_numpy
    from gslam_tpu_torch.opt.ba import global_bundle_adjust
    from gslam_tpu_torch.parallel import (
        distributed_bundle_adjust, distributed_bundle_adjust_ring,
        make_dp_mesh, make_mesh, sharded_track_batch,
    )
    from gslam_tpu_torch.parallel.dist_ba import all_reduce_sum

    dev = torch.device(job["device"])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    shape = mesh_shape(world)
    mesh = make_mesh(shape, device=dev)
    problem = ba_problem(shape, dev)
    _, costs = distributed_bundle_adjust(problem, mesh, iters=2)
    ring_mesh = make_mesh((world, 1), device=dev)
    _, ring_costs = distributed_bundle_adjust_ring(problem, ring_mesh,
                                                   iters=2, use_kernels=True)

    def t_of(iters: int) -> float:
        """Best of three psum runs, averaged over the ranks (so that
        every rank takes the same widening decision)."""
        distributed_bundle_adjust(problem, mesh, iters=iters)
        sync()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            distributed_bundle_adjust(problem, mesh, iters=iters)
            sync()
            best = min(best, time.perf_counter() - t0)
        mean = all_reduce_sum(torch.tensor([best], dtype=torch.float64,
                                           device=dev))
        return float(mean) / world

    lo, hi = 20, 260
    t_lo, t_hi = t_of(lo), t_of(hi)
    while t_hi - t_lo < 0.2 * t_hi and hi < 4000:
        lo, hi = hi, hi * 4
        t_lo, t_hi = t_hi, t_of(hi)
    delta = t_hi - t_lo
    rate = (hi - lo) / delta if delta > 0 else float("nan")

    t = job["track"]
    poses, n_inl, _ = sharded_track_batch(
        make_dp_mesh(device=dev),
        *(torch.as_tensor(x, device=dev) for x in t["args"]),
        max_kps=TRACK["max_kps"], ransac_b=TRACK["ransac_b"])

    merged = arena_from_numpy(job["merged"], device=dev)
    out_m, costs_m = global_bundle_adjust(
        merged, job["camera"], iters=3, max_cams=16, max_points=1024,
        max_obs_per_point=8, mesh=mesh)
    sync()
    n = job["n_frames"]
    return dict(costs=costs.cpu(), ring_costs=ring_costs.cpu(),
                rate=rate, rate_span=(lo, hi), poses=poses.cpu(),
                n_inliers=n_inl.cpu(), gba_costs=costs_m.cpu(),
                frame_pose=out_m.frame_pose[:n].cpu(),
                backend=dist.get_backend())


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run over ``n_devices`` ranks on ``device`` (module
    docstring); print one line and return its figures."""
    from gslam_tpu_torch.core.camera import Camera
    from gslam_tpu_torch.core.se3 import se3_inverse
    from gslam_tpu_torch.map.arena import arena_to_numpy, merge_arenas
    from gslam_tpu_torch.models.graft import example_inputs
    from gslam_tpu_torch.parallel import launch
    from gslam_tpu_torch.utils.platform import require_device

    dev = require_device(device)
    n = int(n_devices)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        backend, placement = "gloo", f"gloo, {n} ranks on cuda:0"
    else:
        backend = launch.default_backend(dev)
        placement = (f"{backend}, a rank a card" if dev.type == "cuda"
                     else f"{backend} on the CPU")

    # phase 2's inputs: 2n frames of the small example, their draws
    img, cam, xyz, desc, valid, _ = example_inputs(
        H=TRACK["H"], W=TRACK["W"], M=TRACK["M"], max_kps=TRACK["max_kps"],
        device=dev)
    B = 2 * n
    images = torch.stack([img + 1e-4 * i for i in range(B)])
    uniforms = torch.rand((B, TRACK["ransac_b"], 4),
                          generator=torch.Generator().manual_seed(0))
    # phase 3's sequences, tracked here; the ranks adjust the merged map
    (s1, cam_f, gt1), (s2, _, gt2) = (_run_fleet_sequence(s, dev)
                                      for s in FLEET_SEEDS)
    merged = merge_arenas(s1.arena, s2.arena,
                          transform_b=torch.tensor(FLEET_ALIGN, device=dev))
    n1, n2 = s1._n_frames_host, s2._n_frames_host
    job = dict(device=str(dev), merged=arena_to_numpy(merged),
               camera=Camera(cam_f.model, cam_f.width, cam_f.height,
                             cam_f.params),
               n_frames=n1 + n2,
               track=dict(args=[x.cpu().numpy() for x in (
                   images, cam, xyz, desc, valid, uniforms)]))
    res = launch.spawn(_dryrun_rank, n, device=dev, backend=backend,
                       args=(job,), timeout_s=600.0)
    r = res[0]
    for other in res[1:]:
        for k in ("costs", "ring_costs", "poses", "gba_costs", "frame_pose"):
            if not torch.equal(other[k], r[k]):
                raise AssertionError(f"dry run: ranks differ in {k}")
    for name in ("costs", "ring_costs"):
        c = r[name].numpy()
        if not (np.isfinite(c).all() and c[-1] < 0.5 * c[0]):
            raise AssertionError(f"distributed BA ({name}) must reduce the "
                                 f"perturbed cost: {c}")
    poses = r["poses"].numpy()
    if poses.shape != (B, 7) or not np.isfinite(poses).all():
        raise AssertionError(f"sharded tracking: poses {poses.shape}")
    costs_m = r["gba_costs"].numpy()
    if not np.isfinite(costs_m).all() or costs_m[-1] > costs_m[0] * 1.05:
        raise AssertionError(f"merged-map distributed BA diverged: "
                             f"{costs_m}")
    # keyframe ATE of the merged, adjusted map: each keyframe's centre
    # against the ground truth nearest its stamp (sequence 2's moved by
    # the alignment)
    ctr = se3_inverse(r["frame_pose"][:, :7])[:, :3].numpy()
    tm = merged.frame_time[:n1 + n2].cpu().numpy()
    errs = []
    for k in range(n1 + n2):
        gts = gt1 if k < n1 else gt2
        off = np.zeros(3) if k < n1 else np.asarray(FLEET_ALIGN[:3])
        ts = np.asarray([t for t, _ in gts])
        j = int(np.abs(ts - tm[k]).argmin())
        errs.append(ctr[k] - (gts[j][1] + off))
    ate = float(np.sqrt((np.stack(errs) ** 2).sum(1).mean()))
    if not ate < 0.5:
        raise AssertionError(f"fleet merged-map keyframe ATE {ate}")
    out = dict(world=n, device=str(dev), placement=placement,
               backend=r["backend"], mesh=mesh_shape(n),
               costs=r["costs"].tolist(), ring_costs=r["ring_costs"].tolist(),
               dist_ba_iters_per_s=r["rate"], rate_span=r["rate_span"],
               track_frames=B, inliers_min=int(r["n_inliers"].min()),
               fleet_keyframes=[n1, n2], gba_costs=costs_m.tolist(),
               kf_ate_m=ate)
    print(f"dryrun_multichip OK ({placement}): mesh={out['mesh']} "
          f"costs={out['costs'][:3]} (decreasing from perturbed init) "
          f"ring_costs={out['ring_costs'][:3]} "
          f"dist_ba_iters_per_s={r['rate']:.1f} "
          f"dp_track B={B} inl_min={out['inliers_min']} "
          f"fleet: merge({n1}+{n2} KFs) -> dist-GBA "
          f"costs={out['gba_costs']} kf_ate={ate:.4f} m", flush=True)
    return out
