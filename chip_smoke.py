"""Smoke run of gslam_tpu_torch on one NVIDIA card: build, check, time.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. print the card's name and power limit; build the three CUDA kernels
   (``gslam_tpu_torch/csrc/*.cu``, one ``nvcc`` each, in parallel) and
   print the build time and each kernel's register / shared-memory use;
2. hold each kernel against its plain PyTorch version on the card, at
   the shapes the tracking step gives it (480 x 640 image, K = 512
   keypoints, a 2048-entry map slab): FAST+NMS allclose at 1e-5 with the
   same NMS support, BRIEF bit-equal on valid keypoints, the matcher
   with equal best / second / idx / back;
3. drive the tracking step ``track_forward`` once through the kernels
   (launch counters set to 0 just before, read just after), check that
   it recovers the example's identity pose and enough inliers, and that
   the plain path on the card agrees with it;
4. time the step (ms/frame, frames/s, a split by stage, the device busy
   share from torch.profiler) and each kernel beside its plain version
   (device time: CUDA events around replays of a CUDA graph of many
   calls, after warm-up);
5. print the ``kernels`` JSON line, then the device JSON as the last
   line.

Needs a CUDA card and ``nvcc``; without a card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from gslam_tpu_torch.core.camera import pinhole_unproject
from gslam_tpu_torch.estimation.pnp import (
    _p3p_grunert, pnp_reproj_error, refine_pose_gn,
)
from gslam_tpu_torch.estimation.ransac import run_ransac
from gslam_tpu_torch.models.graft import example_inputs, track_forward
from gslam_tpu_torch.ops import frontend
from gslam_tpu_torch.ops.cuda import brief, build, fastnms, matcher
from gslam_tpu_torch.ops.matching import hamming_top2, match_descriptors
from gslam_tpu_torch.utils.platform import card_name_and_power_limit

H, W, M, K, B = 480, 640, 2048, 512, 256
DEVICE = "cuda"
THRESH = 0.06
PNP_THRESH = 2e-5

# peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # outside the tensor cores

KERNELS = {
    "fast_nms": dict(source="gslam_tpu_torch/csrc/fastnms.cu",
                     replaces="gslam_tpu/ops/pallas/fastnms.py:108"),
    "brief": dict(source="gslam_tpu_torch/csrc/brief.cu",
                  replaces="gslam_tpu/ops/pallas/brief.py:148"),
    "matcher": dict(source="gslam_tpu_torch/csrc/matcher.cu",
                    replaces="gslam_tpu/ops/pallas/matcher.py:66"),
}
MODULES = {"fast_nms": fastnms, "brief": brief, "matcher": matcher}


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 100, warm: int = 5) -> float:
    """Mean device time of ``fn()`` in ms: CUDA events around ``reps``
    back-to-back calls, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 50, replays: int = 5) -> float:
    """Mean device time of ``fn()`` in ms with the host taken out:
    ``reps`` calls captured in one CUDA graph, replayed ``replays``
    times between CUDA events."""
    fn()                                 # build and cache what fn needs
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(n_bytes: float, n_ops: float):
    """(bound in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the float32 rate."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def reset_counts() -> None:
    for mod in MODULES.values():
        mod.launches = 0


def counts():
    return {name: mod.launches for name, mod in MODULES.items()}


# ---------------------------------------------------------------------------
# phases


def phase_build():
    log("card:", card_name_and_power_limit())
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{len(build.SOURCES)} kernels")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")


def phase_check(inputs):
    """Each kernel against its plain version at the main-path shapes.
    Returns per-kernel records (max_abs_err, inputs for timing)."""
    img, cam, xyz, desc, valid, _ = inputs
    rec = {}

    # B1: FAST + NMS on the example frame
    nms_k, raw_k = fastnms.fast_nms_raw(img, THRESH)
    nms_p, raw_p = fastnms.fast_nms_plain(img, THRESH)
    torch.cuda.synchronize()
    err = max((raw_k - raw_p).abs().max().item(),
              (nms_k - nms_p).abs().max().item())
    same_support = torch.equal(nms_k > 0, nms_p > 0)
    log(f"B1 fast_nms: max_abs_err {err:.3g}, nms support equal "
        f"{same_support}, corners {(nms_k > 0).sum().item()}")
    if not (err <= 1e-5 and same_support):
        raise AssertionError("FAST+NMS kernel disagrees with plain version")
    rec["fast_nms"] = dict(max_abs_err=err)

    # B2: BRIEF on that frame's K keypoints (plain detector path)
    uv, _, kvalid, _ = frontend.select_keypoints(nms_p, max_kps=K,
                                                 raw_score=raw_p)
    angle = frontend.compute_orientations(img, uv)
    blur = frontend.gaussian_blur(img, sigma=2.0)
    ca, sa = torch.cos(angle), torch.sin(angle)
    d_k = brief.brief(blur, uv, ca, sa)
    d_p = frontend.brief_from_rotation(blur, uv, ca, sa)
    torch.cuda.synchronize()
    bad_words = (d_k != d_p)[kvalid].sum().item()
    bit_err = 0.0 if bad_words == 0 else 1.0
    log(f"B2 brief: {int(kvalid.sum())} valid keypoints, "
        f"{bad_words} differing words")
    if bad_words:
        raise AssertionError("BRIEF kernel is not bit-equal")
    rec["brief"] = dict(max_abs_err=bit_err, args=(blur, uv, ca, sa))

    # B3: the map slab (N = 2048) against the frame's K descriptors
    fdesc = torch.where(kvalid[:, None], d_p, torch.zeros_like(d_p))
    top_k = matcher.hamming_top2_kernel(desc, valid, fdesc, kvalid)
    top_p = hamming_top2(desc, valid, fdesc, kvalid)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(top_k, top_p))
    m_k = matcher.match_hamming(desc, valid, fdesc, kvalid)
    m_p = match_descriptors(desc, valid, fdesc, kvalid)
    same = (torch.equal(m_k.idx, m_p.idx) and torch.equal(m_k.valid,
                                                          m_p.valid)
            and torch.equal(m_k.dist[m_k.valid], m_p.dist[m_p.valid]))
    log(f"B3 matcher: max_abs_err {err:.3g} over best/second/idx/back, "
        f"{int(m_k.count)} matches, decisions equal {same}")
    if err != 0.0 or not same:
        raise AssertionError("matcher kernel disagrees with plain version")
    rec["matcher"] = dict(max_abs_err=err,
                          args=(desc, valid, fdesc, kvalid))
    rec["fast_nms"]["args"] = (img,)
    return rec


def phase_main_path(inputs):
    """One track_forward through the kernels, launch counts around it;
    then the plain path on the card from the same generator seed."""
    img, cam, xyz, desc, valid, _ = inputs
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    reset_counts()
    T, n, nf = track_forward(img, cam, xyz, desc, valid, generator=gen,
                             max_kps=K, ransac_b=B, device=DEVICE)
    torch.cuda.synchronize()
    launched = counts()
    log(f"main path launches: {launched}")
    if min(launched.values()) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launched}")

    T_np = T.cpu().numpy()
    n_self = int(valid[:min(K, M)].sum())
    log(f"track_forward: pose {np.array2string(T_np, precision=6)}, "
        f"{int(n)} inliers of {n_self} self-features, {int(nf)} features")
    ident = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)
    if not (np.isfinite(T_np).all()
            and np.abs(T_np[:3]).max() <= 1e-3
            and np.abs(T_np[3:] - ident[3:]).max() <= 1e-3):
        raise AssertionError(f"identity pose not recovered: {T_np}")
    if int(n) < n_self // 2:
        raise AssertionError(f"too few inliers: {int(n)} < {n_self // 2}")

    gen_p = torch.Generator(device=DEVICE)
    gen_p.manual_seed(0)
    Tp, n_p, nf_p = track_forward(img, cam, xyz, desc, valid,
                                  generator=gen_p, max_kps=K, ransac_b=B,
                                  use_kernels=False, device=DEVICE)
    f_k = frontend.extract_features(img, max_kps=K)
    f_p = frontend.extract_features(img, max_kps=K, use_kernels=False)
    m_k = matcher.match_hamming(desc, valid, f_k.desc, f_k.valid)
    m_p = match_descriptors(desc, valid, f_p.desc, f_p.valid)
    torch.cuda.synchronize()
    dpose = np.abs(Tp.cpu().numpy() - T_np).max()
    same_matches = (torch.equal(m_k.idx, m_p.idx)
                    and torch.equal(m_k.valid, m_p.valid))
    log(f"plain path: pose diff {dpose:.3g}, inliers {int(n_p)}, "
        f"features {int(nf_p)}, match sets equal {same_matches} "
        f"({int(m_k.count)} matches)")
    if not (same_matches and dpose <= 1e-4 and int(nf_p) == int(nf)):
        raise AssertionError("plain path disagrees with the kernel path")
    return launched


def time_frame(inputs, use_kernels: bool, reps: int = 30):
    img, cam, xyz, desc, valid, _ = inputs
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)

    def step():
        return track_forward(img, cam, xyz, desc, valid, generator=gen,
                             max_kps=K, ransac_b=B, use_kernels=use_kernels,
                             device=DEVICE)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        T, n, _ = step()
        n.item()                         # the caller reads the result
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_stages(inputs):
    """Device time of each stage of the step, as track_forward runs it."""
    img, cam, xyz, desc, valid, _ = inputs
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    f = frontend.extract_features(img, max_kps=K)
    m = matcher.match_hamming(desc, valid, f.desc, f.valid)
    rays = pinhole_unproject(cam, f.uv[m.idx.clamp_min(0).long()])[:, :2]
    data = torch.cat([xyz, rays], -1)
    err_fn = pnp_reproj_error
    T, inl, _ = run_ransac(_p3p_grunert, err_fn, data, m.valid, 4,
                           PNP_THRESH, B, generator=gen)
    w = inl.to(torch.float32)
    return {
        "extract": cuda_ms(lambda: frontend.extract_features(img,
                                                             max_kps=K),
                           reps=20),
        "match": cuda_ms(lambda: matcher.match_hamming(desc, valid, f.desc,
                                                       f.valid), reps=20),
        "ransac": cuda_ms(lambda: run_ransac(
            _p3p_grunert, err_fn, data, m.valid, 4, PNP_THRESH, B,
            generator=gen), reps=20),
        "refine": cuda_ms(lambda: refine_pose_gn(T, data, w), reps=20),
    }


def phase_profile(inputs, frames: int = 10):
    """Device busy share of the step: kernel time that torch.profiler
    records over ``frames`` frames, over their wall time; and the
    kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    img, cam, xyz, desc, valid, _ = inputs
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)

    def step():
        return track_forward(img, cam, xyz, desc, valid, generator=gen,
                             max_kps=K, ransac_b=B, device=DEVICE)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us
            n_kernels += 1
    busy_us = sum(by_name.values())
    if busy_us == 0:
        log("profile: the profiler recorded no device time; device busy "
            "share not measured")
        return None
    log(f"profile over {frames} frames: wall {wall_us / frames / 1e3:.3f} "
        f"ms/frame, device busy {busy_us / frames / 1e3:.3f} ms/frame "
        f"({100 * busy_us / wall_us:.1f}% busy), "
        f"{n_kernels / frames:.0f} device ops/frame")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / frames:9.1f} us/frame  {name[:90]}")
    return dict(wall_ms=wall_us / frames / 1e3,
                busy_ms=busy_us / frames / 1e3,
                busy_share=busy_us / wall_us,
                device_ops_per_frame=n_kernels / frames)


def phase_kernel_times(rec, launched):
    """Kernel and plain times at the main-path shapes, with bounds."""
    img, = rec["fast_nms"]["args"]
    blur, uv, ca, sa = rec["brief"]["args"]
    desc, valid, fdesc, kvalid = rec["matcher"]["args"]
    n_px = img.numel()
    arc = 9
    # per pixel: 16 circle differences; per arc start 2 compares, 2
    # subtractions, 2 sums per arc pixel and 2 maxima; NMS 9 maxima
    fast_ops = n_px * (16 + 16 * (6 * arc + 2) + 1 + 10)
    Kn = uv.shape[0]
    # per bit: 8 products, 6 sums, 4 roundings, 8 clamps, 2 addresses
    # (2 ops each), 1 compare
    brief_ops = Kn * 256 * 31
    brief_bytes = 4 * (blur.numel() + Kn * 4 + 256 * 4) + Kn * 32
    N, Mb = desc.shape[0], fdesc.shape[0]
    # per pair: 8 xor, 8 popc, 8 sums, then top-2 and column compares
    match_ops = N * Mb * (24 + 4)
    match_bytes = (N + Mb) * (32 + 1) + N * 12 + Mb * 4
    work = {
        "fast_nms": (3 * 4 * n_px, fast_ops),
        "brief": (brief_bytes, brief_ops),
        "matcher": (match_bytes, match_ops),
    }
    calls = {
        "fast_nms": (lambda: fastnms.fast_nms_raw(img, THRESH),
                     lambda: fastnms.fast_nms_plain(img, THRESH)),
        "brief": (lambda: brief.brief(blur, uv, ca, sa),
                  lambda: frontend.brief_from_rotation(blur, uv, ca, sa)),
        "matcher": (lambda: matcher.hamming_top2_kernel(desc, valid, fdesc,
                                                        kvalid),
                    lambda: hamming_top2(desc, valid, fdesc, kvalid)),
    }
    out = []
    for name, (kfn, pfn) in calls.items():
        # device time (CUDA graph replay), in turns: plain, kernel,
        # kernel, plain; then the kernel's eager call from Python
        p1 = graph_ms(pfn)
        k1 = graph_ms(kfn)
        k2 = graph_ms(kfn)
        p2 = graph_ms(pfn)
        eager = cuda_ms(kfn)
        b_ms, b_by = bound_ms(*work[name])
        out.append(dict(name=name, route="cuda", **KERNELS[name],
                        launches=launched[name],
                        max_abs_err=rec[name]["max_abs_err"],
                        ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None))
        log(f"{name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/"
            f"{p2:.4f} ms (device, graph replay); eager call "
            f"{eager:.4f} ms; bound {b_ms:.5f} ms ({b_by}; "
            f"{work[name][0]} bytes, {work[name][1]} ops)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    t0 = time.perf_counter()
    inputs = example_inputs(H, W, M, K, device=DEVICE)
    torch.cuda.synchronize()
    log(f"example_inputs {H}x{W}, M={M}, K={K}: "
        f"{time.perf_counter() - t0:.2f} s")
    rec = phase_check(inputs)
    launched = phase_main_path(inputs)

    ms_k = time_frame(inputs, use_kernels=True)
    ms_p = time_frame(inputs, use_kernels=False)
    ms_k2 = time_frame(inputs, use_kernels=True)
    log(f"track_forward {H}x{W} M={M} K={K} B={B}: kernels "
        f"{ms_k:.3f}/{ms_k2:.3f} ms/frame "
        f"({1e3 / min(ms_k, ms_k2):.1f} frames/s), plain path "
        f"{ms_p:.3f} ms/frame")
    stages = phase_stages(inputs)
    log("stages (device ms): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in stages.items()))
    prof = phase_profile(inputs)
    kern = phase_kernel_times(rec, launched)
    log(json.dumps({"slice": "track_forward", "shape": [H, W],
                    "map": M, "kps": K, "ransac_b": B,
                    "ms_per_frame": min(ms_k, ms_k2),
                    "frames_per_s": 1e3 / min(ms_k, ms_k2),
                    "plain_ms_per_frame": ms_p, "stages_ms": stages,
                    "profile": prof}))
    log(card_name_and_power_limit())
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
