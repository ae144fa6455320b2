"""Bundle-adjustment kernels: wrappers of ``csrc/schur.cu``.

Counterparts of ``gslam_tpu/ops/pallas/schur.py``: B5
(``schur_reduce_pallas``, the fused residual -> Jacobian -> Schur
reduction) and B6 (``ba_cost_pallas``, the robust cost).  Plain
versions: ``schur_reduce`` and ``ba_cost`` of
:mod:`gslam_tpu_torch.opt.ba`, which a CPU tensor takes.  The kernel
also applies the camera damping and pinning and returns S itself, so a
call is one launch sequence with no PyTorch operation around it.  B5's
partials entry (``schur_partials_kernel``) returns a landmark shard's
undamped, unpinned pieces instead, which the ring-exchange BA sums
across shards (the reference's ``partials_from_outs``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gslam_tpu_torch.ops.cuda import build
from gslam_tpu_torch.opt.ba import (
    MAX_CAMS, BundleProblem, SchurW, ba_cost, schur_partials, schur_reduce,
)

MAX_OBS = 1024       # observation slots per point the B5 kernel takes

schur_launches = 0   # B5 launches since the last reset
partials_launches = 0   # B5 partials-entry launches since the last reset
cost_launches = 0    # B6 launches since the last reset

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib(flags: tuple = ()) -> ctypes.CDLL:
    """The schur library, built with ``flags`` (a tuning variant's
    ``-D`` macros) added."""
    lib = build.library("schur", flags)
    lib.gslam_schur_scratch.restype = ctypes.c_longlong
    lib.gslam_schur_scratch.argtypes = [_I, _I]
    lib.gslam_schur.restype = _I
    lib.gslam_schur.argtypes = [_P] * 9 + [_I, _I, _I, _F] + [_P] * 7
    lib.gslam_schur_partials.restype = _I
    lib.gslam_schur_partials.argtypes = [_P] * 9 + [_I, _I, _I, _F] \
        + [_P] * 8
    lib.gslam_ba_cost_scratch.restype = ctypes.c_longlong
    lib.gslam_ba_cost_scratch.argtypes = [_I]
    lib.gslam_ba_cost.restype = _I
    lib.gslam_ba_cost.argtypes = [_P] * 6 + [_I, _I, _I, _F, _P, _P, _P]
    return lib


def _inputs(problem: BundleProblem):
    """The problem's tensors as the kernels take them, checked: poses
    (C, 7), masks as bool bytes, observations (P, O[, 2])."""
    C = problem.cam_pose.shape[0]
    P, O = problem.obs_cam.shape
    if not 1 <= C <= MAX_CAMS:
        raise ValueError(f"the Schur kernel takes 1 <= C <= {MAX_CAMS} "
                         f"cameras, got {C}")
    args = {name: getattr(problem, name).contiguous()
            for name in BundleProblem._fields}
    shapes = dict(cam_pose=((C, 7), torch.float32),
                  cam_fixed=((C,), torch.bool),
                  point_xyz=((P, 3), torch.float32),
                  point_fixed=((P,), torch.bool),
                  obs_cam=((P, O), torch.int32),
                  obs_uv=((P, O, 2), torch.float32),
                  obs_valid=((P, O), torch.bool),
                  obs_weight=((P, O), torch.float32))
    for name, (shape, dtype) in shapes.items():
        build.check_tensor(args[name], name, dtype, shape)
    return args, C, P, O


def _schur_call(entry: str, problem: BundleProblem, lam: torch.Tensor,
                huber_delta: float, outs):
    """Launch the C entry ``entry`` of B5 on ``problem``: its inputs,
    then (Hpp_inv, bp, W_e) and the output tensors ``outs(C, device)``
    makes; returns (Hpp_inv, bp, SchurW, those tensors)."""
    a, C, P, O = _inputs(problem)
    if O > MAX_OBS:
        raise ValueError(f"the Schur kernel takes at most {MAX_OBS} "
                         f"observation slots per point, got {O}")
    dev = problem.cam_pose.device
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    build.check_tensor(lam_t, "lam", torch.float32, ())
    lib = _lib()
    hppinv = torch.empty((P, 3, 3), device=dev)
    bp = torch.empty((P, 3), device=dev)
    we = torch.empty((P, O, 6, 3), device=dev)
    extra = outs(C, dev)
    scratch = torch.empty(int(lib.gslam_schur_scratch(C, P)), device=dev)
    err = getattr(lib, entry)(
        *(a[n].data_ptr() for n in ("cam_pose", "cam_fixed")),
        lam_t.data_ptr(),
        *(a[n].data_ptr() for n in ("point_xyz", "point_fixed", "obs_cam",
                                    "obs_uv", "obs_valid", "obs_weight")),
        C, P, O, float(huber_delta), hppinv.data_ptr(), bp.data_ptr(),
        we.data_ptr(), *(t.data_ptr() for t in extra), scratch.data_ptr(),
        build.stream_ptr())
    build.check_launch(err, entry)
    return hppinv, bp, SchurW(we, problem.obs_cam), extra


def schur_reduce_kernel(problem: BundleProblem, lam: torch.Tensor,
                        huber_delta: float = 0.01):
    """(S, b_s, SchurW, Hpp_inv, bp) as :func:`schur_reduce` computes
    them: the plain version on CPU tensors, the B5 kernel on CUDA ones
    (``lam`` a 0-d tensor on the card; nothing is read back)."""
    global schur_launches
    if problem.cam_pose.device.type == "cpu":
        return schur_reduce(problem, lam, huber_delta)
    hppinv, bp, W, (S, b_s) = _schur_call(
        "gslam_schur", problem, lam, huber_delta,
        lambda C, dev: (torch.empty((6 * C, 6 * C), device=dev),
                        torch.empty(6 * C, device=dev)))
    schur_launches += 1
    return S, b_s, W, hppinv, bp


def schur_partials_plain(problem: BundleProblem, lam: torch.Tensor,
                         huber_delta: float = 0.01):
    """The plain version of B5's partials entry: :func:`schur_partials`
    as (Hcc (C, 6, 6) undamped and unpinned, bvec = bc cam_free - b_corr
    (C, 6), S_corr (6C, 6C), SchurW, Hpp_inv (P, 3, 3), bp (P, 3))."""
    Hcc, bc, S_corr, b_corr, W, Hpp_inv, bp = schur_partials(
        problem, lam, huber_delta)
    return Hcc, bc - b_corr, S_corr, W, Hpp_inv, bp


def schur_partials_kernel(problem: BundleProblem, lam: torch.Tensor,
                          huber_delta: float = 0.01):
    """A landmark shard's Schur pieces, undamped and unpinned, in the
    order of the reference's ``partials_from_outs``: (Hcc, bvec,
    S_corr, SchurW, Hpp_inv, bp).  The plain version
    (:func:`schur_partials_plain`) on CPU tensors, B5's partials entry
    on CUDA ones (one launch sequence; nothing is read back)."""
    global partials_launches
    if problem.cam_pose.device.type == "cpu":
        return schur_partials_plain(problem, lam, huber_delta)
    hppinv, bp, W, (S_corr, Hcc, bvec) = _schur_call(
        "gslam_schur_partials", problem, lam, huber_delta,
        lambda C, dev: (torch.empty((6 * C, 6 * C), device=dev),
                        torch.empty((C, 6, 6), device=dev),
                        torch.empty((C, 6), device=dev)))
    partials_launches += 1
    return Hcc, bvec, S_corr, W, hppinv, bp


def ba_cost_kernel(problem: BundleProblem, huber_delta: float = 0.01
                   ) -> torch.Tensor:
    """Total robust chi2 as :func:`ba_cost` computes it: the plain
    version on CPU tensors, the B6 kernel on CUDA ones (a 0-d tensor on
    the card; one launch, on the current stream)."""
    global cost_launches
    if problem.cam_pose.device.type == "cpu":
        return ba_cost(problem, huber_delta)
    a, C, P, O = _inputs(problem)
    dev = problem.cam_pose.device
    lib = _lib()
    out = torch.empty((), device=dev)
    scratch = torch.empty(int(lib.gslam_ba_cost_scratch(P)), device=dev)
    err = lib.gslam_ba_cost(
        *(a[n].data_ptr() for n in ("cam_pose", "point_xyz", "obs_cam",
                                    "obs_uv", "obs_valid", "obs_weight")),
        C, P, O, float(huber_delta), out.data_ptr(), scratch.data_ptr(),
        build.stream_ptr())
    build.check_launch(err, "gslam_ba_cost")
    cost_launches += 1
    return out
