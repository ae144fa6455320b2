"""Bundle-adjustment kernels: wrappers of ``csrc/schur.cu``.

Counterparts of ``gslam_tpu/ops/pallas/schur.py``: B5
(``schur_reduce_pallas``, the fused residual -> Jacobian -> Schur
reduction) and B6 (``ba_cost_pallas``, the robust cost).  Plain
versions: ``schur_reduce`` and ``ba_cost`` of
:mod:`gslam_tpu_torch.opt.ba`, which a CPU tensor takes.  The kernel
also applies the camera damping and pinning and returns S itself, so a
call is one launch sequence with no PyTorch operation around it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gslam_tpu_torch.ops.cuda import build
from gslam_tpu_torch.opt.ba import (
    MAX_CAMS, BundleProblem, SchurW, ba_cost, schur_reduce,
)

MAX_OBS = 1024       # observation slots per point the B5 kernel takes

schur_launches = 0   # B5 launches since the last reset
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


def schur_reduce_kernel(problem: BundleProblem, lam: torch.Tensor,
                        huber_delta: float = 0.01):
    """(S, b_s, SchurW, Hpp_inv, bp) as :func:`schur_reduce` computes
    them: the plain version on CPU tensors, the B5 kernel on CUDA ones
    (``lam`` a 0-d tensor on the card; nothing is read back)."""
    global schur_launches
    if problem.cam_pose.device.type == "cpu":
        return schur_reduce(problem, lam, huber_delta)
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
    S = torch.empty((6 * C, 6 * C), device=dev)
    b_s = torch.empty(6 * C, device=dev)
    scratch = torch.empty(int(lib.gslam_schur_scratch(C, P)), device=dev)
    err = lib.gslam_schur(
        *(a[n].data_ptr() for n in ("cam_pose", "cam_fixed")),
        lam_t.data_ptr(),
        *(a[n].data_ptr() for n in ("point_xyz", "point_fixed", "obs_cam",
                                    "obs_uv", "obs_valid", "obs_weight")),
        C, P, O, float(huber_delta), hppinv.data_ptr(), bp.data_ptr(),
        we.data_ptr(), S.data_ptr(), b_s.data_ptr(), scratch.data_ptr(),
        build.stream_ptr())
    build.check_launch(err, "gslam_schur")
    schur_launches += 1
    return S, b_s, SchurW(we, problem.obs_cam), hppinv, bp


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
