"""The port's pose-graph optimizer (gslam_tpu_torch.opt.pose_graph)
against the JAX package's (gslam_tpu.opt.pose_graph) on a noisy ring
with one loop edge, made from a seed with numpy.

Tolerances: the cost 1e-5 relative; one linearization: residuals 1e-5,
Jacobians 1e-5 (forward-mode derivatives on both sides), gradient 1e-4;
a run of ``optimize_pose_graph``: per-iteration costs to 1e-3 relative
(plus 1e-6 of the start cost: near convergence the cost is float32
noise around zero) and poses to 1e-4, dense and PCG, SE3 and SIM3,
scalar and (E, d) weights, with and without a position prior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core import se3 as jse3
from gslam_tpu.opt import pose_graph as jpg
from gslam_tpu_torch import convert
from gslam_tpu_torch.opt import pose_graph as tpg

torch.set_num_threads(2)


def ring_graph(N=12, mode="se3", seed=0, weights="scalar", prior=False,
               pad=0):
    """Fields of a ring of N poses looking along the tangent, odometry
    edges and one loop edge (0 <- N-1) measured from the truth, poses
    perturbed; ``pad`` invalid identity edges at the end."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, N, endpoint=False)
    xi = np.stack([3 * np.cos(th), 3 * np.sin(th), 0 * th, 0 * th, 0 * th,
                   th * 0.9], -1).astype(np.float32)
    gt = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    if mode == "sim3":
        gt = np.concatenate([gt, np.ones((N, 1), np.float32)], -1)
    ops = jpg._group_ops(mode)
    d = ops["dim"]
    ei = list(range(1, N)) + [0] + [0] * pad
    ej = list(range(0, N - 1)) + [N - 1] + [0] * pad
    rel = np.array(ops["mul"](jnp.asarray(gt[ei]),
                              ops["inv"](jnp.asarray(gt[ej]))))
    noise = rng.normal(0, 0.05, (N, d)).astype(np.float32)
    noise[0] = 0
    poses = np.asarray(ops["mul"](ops["exp"](jnp.asarray(noise)),
                                  jnp.asarray(gt)))
    E = len(ei)
    w = (np.ones(E, np.float32) if weights == "scalar"
         else rng.uniform(0.5, 2.0, (E, d)).astype(np.float32))
    valid = np.ones(E, bool)
    valid[E - pad:] = False
    fixed = np.zeros(N, bool)
    fixed[0] = True
    pp = pw = None
    if prior:
        ctr = np.asarray(jpg._cam_center(jnp.asarray(gt)))
        pp = (ctr + rng.normal(0, 0.01, ctr.shape)).astype(np.float32)
        pw = np.full(N, 0.5, np.float32)
        pw[::3] = 0
    return dict(poses=poses, fixed=fixed, edge_i=np.asarray(ei, np.int32),
                edge_j=np.asarray(ej, np.int32), edge_rel=rel,
                edge_valid=valid, edge_weight=w, prior_pos=pp,
                prior_weight=pw)


def both(fields):
    gj = jpg.PoseGraph(**{k: None if v is None else jnp.asarray(v)
                          for k, v in fields.items()})
    return gj, convert.pose_graph_from_numpy(fields, device="cpu")


@pytest.mark.parametrize("mode", ["se3", "sim3"])
@pytest.mark.parametrize("weights", ["scalar", "diag"])
def test_cost_and_linearization(mode, weights):
    f = ring_graph(mode=mode, weights=weights, prior=True, pad=3, seed=1)
    gj, gt = both(f)
    c_j = float(jpg.pose_graph_cost(gj, mode))
    np.testing.assert_allclose(float(tpg.pose_graph_cost(gt, mode)), c_j,
                               rtol=1e-5)
    assert c_j > 0.1
    # the reference's linearization, written out from its parts
    ops = jpg._group_ops(mode)
    d = ops["dim"]

    def edge_residual(xi, xj, Ti, Tj, Z):
        Ti_p = ops["mul"](ops["exp"](xi), Ti)
        Tj_p = ops["mul"](ops["exp"](xj), Tj)
        return ops["log"](ops["mul"](ops["inv"](Z),
                                     ops["mul"](Ti_p, ops["inv"](Tj_p))))

    z = jnp.zeros(d)
    Ti, Tj = gj.poses[gj.edge_i], gj.poses[gj.edge_j]
    r_j = jax.vmap(lambda a, b, c: edge_residual(z, z, a, b, c))(
        Ti, Tj, gj.edge_rel)
    Ji_j = jax.vmap(lambda a, b, c: jax.jacfwd(edge_residual, 0)(
        z, z, a, b, c))(Ti, Tj, gj.edge_rel)
    Jj_j = jax.vmap(lambda a, b, c: jax.jacfwd(edge_residual, 1)(
        z, z, a, b, c))(Ti, Tj, gj.edge_rel)
    free = ~f["fixed"]
    r, Jiw, Jjw, Ji, Jj, Hp, b = tpg.linearize(gt, gt.poses, mode)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), atol=1e-5)
    np.testing.assert_allclose(
        Ji.numpy(), np.asarray(Ji_j) * free[f["edge_i"]][:, None, None],
        atol=1e-5)
    np.testing.assert_allclose(
        Jj.numpy(), np.asarray(Jj_j) * free[f["edge_j"]][:, None, None],
        atol=1e-5)
    assert np.isfinite(Ji.numpy()).all() and np.isfinite(Jj.numpy()).all()
    assert (Jiw[-3:] == 0).all()              # padded edges weigh nothing
    assert (b[0] == 0).all() and Hp.shape == (12, d, d)
    # the gradient is the cost's: a finite difference along -b lowers it
    step = ops["mul"](ops["exp"](jnp.asarray(-1e-3 * b.numpy())), gj.poses)
    assert float(jpg.pose_graph_cost(gj._replace(poses=step), mode)) < c_j


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("weights", ["scalar", "diag"])
@pytest.mark.parametrize("solver", ["dense", "pcg"])
@pytest.mark.parametrize("mode", ["se3", "sim3"])
def test_optimize_matches_reference(mode, solver, weights, prior):
    f = ring_graph(mode=mode, weights=weights, prior=prior, pad=2)
    gj, gt = both(f)
    out_j, costs_j = jpg.optimize_pose_graph(gj, mode=mode, iters=8,
                                             solver=solver)
    out_t, costs_t = tpg.optimize_pose_graph(gt, mode=mode, iters=8,
                                             solver=solver)
    costs_j = np.asarray(costs_j)
    assert costs_t.shape == (9,)
    np.testing.assert_allclose(costs_t.numpy(), costs_j, rtol=1e-3,
                               atol=1e-6 * costs_j[0])
    np.testing.assert_allclose(out_t.poses.numpy(), np.asarray(out_j.poses),
                               atol=1e-4)
    assert costs_j[-1] < 1e-2 * costs_j[0]
    np.testing.assert_array_equal(out_t.poses[0].numpy(), f["poses"][0])


def test_auto_solver_and_a_rejected_step():
    """``auto`` is the dense solve at this size; a non-finite edge makes
    every step's cost non-finite, and both packages keep the poses."""
    f = ring_graph(seed=2)
    gj, gt = both(f)
    a, ca = tpg.optimize_pose_graph(gt, iters=3)
    b, cb = tpg.optimize_pose_graph(gt, iters=3, solver="dense")
    np.testing.assert_array_equal(a.poses.numpy(), b.poses.numpy())
    f["edge_rel"][2, 0] = np.nan
    gj, gt = both(f)
    out_j, costs_j = jpg.optimize_pose_graph(gj, iters=3)
    out_t, costs_t = tpg.optimize_pose_graph(gt, iters=3)
    np.testing.assert_array_equal(out_t.poses.numpy(), f["poses"])
    np.testing.assert_array_equal(np.asarray(out_j.poses), f["poses"])
    assert np.isnan(costs_t.numpy()).all() and np.isnan(
        np.asarray(costs_j)).all()
    with pytest.raises(ValueError, match="se3"):
        tpg.optimize_pose_graph(gt, mode="so3")
    with pytest.raises(ValueError, match="solver"):
        tpg.optimize_pose_graph(gt, solver="lu")
