"""The port's bundle adjustment (gslam_tpu_torch.opt.ba and the B5 / B6
wrappers of gslam_tpu_torch.ops.cuda.schur, which take their plain
versions on CPU tensors) against the JAX package: its jnp
``schur_reduce`` / ``ba_cost`` / ``bundle_adjust`` under
``default_matmul_precision("highest")``, and its Pallas kernels in
interpret mode, on problems made from a seed with numpy.

Tolerances are tests/test_pallas.py's for the Pallas kernels against
jnp: S rtol 1e-4 and atol 1e-4 of max |S|; b atol 1e-4 of max |b|; W_e
atol 1e-4; Hpp^-1 rtol and atol 1e-3; bp atol 1e-5; the cost rtol 1e-5;
a full LM run: the same accepted steps, costs rtol 1e-3, poses atol
1e-4.  Problem extraction from an arena: observation tables equal,
poses and points equal (gathers), rays to 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ba_case, without_pad_indices
from gslam_tpu.map import arena as ja
from gslam_tpu.opt import ba as jba
from gslam_tpu.ops.pallas import schur as jps
from gslam_tpu.core.camera import Camera as JCamera
from gslam_tpu_torch import convert
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.ops.cuda import schur as tks
from gslam_tpu_torch.opt import ba as tba
from gslam_tpu_torch.opt.robust import huber_weight
from tests.test_pallas import make_ba_problem
from tests.test_torch_arena import assert_same, jfields, rand_desc

torch.set_num_threads(2)
LAM = 1e-3
HD = 0.01


def to_port(prob):
    return convert.bundle_problem_from_numpy(
        [np.asarray(x) for x in prob], device="cpu")


def check_schur(out_t, out_j):
    S0, b0, W0, Hi0, bp0 = (np.asarray(x) for x in
                            (out_j[0], out_j[1], out_j[2].W_e, out_j[3],
                             out_j[4]))
    S1, b1, W1, Hi1, bp1 = (x.numpy() for x in
                            (out_t[0], out_t[1], out_t[2].W_e, out_t[3],
                             out_t[4]))
    np.testing.assert_allclose(S1, S0, rtol=1e-4,
                               atol=1e-4 * np.abs(S0).max())
    np.testing.assert_allclose(b1, b0, atol=1e-4 * max(np.abs(b0).max(),
                                                      1e-6))
    np.testing.assert_allclose(W1, W0, atol=1e-4)
    np.testing.assert_allclose(Hi1, Hi0, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(bp1, bp0, atol=1e-5)


@pytest.mark.parametrize("C,P,O", [(5, 200, 6), (3, 137, 5), (8, 300, 4),
                                   (8, 1024, 8)])
def test_schur_reduce_matches_reference(C, P, O):
    prob = make_ba_problem(np.random.default_rng(C * P + O), C=C, P=P, O=O)
    with jax.default_matmul_precision("highest"):
        ref = jba.schur_reduce(prob, jnp.float32(LAM), HD)
    before = tks.schur_launches
    out = tks.schur_reduce_kernel(to_port(prob), torch.tensor(LAM), HD)
    assert tks.schur_launches == before     # CPU tensors: plain version
    check_schur(out, ref)


@pytest.mark.parametrize("C,P,O,window,pads", [
    (32, 96, 8, 5, True), (32, 96, 5, 5, True), (4, 96, 8, 4, False),
    (8, 61, 5, 3, True), (32, 40, 16, 32, False), (2, 9, 40, 2, True)])
def test_schur_reduce_at_the_kernel_cases_matches_reference(C, P, O, window,
                                                            pads):
    """The cases the B5 kernel is held to on the card, at CPU sizes: few
    cameras per point at the widest camera count, one camera in two
    slots, O off the warp size, pad slots with the camera index -1 or C
    (set to camera 0 for the port's plain version, whose gather does not
    clamp), many slots per point.  The jnp schur_reduce against the
    port's plain version, within tests/test_pallas.py's tolerances (S
    rtol 1e-4 and atol 1e-4 of max |S|; b atol 1e-4 of max |b|; W_e atol
    1e-4; Hpp^-1 rtol and atol 1e-3; bp atol 1e-5)."""
    fields = ba_case(C, P, O, seed=C + P + O, window=window, pads=pads)
    assert (fields[4][::4, 0] == fields[4][::4, 1])[
        fields[6][::4, :2].all(1)].all()          # a camera in two slots
    if pads:
        bad = (fields[4] < 0) | (fields[4] >= C)
        assert bad.any() and not (bad & fields[6]).any()
    with jax.default_matmul_precision("highest"):
        ref = jba.schur_reduce(jba.BundleProblem(*map(jnp.asarray, fields)),
                               jnp.float32(LAM), HD)
    out = tks.schur_reduce_kernel(
        convert.bundle_problem_from_numpy(list(without_pad_indices(fields)),
                                          device="cpu"),
        torch.tensor(LAM), HD)
    check_schur(out, ref)
    np.testing.assert_array_equal(
        np.asarray(ref[2].W_e)[~fields[6]], 0.0)   # pads couple nothing


def test_schur_reduce_matches_pallas_interpret():
    """Also against the TPU kernel itself, run in interpret mode."""
    prob = make_ba_problem(np.random.default_rng(7), C=3, P=137, O=5)
    with jax.default_matmul_precision("highest"):
        ref = jps.schur_reduce_pallas(prob, jnp.float32(LAM), HD,
                                      interpret=True)
    check_schur(tba.schur_reduce(to_port(prob), torch.tensor(LAM), HD), ref)


@pytest.mark.parametrize("C,P,O", [(5, 200, 6), (3, 137, 5)])
def test_ba_cost_matches_reference(C, P, O):
    prob = make_ba_problem(np.random.default_rng(11), C=C, P=P, O=O)
    c_j = float(jba.ba_cost(prob, HD))
    c_p = float(jps.ba_cost_pallas(prob, HD, interpret=True))
    before = tks.cost_launches
    c_t = float(tks.ba_cost_kernel(to_port(prob), HD))
    assert tks.cost_launches == before
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5)
    np.testing.assert_allclose(c_t, c_p, rtol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_bundle_adjust_follows_reference_lm_path(use_kernels):
    prob = make_ba_problem(np.random.default_rng(0))
    with jax.default_matmul_precision("highest"):
        out_j, st_j = jba.bundle_adjust(prob, iters=8)
    out_t, st_t = tba.bundle_adjust(to_port(prob), iters=8,
                                    use_kernels=use_kernels)
    np.testing.assert_array_equal(st_t.accepted.numpy(),
                                  np.asarray(st_j.accepted))
    np.testing.assert_allclose(st_t.cost.numpy(), np.asarray(st_j.cost),
                               rtol=1e-3)
    np.testing.assert_allclose(out_t.cam_pose.numpy(),
                               np.asarray(out_j.cam_pose), atol=1e-4)
    np.testing.assert_allclose(float(st_t.final_lambda),
                               float(st_j.final_lambda), rtol=1e-6)
    assert float(st_t.cost[-1]) < 0.75 * float(st_t.cost[0])


def test_bundle_adjust_rejects_a_failed_factorization():
    """A non-finite reduced system: the reference's cho_solve gives NaN
    and the step is rejected; the port turns the failed Cholesky into
    NaN without raising and rejects the step too."""
    prob = make_ba_problem(np.random.default_rng(1), C=3, P=40, O=4)
    bad = prob._replace(obs_weight=prob.obs_weight.at[0, 0].set(jnp.nan))
    out_j, st_j = jba.bundle_adjust(bad, iters=3)
    out_t, st_t = tba.bundle_adjust(to_port(bad), iters=3)
    np.testing.assert_array_equal(st_t.accepted.numpy(),
                                  np.asarray(st_j.accepted))
    np.testing.assert_array_equal(out_t.cam_pose.numpy(),
                                  np.asarray(bad.cam_pose))


def test_inv3x3_and_huber():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(50, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tba._inv3x3(torch.tensor(A)).numpy(),
                               np.asarray(jba._inv3x3(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-5)
    from gslam_tpu.opt.robust import huber_weight as jh

    e = np.abs(rng.normal(0, 0.02, 100)).astype(np.float32)
    e[:3] = [0.0, 0.01, np.float32(0.01) * 2]
    np.testing.assert_array_equal(huber_weight(torch.tensor(e), 0.01).numpy(),
                                  np.asarray(jh(jnp.asarray(e), 0.01)))


def make_arena_pair(rng, F=6, K=40, P=80, E=400):
    """A geometrically consistent map in both packages: keyframes along a
    line, each observing a random subset of the points at their noisy
    projections."""
    cam = (320.0, 320.0, 160.0, 120.0)
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(4, 8, P)], -1).astype(np.float32)
    poses = np.zeros((F, 8), np.float32)
    poses[:, 3] = 1.0
    poses[:, 7] = 1.0
    poses[:, 0] = -0.2 * np.arange(F)
    poses[:, 4] = 0.01 * rng.normal(size=F)
    poses[:, 3:7] /= np.linalg.norm(poses[:, 3:7], axis=1, keepdims=True)
    j = ja.make_arena(F + 2, K, P + 8, E)
    obs = []
    for f in range(F):
        see = np.sort(rng.choice(P, K, replace=False))
        pc = X[see] + poses[f, :3]          # rotation ~ identity
        uv = np.stack([cam[0] * pc[:, 0] / pc[:, 2] + cam[2],
                       cam[1] * pc[:, 1] / pc[:, 2] + cam[3]], -1)
        uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
        j, _ = ja.insert_frame(j, jnp.asarray(poses[f]), 0.1 * f,
                               jnp.asarray(uv), jnp.zeros((K, 4)),
                               jnp.asarray(rand_desc(rng, K)), K)
        obs.append((f, see))
    j, _ = ja.insert_points(j, jnp.asarray(X + rng.normal(0, 0.02, X.shape)
                                           .astype(np.float32)),
                            jnp.asarray(rand_desc(rng, P)),
                            jnp.ones(P, bool), 0)
    for f, see in obs:
        j = ja.add_observations(j, f, jnp.asarray(see, jnp.int32),
                                jnp.arange(K), jnp.ones(K, bool))
    return j, convert.arena_from_numpy(jfields(j), "cpu"), cam


@pytest.mark.parametrize("O", [3, 8])
def test_build_problem_and_write_back_on_a_carried_arena(O):
    rng = np.random.default_rng(O)
    j, t, cam = make_arena_pair(rng)
    assert_same(j, t)
    jc, tc = JCamera.pinhole(320, 240, *cam), Camera.pinhole(320, 240, *cam)
    cam_ids = np.asarray([5, 3, 0, 4, -1], np.int32)
    point_ids = np.full(70, -1, np.int32)
    point_ids[:60] = np.sort(rng.choice(80, 60, replace=False))[::-1]
    fixed = np.asarray([False, False, True, False, False])
    pj, okj = jba.build_problem_from_arena(
        j, jnp.asarray(cam_ids), jnp.asarray(point_ids), jnp.asarray(fixed),
        jc, max_obs_per_point=O)
    pt, okt = tba.build_problem_from_arena(
        t, torch.tensor(cam_ids), torch.tensor(point_ids),
        torch.tensor(fixed), tc, max_obs_per_point=O)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    for name in tba.BundleProblem._fields:
        a, b = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        if name == "obs_uv":
            np.testing.assert_allclose(a, b, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert okt.sum() > 40 and (~pt.point_fixed).sum() > 20
    with jax.default_matmul_precision("highest"):
        oj, sj = jba.bundle_adjust(pj, iters=4)
    ot, st = tba.bundle_adjust(pt, iters=4, use_kernels=True)
    np.testing.assert_array_equal(st.accepted.numpy(),
                                  np.asarray(sj.accepted))
    j2 = jba.write_back_to_arena(j, oj, jnp.asarray(cam_ids),
                                 jnp.asarray(point_ids))
    t2 = tba.write_back_to_arena(t, ot, torch.tensor(cam_ids),
                                 torch.tensor(point_ids))
    assert_same(j2, t2, float_atol=1e-4)
    # frame 0 is fixed and repeated by the padded slot: unchanged
    np.testing.assert_array_equal(t2.frame_pose[0].numpy(),
                                  t.frame_pose[0].numpy())


# ---------------------------------------------------------------------------
# loop-closure slice: routing by shape, pose information, per-frame
# slabs, motion-only refinement and global BA, from one carried arena.
# Slabs: tables equal, rays to 1e-7.  Pose information rtol 1e-4 (a sum
# of ~40 float32 products).  Refined poses 1e-4 and, after a global BA,
# poses 1e-4 and points 1e-3: float32 LM on both sides, as above.


def cameras(cam):
    return JCamera.pinhole(320, 240, *cam), Camera.pinhole(320, 240, *cam)


def test_wide_window_routes_to_plain_path_in_both_packages():
    """More cameras than the Schur kernel takes: both packages' routing
    rules pick the plain path by shape, and the plain LM over a 40-camera
    window agrees; within the contract the rule picks the kernels."""
    wide = make_ba_problem(np.random.default_rng(40), C=40, P=160, O=6)
    small = make_ba_problem(np.random.default_rng(8), C=8, P=40, O=4)
    assert not jps.schur_pallas_ok(wide) and jps.schur_pallas_ok(small)
    assert jba.resolve_ba_backend(wide) == "jnp"
    assert tba.MAX_CAMS == jps.MAX_CAMS == 32
    assert not tba.resolve_ba_kernels(True, 40)
    assert tba.resolve_ba_kernels(True, 32) and tba.resolve_ba_kernels(True, 1)
    assert not tba.resolve_ba_kernels(True, 0)
    assert not tba.resolve_ba_kernels(False, 8)
    with jax.default_matmul_precision("highest"):
        out_j, st_j = jba.bundle_adjust(
            wide, iters=4, backend=jba.resolve_ba_backend(wide))
    before = (tks.schur_launches, tks.cost_launches)
    out_t, st_t = tba.bundle_adjust(
        to_port(wide), iters=4,
        use_kernels=tba.resolve_ba_kernels(True, 40))
    assert (tks.schur_launches, tks.cost_launches) == before
    np.testing.assert_array_equal(st_t.accepted.numpy(),
                                  np.asarray(st_j.accepted))
    np.testing.assert_allclose(st_t.cost.numpy(), np.asarray(st_j.cost),
                               rtol=1e-3)
    np.testing.assert_allclose(out_t.cam_pose.numpy(),
                               np.asarray(out_j.cam_pose), atol=1e-4)


def test_pose_information_and_frame_obs_slabs():
    from gslam_tpu.estimation.pnp import pose_information as j_info
    from gslam_tpu_torch.estimation.pnp import pose_information

    rng = np.random.default_rng(21)
    j, t, cam = make_arena_pair(rng)
    # some observations of erased points and one erased frame
    j = ja.erase_points(j, jnp.asarray([3, 17, 40], jnp.int32))
    j = ja.erase_frame(j, jnp.asarray(4))
    t = convert.arena_from_numpy(jfields(j), "cpu")
    jc, tc = cameras(cam)
    for K in (None, 25):
        dj, wj = jba.frame_obs_slabs(j, jc, K)
        dt, wt = tba.frame_obs_slabs(t, tc, K)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(dt[..., :3].numpy(),
                                      np.asarray(dj[..., :3]))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-7)
    assert wt[4].sum() == 0 and 20 < wt[0].sum() <= 25
    dj, wj = jba.frame_obs_slabs(j, jc)
    dt, wt = tba.frame_obs_slabs(t, tc)
    H_j = np.asarray(jax.vmap(j_info)(j.frame_pose[:, :7], dj, wj))
    H_t = pose_information(t.frame_pose[:, :7], dt, wt).numpy()
    np.testing.assert_allclose(H_t, H_j, rtol=1e-4, atol=1e-5)
    assert np.abs(H_t[4]).max() == 0 and H_t[0].trace() > 1.0
    # one pose, as the loop closer calls it for the loop edge
    np.testing.assert_allclose(
        pose_information(t.frame_pose[1, :7], dt[1], wt[1]).numpy(), H_j[1],
        rtol=1e-4, atol=1e-5)


def test_motion_only_refine_on_a_carried_arena():
    rng = np.random.default_rng(22)
    j, t, cam = make_arena_pair(rng)
    # knock the keyframes off their poses; frame 0 is the gauge
    fp = np.asarray(j.frame_pose).copy()
    fp[:6, :3] += rng.normal(0, 0.03, (6, 3)).astype(np.float32)
    j = j.replace(frame_pose=jnp.asarray(fp))
    t = convert.arena_from_numpy(jfields(j), "cpu")
    jc, tc = cameras(cam)
    j2 = jba.motion_only_refine(j, jc, iters=5)
    t2 = tba.motion_only_refine(t, tc, iters=5)
    assert_same(j2, t2, float_atol=1e-4)
    np.testing.assert_array_equal(t2.frame_pose[0].numpy(), fp[0])
    moved = np.abs(t2.frame_pose.numpy() - fp).max(1)
    assert (moved[1:6] > 1e-3).all() and (moved[6:] == 0).all()


@pytest.mark.parametrize("max_points", [4096, 32])
def test_global_bundle_adjust_on_a_carried_arena(max_points):
    """One joint solve (every landmark fits the budget), and the chunked
    pass (structure-only solves over point chunks, then a motion-only
    pass over all cameras)."""
    rng = np.random.default_rng(23)
    j, t, cam = make_arena_pair(rng)
    jc, tc = cameras(cam)
    with jax.default_matmul_precision("highest"):
        j2, costs_j = jba.global_bundle_adjust(
            j, jc, iters=4, max_points=max_points, sweeps=1, backend="jnp")
    before = (tks.schur_launches, tks.cost_launches)
    t2, costs_t = tba.global_bundle_adjust(
        t, tc, iters=4, max_points=max_points, sweeps=1, use_kernels=True)
    assert (tks.schur_launches, tks.cost_launches) == before   # CPU tensors
    assert costs_t.shape == costs_j.shape == (5 * -(-80 // max_points),)
    np.testing.assert_allclose(costs_t.numpy(), np.asarray(costs_j),
                               rtol=1e-3)
    assert float(costs_t[4]) < float(costs_t[0])
    jf, tf = jfields(j2), convert.arena_to_numpy(t2)
    np.testing.assert_allclose(tf["frame_pose"], jf["frame_pose"], atol=1e-4)
    np.testing.assert_allclose(tf["point_xyz"], jf["point_xyz"], atol=1e-3)
    assert np.abs(tf["point_xyz"] - jfields(j)["point_xyz"]).max() > 1e-3
    np.testing.assert_array_equal(tf["frame_pose"][0],
                                  jfields(j)["frame_pose"][0])


def test_global_bundle_adjust_edges():
    rng = np.random.default_rng(24)
    _, t, cam = make_arena_pair(rng)
    tc = cameras(cam)[1]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tba.global_bundle_adjust(t, tc, mesh=object())
    from gslam_tpu_torch.map.arena import make_arena

    empty = make_arena(4, 8, 16, 32, device="cpu")
    out, costs = tba.global_bundle_adjust(empty, tc)
    assert out is empty and costs.shape == (1,)
