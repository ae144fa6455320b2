"""The distributed layer (gslam_tpu_torch.parallel) against the JAX
package's gslam_tpu.parallel, on gloo worlds of 2 and 4 ranks on the
CPU against JAX meshes of the conftest's virtual CPU devices.

Each world is spawned once for the module (``launch.spawn``: a free
port, a 60 s process-group timeout, a bounded join) and runs every case
inside it; the JAX references run in the test process.  JAX is imported
inside the fixtures only, so the spawned ranks, which import this
module, load PyTorch alone.  Inputs come from numpy seeds
(``tests/test_opt.py::make_ba_problem``, the JAX package's
``KeyframeSLAM`` on two synthetic sequences, ``example_inputs``).

Tolerances are the reference tests' own (tests/test_parallel.py): poses
atol 1e-3 against another variant or mesh shape, cost histories rtol
0.05 with atol 1e-8 (late iterations sit at the float32 cost floor);
within one world every rank returns the same bits; a rerun from a
checkpoint gives the same bits; the tracking step as
tests/test_torch_graft.py holds ``track_forward`` (features exactly,
inliers +/- 1, pose 1e-4).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gslam_tpu_torch import convert
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.map import arena as ta
from gslam_tpu_torch.opt.ba import bundle_adjust, global_bundle_adjust
from gslam_tpu_torch.parallel import (
    dist_ba, distributed_bundle_adjust, distributed_bundle_adjust_ring,
    make_dp_mesh, make_mesh, sharded_track_batch,
)
from gslam_tpu_torch.parallel import launch

torch.set_num_threads(2)
POSE_ATOL = 1e-3
COST = dict(rtol=0.05, atol=1e-8)
RING_ITERS = 8
SEQ_CFG = dict(max_kps=160, fast_threshold=0.1, ba_window=3, ba_points=192,
               ba_iters=2, cap_frames=16, cap_points=1024, cap_obs=4096,
               local_map_size=256, kf_max_gap=2)
ALIGN = [50., 0., 0., 1, 0, 0, 0, 1.]
GBA = dict(iters=4, max_cams=16, max_points=1024, max_obs_per_point=8)
TRACK = dict(H=96, W=128, M=512, K=128, B=8, ransac_b=64)
# psum cases: (problem, mesh shape, iters); world 2 runs (2, 1)
PSUM = {"A_2x1": ("A", (2, 1), 8), "A_4x1": ("A", (4, 1), 8),
        "A_2x2": ("A", (2, 2), 8), "B_2x2": ("B", (2, 2), 6)}
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor", "broadcast",
               "all_to_all", "all_to_all_single", "gather", "scatter",
               "reduce", "barrier")


# ---------------------------------------------------------------------------
# what the ranks run (module level: the spawned processes import it)


@contextlib.contextmanager
def counting_collectives(calls):
    """Count every call of a ``torch.distributed`` collective."""
    saved = {n: getattr(dist, n) for n in COLLECTIVES}

    def counted(n):
        def call(*a, **k):
            calls[n] = calls.get(n, 0) + 1
            return saved[n](*a, **k)
        return call

    for n in COLLECTIVES:
        setattr(dist, n, counted(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def problem(fields):
    return convert.bundle_problem_from_numpy(fields, device="cpu")


def run_psum(fields, shape, iters):
    out, costs = distributed_bundle_adjust(
        problem(fields), make_mesh(shape, device="cpu"), iters=iters)
    return out.cam_pose, out.point_xyz, costs


def run_ring(fields, use_kernels):
    mesh = make_mesh((dist.get_world_size(), 1), device="cpu")
    calls = {}
    dist_ba.ring_hops = 0
    with counting_collectives(calls):
        out, costs = distributed_bundle_adjust_ring(
            problem(fields), mesh, iters=RING_ITERS, use_kernels=use_kernels)
    return dict(cam_pose=out.cam_pose, point_xyz=out.point_xyz, costs=costs,
                hops=dist_ba.ring_hops, collectives=calls)


def run_checkpoint(fields, path):
    """tests/test_parallel.py::TestFaultRecovery on a (4, 1) mesh: a
    run, its problem checkpointed, a run with rank 0's landmark block
    corrupted, then a rerun from the checkpoint."""
    ref = run_psum(fields, (4, 1), 4)
    if dist.get_rank() == 0:
        np.savez(path, *fields)
    dist.barrier()
    P = fields[2].shape[0]
    bad = list(fields)
    bad[2] = fields[2].copy()
    bad[2][:P // 4] = 1e3
    corrupted = run_psum(tuple(bad), (4, 1), 4)
    with np.load(path) as z:
        restored = tuple(z[f"arr_{i}"] for i in range(len(z.files)))
    return dict(ref=ref, bad=corrupted, rerun=run_psum(restored, (4, 1), 4))


def run_merged_gba(arena_a, arena_b, cam):
    a, b = (ta.arena_from_numpy(x, device="cpu") for x in (arena_a, arena_b))
    merged = ta.merge_arenas(a, b, transform_b=torch.tensor(ALIGN))
    out, costs = global_bundle_adjust(
        merged, Camera.pinhole(*cam), mesh=make_mesh((2, 2), device="cpu"),
        **GBA)
    return dict(merged=ta.arena_to_numpy(merged),
                out=ta.arena_to_numpy(out), costs=costs)


def run_track(inp):
    slab = convert.map_slab_from_numpy(inp["xyz"], inp["desc"], inp["valid"],
                                       device="cpu")
    return sharded_track_batch(
        make_dp_mesh(device="cpu"), torch.tensor(inp["images"]),
        torch.tensor(inp["cam"]), *slab, torch.tensor(inp["uniforms"]),
        max_kps=TRACK["K"], ransac_b=TRACK["ransac_b"])


def rank_main(rank, world, inputs, tmp):
    out = {name: run_psum(inputs["problems"][p], shape, iters)
           for name, (p, shape, iters) in PSUM.items()
           if shape[0] * shape[1] == world}
    if world == 2:
        out["track"] = run_track(inputs["track"])
        return out
    ring = inputs["problems"]["R"]
    out["ring"] = run_ring(ring, use_kernels=False)
    out["ring_kernels"] = run_ring(ring, use_kernels=True)
    out["ckpt"] = run_checkpoint(inputs["problems"]["A"], f"{tmp}/ckpt.npz")
    out["gba"] = run_merged_gba(*inputs["arenas"], inputs["cam"])
    return out


# ---------------------------------------------------------------------------
# the JAX references (test process only)


@pytest.fixture(scope="module")
def ref():
    import jax
    from jax.sharding import Mesh

    from gslam_tpu.parallel.dist_ba import (
        distributed_bundle_adjust as j_psum,
        distributed_bundle_adjust_ring as j_ring,
    )
    from gslam_tpu.parallel.mesh import make_mesh as j_mesh
    from tests.test_opt import make_ba_problem

    def fields(p):
        return tuple(np.asarray(x) for x in p)

    probs = {
        "A": fields(make_ba_problem(np.random.default_rng(0), C=5, P=40, O=4,
                                    pose_noise=0.02, point_noise=0.05)[0]),
        "B": fields(make_ba_problem(np.random.default_rng(0), C=4, P=37, O=3,
                                    pose_noise=0.01, point_noise=0.02)[0]),
        "R": fields(make_ba_problem(np.random.default_rng(0), C=6, P=64, O=4,
                                    pose_noise=0.02, point_noise=0.05)[0]),
    }
    devs = jax.devices("cpu")
    out = {"problems": probs, "psum": {}}
    for name, (p, shape, iters) in PSUM.items():
        o, c = j_psum(convert_problem(probs[p]),
                      j_mesh(shape, devices=devs[:shape[0] * shape[1]]),
                      iters=iters)
        out["psum"][name] = (np.asarray(o.cam_pose), np.asarray(o.point_xyz),
                             np.asarray(c))
    o, c = j_ring(convert_problem(probs["R"]),
                  Mesh(np.array(devs[:4]), ("pt",)), iters=RING_ITERS)
    out["ring"] = (np.asarray(o.cam_pose), np.asarray(c))
    out.update(sequences_reference(devs))
    out.update(tracking_reference(devs))
    return out


def convert_problem(fields):
    import jax.numpy as jnp

    from gslam_tpu.opt.ba import BundleProblem

    return BundleProblem(*(jnp.asarray(x) for x in fields))


def sequences_reference(devs):
    """Two 8-frame sequences through the JAX package's KeyframeSLAM
    (tests/test_parallel.py:120-175, two keyframes a gap), merged, and
    its distributed global BA at (4, 2)."""
    import jax.numpy as jnp

    from gslam_tpu.datasets.synthetic import SyntheticDataset
    from gslam_tpu.map.arena import merge_arenas
    from gslam_tpu.models.keyframe_slam import KeyframeSLAM, SLAMConfig
    from gslam_tpu.opt.ba import global_bundle_adjust as j_gba
    from gslam_tpu.parallel.mesh import make_mesh as j_mesh
    from tests.test_torch_arena import jfields

    def run(seed):
        ds = SyntheticDataset(n_frames=8, n_points=250, width=160,
                              height=120, motion="line", depth=True,
                              seed=seed)
        ds.open("synth://")
        slam = KeyframeSLAM(ds.camera, SLAMConfig(**SEQ_CFG))
        for fr in ds:
            slam.track(fr)
        return slam.arena, ds.camera

    a, cam = run(3)
    b, _ = run(11)
    merged = merge_arenas(a, b, transform_b=jnp.asarray(ALIGN, jnp.float32))
    out, costs = j_gba(merged, cam, mesh=j_mesh((4, 2), devices=devs[:8]),
                       **GBA)
    return dict(arenas=(jfields(a), jfields(b)),
                cam=(cam.width, cam.height, *np.asarray(cam.params).tolist()),
                merged=jfields(merged), gba=(jfields(out), np.asarray(costs)))


def tracking_reference(devs):
    """tests/test_parallel.py::TestShardedTracking on a 4-device 'dp'
    mesh, and each frame's RANSAC draws."""
    import jax
    import jax.numpy as jnp

    from gslam_tpu.models.graft import example_inputs
    from gslam_tpu.parallel.mesh import make_dp_mesh as j_dp
    from gslam_tpu.parallel.tracking import sharded_track_batch as j_track

    t = TRACK
    img, cam, xyz, desc, valid, key = example_inputs(H=t["H"], W=t["W"],
                                                     M=t["M"],
                                                     max_kps=t["K"])
    imgs = jnp.stack([img + 1e-4 * i for i in range(t["B"])])
    keys = jax.random.split(key, t["B"])
    out = j_track(j_dp(4, devices=devs), imgs, cam, xyz, desc, valid, keys,
                  max_kps=t["K"], ransac_b=t["ransac_b"])
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (t["ransac_b"], 4)))
                         for k in keys])
    return dict(track_inputs=dict(
        images=np.asarray(imgs), cam=np.asarray(cam), xyz=np.asarray(xyz),
        desc=np.asarray(desc), valid=np.asarray(valid), uniforms=uniforms),
        track=tuple(np.asarray(x) for x in out))


def spawn_world(ref, world, tmp):
    inputs = dict(problems=ref["problems"], arenas=ref["arenas"],
                  cam=ref["cam"], track=ref["track_inputs"])
    return launch.spawn(rank_main, world, device="cpu",
                        args=(inputs, str(tmp)), timeout_s=240.0)


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    return spawn_world(ref, 2, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(ref, tmp_path_factory):
    return spawn_world(ref, 4, tmp_path_factory.mktemp("world4"))


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    if isinstance(x, np.ndarray):
        return [torch.from_numpy(x)]
    return [torch.tensor(x)]


# ---------------------------------------------------------------------------
# tests


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_return_the_same_bits(world, request):
    res = request.getfixturevalue(f"world{world}")
    first = leaves(res[0])
    for other in res[1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, leaves(other)))


@pytest.mark.parametrize("case", list(PSUM))
def test_psum_variant_matches_reference(case, ref, request):
    shape = PSUM[case][1]
    res = request.getfixturevalue(f"world{shape[0] * shape[1]}")[0]
    pose, xyz, costs = res[case]
    pose_j, xyz_j, costs_j = ref["psum"][case]
    assert xyz.shape == xyz_j.shape
    np.testing.assert_allclose(pose.numpy(), pose_j, atol=POSE_ATOL)
    np.testing.assert_allclose(costs.numpy(), costs_j, **COST)
    assert float(costs[-1]) < 1e-9        # clean data converges
    np.testing.assert_array_equal(
        pose[0].numpy(), ref["problems"][PSUM[case][0]][0][0])  # gauge


def test_psum_variant_matches_single_device(world4, ref):
    out, st = bundle_adjust(problem(ref["problems"]["A"]), iters=8)
    pose, _, costs = world4[0]["A_2x2"]
    np.testing.assert_allclose(pose.numpy(), out.cam_pose.numpy(),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(costs.numpy(), st.cost.numpy(), **COST)


def test_ring_matches_reference_and_single_device(world4, ref):
    r = world4[0]["ring"]
    pose_j, costs_j = ref["ring"]
    np.testing.assert_allclose(r["cam_pose"].numpy(), pose_j, atol=POSE_ATOL)
    np.testing.assert_allclose(r["costs"].numpy(), costs_j, **COST)
    out, st = bundle_adjust(problem(ref["problems"]["R"]), iters=RING_ITERS)
    np.testing.assert_allclose(r["cam_pose"].numpy(), out.cam_pose.numpy(),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(r["costs"].numpy(), st.cost.numpy(), **COST)
    assert float(r["costs"][-1]) < 1e-9


def test_ring_kernel_route_matches_plain_ring(world4):
    """use_kernels=True (B5's partials entry and B6; their plain versions
    on CPU tensors) walks the plain ring's trajectory."""
    r, k = world4[0]["ring"], world4[0]["ring_kernels"]
    for name in ("cam_pose", "point_xyz", "costs"):
        torch.testing.assert_close(k[name], r[name], rtol=0, atol=0)


@pytest.mark.parametrize("route", ["ring", "ring_kernels"])
def test_ring_moves_data_only_by_neighbour_exchange(world4, route):
    """The counterpart of test_ppermute_in_jaxpr: every byte the ring
    moves goes by neighbour send / receive, no collective is called,
    and the hops are (4 + 5 iters)(n - 1): two all-gathers for the first
    cost, five per LM step (cameras, reduce-scatter, rows, the cost's
    cameras and scalar), two for the result."""
    r = world4[0][route]
    assert r["collectives"] == {}
    assert r["hops"] == (4 + 5 * RING_ITERS) * (4 - 1)


def test_checkpoint_rerun_gives_the_same_bits(world4):
    c = world4[0]["ckpt"]
    ref_costs, bad_costs = c["ref"][2], c["bad"][2]
    assert float(bad_costs[0]) > 5 * float(ref_costs[0])
    for got, want in zip(c["rerun"], c["ref"]):
        assert torch.equal(got, want)


def test_merge_arenas_matches_reference_on_slam_maps(world4, ref):
    """The port's merge of the two JAX sequences' maps equals the JAX
    package's merge (b's poses right-composed with T^-1, points by T)."""
    got, want = world4[0]["gba"]["merged"], ref["merged"]
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=2e-6,
                                   err_msg=name)


def test_merged_global_ba_over_mesh_matches_reference(world4, ref):
    """global_bundle_adjust(mesh=(2, 2)) on the merged map against the
    JAX package's over (4, 2), and the reference's centre test."""
    g = world4[0]["gba"]
    want, costs_j = ref["gba"]
    np.testing.assert_allclose(g["costs"].numpy(), costs_j, **COST)
    assert g["costs"][-1] < g["costs"][0]
    np.testing.assert_allclose(g["out"]["frame_pose"], want["frame_pose"],
                               atol=POSE_ATOL)
    np.testing.assert_allclose(g["out"]["point_xyz"], want["point_xyz"],
                               atol=POSE_ATOL)
    from gslam_tpu_torch.core.se3 import se3_inverse

    n1 = int(ref["arenas"][0]["n_frames"])
    n = int(g["out"]["n_frames"])
    ctr = se3_inverse(torch.tensor(g["out"]["frame_pose"][:n, :7]))[:, :3]
    assert ctr[:n1, 0].abs().max() < 25.0 and ctr[n1:, 0].min() > 25.0
    px = g["out"]["point_xyz"][g["out"]["point_valid"]]
    assert px[:, 0].max() > 25.0


def test_sharded_track_batch_matches_reference(world2, ref):
    poses, n_inl, n_feat = world2[0]["track"]
    poses_j, n_inl_j, n_feat_j = ref["track"]
    assert poses.shape == (TRACK["B"], 7)
    np.testing.assert_array_equal(n_feat.numpy(), n_feat_j)
    assert np.abs(n_inl.numpy() - n_inl_j).max() <= 1
    np.testing.assert_allclose(poses.numpy(), poses_j, atol=1e-4)
    assert int(n_inl.min()) > 20


# ---------------------------------------------------------------------------
# merge_arenas on tests/test_map.py:233's arenas (TestMergeArenas), and the
# launch helpers, in this process


def mini_pair():
    from tests.test_map import TestMergeArenas
    from tests.test_torch_arena import jfields

    (a, xa), (b, xb) = (TestMergeArenas()._mini(s) for s in (0, 1))
    port = tuple(ta.arena_from_numpy(jfields(x), device="cpu")
                 for x in (a, b))
    return (a, b), port, (xa, xb)


def test_merge_arenas_matches_reference():
    import jax.numpy as jnp

    from gslam_tpu.map.arena import merge_arenas as j_merge
    from tests.test_torch_arena import assert_same

    (a, b), (ta_, tb), (xa, xb) = mini_pair()
    T = [1., 2., 3., 1, 0, 0, 0, 2.]
    m_j = j_merge(a, b, transform_b=jnp.asarray(T, jnp.float32))
    m_t = ta.merge_arenas(ta_, tb, transform_b=torch.tensor(T))
    assert_same(m_j, m_t)
    st = ta.arena_stats(m_t)
    assert st["n_frames"] == 2 and st["n_points"] == 10
    assert st["n_obs"] == 10 and not st["overflow"]
    np.testing.assert_allclose(m_t.point_xyz[5:10].numpy(),
                               2.0 * np.asarray(xb) + [1, 2, 3], rtol=1e-5)
    # each frame keeps its camera-coordinate view of its own points
    from gslam_tpu_torch.core.sim3 import sim3_apply

    before = sim3_apply(tb.frame_pose[0][None], torch.tensor(np.asarray(xb)))
    after = sim3_apply(m_t.frame_pose[1][None], m_t.point_xyz[5:10])
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-5,
                               atol=2e-6)
    assert_same(j_merge(a, b), ta.merge_arenas(ta_, tb))   # no transform


def test_merge_arenas_capacity_checks():
    _, (a, b), _ = mini_pair()
    with pytest.raises(ValueError, match="too small"):
        ta.merge_arenas(a, b, cap_frames=1)
    with pytest.raises(ValueError, match="kp capacity"):
        ta.merge_arenas(a, dataclasses.replace(b, cap_kps=b.cap_kps + 1))
    m = ta.merge_arenas(a, b, cap_frames=2, cap_points=10, cap_obs=10)
    assert (m.cap_frames, m.cap_points, m.cap_obs) == (2, 10, 10)


def test_initialize_distributed_one_process_is_a_no_op():
    launch.initialize_distributed()
    assert not dist.is_initialized() and launch.is_primary()
    with pytest.raises(ValueError):
        launch.initialize_distributed(num_processes=2)
    assert launch.default_backend("cpu") == "gloo"
    assert launch.default_backend("cuda") == "nccl"


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch.spawn(fail_on_rank_1, 2, device="cpu", timeout_s=120.0)


def fail_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 stops")
    return rank
