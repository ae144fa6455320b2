"""The port's map arena (gslam_tpu_torch.map.arena) against the JAX
package's (gslam_tpu.map.arena), operation by operation on the same
inputs made with numpy from a seed, capacities overflowing included.

Tolerances: every integer, boolean and copied float field equal; the
refreshed viewing normals to 1e-6 (float32 norms); the covisibility
neighbours, point-id slabs and redundancy masks equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.map import arena as ja
from gslam_tpu_torch import convert
from gslam_tpu_torch.map import arena as ta

torch.set_num_threads(2)
F, K, P, E = 5, 16, 40, 96


def jfields(a) -> dict:
    return {f.name: np.asarray(getattr(a, f.name))
            for f in dataclasses.fields(a)
            if f.name not in ("cap_frames", "cap_kps", "cap_points",
                              "cap_obs")}


def assert_same(j, t, float_atol=0.0):
    jf, tf = jfields(j), convert.arena_to_numpy(t)
    assert set(jf) == set(tf)
    for k in jf:
        assert tf[k].dtype == jf[k].dtype, k
        if jf[k].dtype.kind == "f" and float_atol:
            np.testing.assert_allclose(tf[k], jf[k], atol=float_atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)


def rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def build_pair(rng, n_frames=F + 1, n_batches=5):
    """The same history on both arenas: frames (one past capacity),
    point batches (past capacity), observation batches (past capacity).
    """
    j = ja.make_arena(F, K, P, E)
    t = ta.make_arena(F, K, P, E, device="cpu")
    assert_same(j, t)
    for f in range(n_frames):
        q = rng.normal(size=4)
        pose = np.concatenate([rng.normal(size=3), q / np.linalg.norm(q),
                               [1.0]]).astype(np.float32)
        uv = rng.uniform(0, 100, (K, 2)).astype(np.float32)
        meta = rng.normal(size=(K, 4)).astype(np.float32)
        desc = rand_desc(rng, K)
        depth = rng.uniform(1, 5, K).astype(np.float32)
        cnt = int(rng.integers(1, K + 1))
        j, fid_j = ja.insert_frame(j, jnp.asarray(pose), 0.1 * f,
                                   jnp.asarray(uv), jnp.asarray(meta),
                                   jnp.asarray(desc), cnt,
                                   kp_depth=jnp.asarray(depth))
        t, fid_t = ta.insert_frame(
            t, torch.tensor(pose), 0.1 * f, torch.tensor(uv),
            torch.tensor(meta), convert.desc_from_numpy(desc, "cpu"),
            torch.tensor(cnt), kp_depth=torch.tensor(depth))
        assert int(fid_t) == int(fid_j) == (f if f < F else -1)
    assert_same(j, t)
    for b in range(n_batches):
        N = 12
        xyz = rng.normal(size=(N, 3)).astype(np.float32)
        desc = rand_desc(rng, N)
        valid = rng.random(N) < 0.8
        nrm = rng.normal(size=(N, 3)).astype(np.float32)
        col = rng.random((N, 3)).astype(np.float32)
        ref = b % F
        j, ids_j = ja.insert_points(j, jnp.asarray(xyz), jnp.asarray(desc),
                                    jnp.asarray(valid), ref,
                                    normal=jnp.asarray(nrm),
                                    color=jnp.asarray(col))
        t, ids_t = ta.insert_points(
            t, torch.tensor(xyz), convert.desc_from_numpy(desc, "cpu"),
            torch.tensor(valid), ref, normal=torch.tensor(nrm),
            color=torch.tensor(col))
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        assert_same(j, t)
    n_pts = int(j.n_points)
    for b in range(6):
        N = 20
        pid = rng.integers(-3, n_pts, N).astype(np.int32)
        kp = rng.integers(0, K, N).astype(np.int32)
        valid = rng.random(N) < 0.9
        fid = b % F
        j = ja.add_observations(j, fid, jnp.asarray(pid), jnp.asarray(kp),
                                jnp.asarray(valid))
        t = ta.add_observations(t, fid, torch.tensor(pid), torch.tensor(kp),
                                torch.tensor(valid))
        assert_same(j, t)
    return j, t


@pytest.mark.parametrize("seed", [0, 1])
def test_insertions_to_capacity(seed):
    j, t = build_pair(np.random.default_rng(seed))
    st = ta.arena_stats(t)
    assert st == ja.arena_stats(j)
    # the capacity edge was reached on every store
    assert st["overflow"] and st["n_frames"] == F and st["n_points"] == P \
        and st["n_obs"] == E


def test_insert_points_last_slot():
    """Points landing exactly on the last slot: the reference's scatter
    lets the rows that do not write (aimed at the last slot too) win."""
    j = ja.make_arena(2, 4, 6, 8)
    t = ta.make_arena(2, 4, 6, 8, device="cpu")
    rng = np.random.default_rng(5)
    for n_valid in (3, 3, 2):
        xyz = rng.normal(size=(5, 3)).astype(np.float32)
        desc = rand_desc(rng, 5)
        valid = np.arange(5) < n_valid
        j, ij = ja.insert_points(j, jnp.asarray(xyz), jnp.asarray(desc),
                                 jnp.asarray(valid), 1)
        t, it = ta.insert_points(t, torch.tensor(xyz),
                                 convert.desc_from_numpy(desc, "cpu"),
                                 torch.tensor(valid), 1)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert_same(j, t)


def test_erase_and_covisibility():
    rng = np.random.default_rng(2)
    j, t = build_pair(rng)
    ids = np.asarray([3, -1, 7, 0, 7], np.int32)
    j = ja.erase_points(j, jnp.asarray(ids))
    t = ta.erase_points(t, torch.tensor(ids))
    assert_same(j, t)
    j = ja.erase_frame(j, jnp.asarray(2))
    t = ta.erase_frame(t, 2)
    assert_same(j, t)
    for f in range(F):
        for k, mc in ((2, 1), (4, 2), (3, 15)):
            nj, cj = ja.covisibility_topk(j, jnp.asarray(f), k, mc)
            nt, ct = ta.covisibility_topk(t, torch.tensor(f), k, mc)
            np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(
            ta.frame_point_ids(t, torch.tensor(f), 30).numpy(),
            np.asarray(ja.frame_point_ids(j, jnp.asarray(f), 30)))
        for slab, win in ((64, 3), (10, 2)):
            np.testing.assert_array_equal(
                ta.covis_union_ids(t, torch.tensor(f), slab, win,
                                   min_common=1).numpy(),
                np.asarray(ja.covis_union_ids(j, jnp.asarray(f), slab, win,
                                              min_common=1)))


def test_hygiene_passes():
    rng = np.random.default_rng(3)
    j, t = build_pair(rng)
    vis = rng.integers(0, 20, P).astype(np.int32)
    fnd = rng.integers(0, 4, P).astype(np.int32)
    j = j.replace(point_visible=jnp.asarray(vis), point_found=jnp.asarray(fnd))
    t = t.replace(point_visible=torch.tensor(vis),
                  point_found=torch.tensor(fnd))
    j = ja.cull_by_found_ratio(j, 10, 0.1)
    t = ta.cull_by_found_ratio(t, 10, 0.1)
    assert_same(j, t)
    for max_obs in (2, 8):
        jr = ja.refresh_points(j, max_obs=max_obs)
        tr = ta.refresh_points(t, max_obs=max_obs)
        assert_same(jr, tr, float_atol=1e-6)
    for mo, fr in ((1, 0.5), (3, 0.9)):
        np.testing.assert_array_equal(
            ta.redundant_frames(t, mo, fr).numpy(),
            np.asarray(ja.redundant_frames(j, mo, fr)))
    jc, mj = ja.compact_arena(j)
    tc, mt = ta.compact_arena(t)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert_same(jc, tc)


def test_save_load_across_packages(tmp_path):
    j, t = build_pair(np.random.default_rng(4))
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    ja.save_arena(j, pj)
    ta.save_arena(t, pt)
    assert_same(ja.load_arena(pt), ta.load_arena(pj, device="cpu"))
    assert ta.arena_stats(ta.load_arena(pt, device="cpu")) == \
        ja.arena_stats(j)
    # a checkpoint from before the tracking statistics existed
    z = dict(np.load(pj))
    del z["point_visible"], z["point_found"]
    old = str(tmp_path / "old.npz")
    np.savez(old, **z)
    assert_same(ja.load_arena(old), ta.load_arena(old, device="cpu"))


def test_set_rows_last_writer_wins():
    buf = torch.zeros(5)
    out = ta.set_rows(buf, torch.tensor([4, 1, 4, 4, 2]),
                      torch.tensor([9.0, 1.0, 2.0, 3.0, 7.0]))
    ref = jnp.zeros(5).at[jnp.asarray([4, 1, 4, 4, 2])].set(
        jnp.asarray([9.0, 1.0, 2.0, 3.0, 7.0]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert torch.equal(buf, torch.zeros(5))


def test_make_arena_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ta.make_arena(2, 4, 8, 8)


def test_covisibility_matrix_and_row():
    """Shared-landmark counts: the whole matrix and single rows, with an
    erased frame and erased points (integers: equal)."""
    j, t = build_pair(np.random.default_rng(5), n_frames=F, n_batches=3)
    j = ja.erase_frame(j, jnp.asarray(2))
    t = ta.erase_frame(t, 2)
    j = ja.erase_points(j, jnp.asarray([1, 5], jnp.int32))
    t = ta.erase_points(t, torch.tensor([1, 5], dtype=torch.int32))
    Cj = np.asarray(ja.covisibility_matrix(j))
    Ct = ta.covisibility_matrix(t)
    assert Ct.dtype == torch.int32 and Ct.shape == (F, F)
    np.testing.assert_array_equal(Ct.numpy(), Cj)
    assert Cj.max() > 0 and (np.diag(Cj) == 0).all() and (Cj[2] == 0).all()
    for f in range(F):
        rj = np.asarray(ja.covisibility_row(j, jnp.asarray(f)))
        for fid in (f, torch.tensor(f)):
            rt = ta.covisibility_row(t, fid)
            assert rt.dtype == torch.int32
            np.testing.assert_array_equal(rt.numpy(), rj)
        if f != 2:
            np.testing.assert_array_equal(rj, Cj[f])
