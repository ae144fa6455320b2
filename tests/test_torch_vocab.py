"""The port's vocabulary (gslam_tpu_torch.ops.vocab) against the JAX
package's (gslam_tpu.ops.vocab), same numpy inputs on both sides.

* word ids of the plain descent (the plain version of the B7 kernel)
  equal ``_transform_words`` AND the Pallas kernel in interpret mode,
  exactly, and ``_transform_words`` past the Pallas table cap;
  general-tree words equal on a pruned tree;
* ``train_vocabulary`` with one seed gives the identical tree;
* dense and sparse BoW vectors and the three scores agree to 1e-6
  (float32 sums taken in another order);
* every file format written by one package loads in the other with
  equal tables, and the committed DBoW2 artifact gives equal words.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.ops import vocab as JV
from gslam_tpu.ops.pallas.vocab import MAX_NODES, transform_words_pallas
from gslam_tpu_torch import convert
from gslam_tpu_torch.ops import vocab as TV
from gslam_tpu_torch.ops.cuda import vocab as kernel

torch.set_num_threads(2)

FORMATS = {
    "npz": ("save_vocabulary", "load_vocabulary", "voc.npz"),
    "binary": ("save_binary", "load_binary", "voc.bin"),
    "dbow3_text": ("save_dbow3_text", "load_dbow3_text", "voc.txt"),
    "dbow2_binary": ("save_dbow2_binary", "load_dbow2_binary", "voc.dbow2"),
}


def rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def to_port(voc_j) -> TV.Vocabulary:
    return convert.vocabulary_from_numpy(
        np.asarray(voc_j.node_desc), np.asarray(voc_j.word_weight),
        voc_j.k, voc_j.L,
        None if voc_j.children is None else np.asarray(voc_j.children),
        None if voc_j.leaf_word is None else np.asarray(voc_j.leaf_word),
        device="cpu")


def assert_same_voc(voc_t: TV.Vocabulary, voc_j) -> None:
    f = convert.vocabulary_to_numpy(voc_t)
    assert (f["k"], f["L"]) == (voc_j.k, voc_j.L)
    np.testing.assert_array_equal(f["node_desc"],
                                  np.asarray(voc_j.node_desc))
    np.testing.assert_array_equal(f["word_weight"],
                                  np.asarray(voc_j.word_weight))
    for name in ("children", "leaf_word"):
        a, b = f[name], getattr(voc_j, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b))


def pruned_tree(rng):
    """A general tree (k = 3, L = 3) with early leaves: node 2 is a leaf
    at level 1, node 5 a leaf at level 2; written in the DBoW2 layout."""
    parent = [0, 0, 0, 1, 1, 1, 3, 3, 3, 4, 4, 6, 6]     # nodes 1..13
    has_child = set(parent)
    n = len(parent) + 1
    children = np.full((n, 3), -1, np.int32)
    fill = np.zeros(n, int)
    for node, p in enumerate(parent, start=1):
        children[p, fill[p]] = node
        fill[p] += 1
    leaf = np.array([i not in has_child for i in range(n)])
    leaf[0] = False
    leaf_word = np.full(n, -1, np.int32)
    leaf_word[leaf] = np.arange(leaf.sum(), dtype=np.int32)
    nd = rand_desc(rng, n)
    ww = rng.uniform(0.1, 2.0, int(leaf.sum())).astype(np.float32)
    return nd, ww, children, leaf_word


@pytest.mark.parametrize("k,L", [(4, 3), (8, 3), (10, 2)])
def test_words_equal_reference_and_pallas_interpret(k, L):
    rng = np.random.default_rng(k * 10 + L)
    train = rand_desc(rng, 600)
    voc_j = JV.train_vocabulary(train, k=k, L=L, seed=1)
    voc_t = to_port(voc_j)
    # training descriptors and fresh ones, N not a multiple of any tile
    q = np.concatenate([train[:100], rand_desc(rng, 73)])
    valid = np.ones(len(q), bool)
    valid[7] = False
    gold = np.asarray(JV._transform_words(
        voc_j.node_desc, jnp.asarray(q), jnp.asarray(valid), k, L))
    pallas = np.asarray(transform_words_pallas(
        voc_j.node_desc, jnp.asarray(q), jnp.asarray(valid), k, L,
        interpret=True))
    q_t = convert.desc_from_numpy(q, "cpu")
    v_t = torch.tensor(valid)
    plain = TV._transform_words(voc_t.node_desc, q_t, v_t, k, L)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), gold)
    np.testing.assert_array_equal(plain.numpy(), pallas)
    assert plain[7] == -1 and (plain[valid] >= 0).all()
    # on CPU tensors the kernel's wrapper and the public route take the
    # plain version, and count no launch
    kernel.launches = 0
    for words in (kernel.transform_words_kernel(voc_t.node_desc, q_t, v_t,
                                                k, L),
                  TV.transform_words(voc_t, q_t, v_t, use_kernels=True),
                  TV.transform_words(voc_t, q_t, v_t)):
        np.testing.assert_array_equal(words.numpy(), gold)
    assert kernel.launches == 0


@pytest.mark.parametrize("k,L", [(10, 5), (20, 3), (200, 2)])
def test_deep_tree_words_equal_reference(k, L):
    """Trees past the Pallas kernel's 8192-node cap (111,111, 8,421 and
    40,201 nodes), of which the B7 kernel holds some top levels, one or
    none: the first two children of every node are equal, so every
    level holds ties; a third of the queries are node centres."""
    rng = np.random.default_rng(17)
    n = JV._level_offset(k, L + 1)
    nodes = rand_desc(rng, n)
    for l in range(1, L + 1):
        lo, hi = JV._level_offset(k, l), JV._level_offset(k, l + 1)
        nodes[lo + 1:hi:k] = nodes[lo:hi:k]
    q = rand_desc(rng, 300)
    q[:100] = nodes[rng.integers(1, n, 100)]
    valid = rng.random(300) < 0.9
    assert n > MAX_NODES
    gold = np.asarray(JV._transform_words(
        jnp.asarray(nodes), jnp.asarray(q), jnp.asarray(valid), k, L))
    nodes_t = convert.desc_from_numpy(nodes, "cpu")
    q_t, v_t = convert.desc_from_numpy(q, "cpu"), torch.tensor(valid)
    for words in (TV._transform_words(nodes_t, q_t, v_t, k, L),
                  kernel.transform_words_kernel(nodes_t, q_t, v_t, k, L)):
        assert words.dtype == torch.int32
        np.testing.assert_array_equal(words.numpy(), gold)
    assert (gold[~valid] == -1).all() and len(np.unique(gold)) > 200


def test_general_tree_words_equal():
    rng = np.random.default_rng(3)
    nd, ww, children, leaf_word = pruned_tree(rng)
    voc_j = JV.Vocabulary(jnp.asarray(nd), jnp.asarray(ww), 3, 3,
                          jnp.asarray(children), jnp.asarray(leaf_word))
    voc_t = to_port(voc_j)
    q = rand_desc(rng, 157)
    valid = rng.random(157) < 0.9
    gold = np.asarray(JV.transform_words(voc_j, jnp.asarray(q),
                                         jnp.asarray(valid)))
    out = TV.transform_words(voc_t, convert.desc_from_numpy(q, "cpu"),
                             torch.tensor(valid), use_kernels=True)
    np.testing.assert_array_equal(out.numpy(), gold)
    assert set(np.unique(gold)) - {-1} == set(range(len(ww)))


@pytest.mark.parametrize("k,L,n", [(6, 2, 700), (3, 3, 150), (4, 2, 9)])
def test_train_vocabulary_identical(k, L, n):
    """One seed, one tree: the host random stream and the tie rules of
    both distance passes are the JAX package's (n = 9 leaves clusters
    empty, which draws the re-seeding branch)."""
    train = rand_desc(np.random.default_rng(n), n)
    train[: n // 3] = train[0] ^ (np.arange(n // 3, dtype=np.uint32)
                                  [:, None] & 3)         # a tight cloud
    voc_j = JV.train_vocabulary(train, k=k, L=L, seed=5, iters=4)
    voc_t = TV.train_vocabulary(train, k=k, L=L, seed=5, iters=4,
                                device="cpu")
    assert_same_voc(voc_t, voc_j)


def test_bow_vectors_and_scores():
    rng = np.random.default_rng(11)
    train = rand_desc(rng, 500)
    voc_j = JV.train_vocabulary(train, k=5, L=2, seed=0)
    voc_t = to_port(voc_j)
    sets = [np.concatenate([train[i * 60:(i + 1) * 60], rand_desc(rng, 20)])
            for i in range(4)]
    valids = [rng.random(80) < 0.9 for _ in sets]
    bows_j, bows_t, sp_j, sp_t = [], [], [], []
    for q, v in zip(sets, valids):
        q_t, v_t = convert.desc_from_numpy(q, "cpu"), torch.tensor(v)
        bj, wj = JV.transform(voc_j, jnp.asarray(q), jnp.asarray(v))
        bt, wt = TV.transform(voc_t, q_t, v_t)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6)
        sj, wj2 = JV.transform_sparse(voc_j, jnp.asarray(q), jnp.asarray(v))
        st, wt2 = TV.transform_sparse(voc_t, q_t, v_t)
        np.testing.assert_array_equal(wt2.numpy(), np.asarray(wj2))
        np.testing.assert_array_equal(st.words.numpy(),
                                      np.asarray(sj.words))
        np.testing.assert_allclose(st.weights.numpy(),
                                   np.asarray(sj.weights), atol=1e-6)
        assert st.words.dtype == torch.int32
        bows_j.append(bj), bows_t.append(bt), sp_j.append(sj), sp_t.append(st)
    # no valid argument: every descriptor counts
    b_all, _ = TV.transform(voc_t, convert.desc_from_numpy(sets[0], "cpu"))
    np.testing.assert_allclose(
        b_all.numpy(), np.asarray(JV.transform(voc_j,
                                               jnp.asarray(sets[0]))[0]),
        atol=1e-6)
    db_j, db_t = jnp.stack(bows_j[1:]), torch.stack(bows_t[1:])
    for name in ("score_l1", "score_l2"):
        np.testing.assert_allclose(
            getattr(TV, name)(bows_t[0], db_t).numpy(),
            np.asarray(getattr(JV, name)(bows_j[0], db_j)), atol=1e-6)
    dbw = np.stack([np.asarray(s.words) for s in sp_j[1:]])
    dbx = np.stack([np.asarray(s.weights) for s in sp_j[1:]])
    s_t = TV.score_l1_sparse(sp_t[0], torch.tensor(dbw), torch.tensor(dbx),
                             voc_t.n_words)
    s_j = JV.score_l1_sparse(sp_j[0], dbw, dbx, voc_j.n_words)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    # the sparse score is the dense L1 score
    np.testing.assert_allclose(
        s_t.numpy(), TV.score_l1(bows_t[0], db_t).numpy(), atol=1e-6)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_formats_cross(fmt, writer, tmp_path):
    save, load, fname = FORMATS[fmt]
    train = rand_desc(np.random.default_rng(2), 300)
    voc_j = JV.train_vocabulary(train, k=3, L=3, seed=0, iters=3)
    voc_t = to_port(voc_j)
    path = str(tmp_path / fname)
    if writer == "jax":
        getattr(JV, save)(voc_j, path)
        got_t = getattr(TV, load)(path, device="cpu")
        ref_j = getattr(JV, load)(path)
        assert_same_voc(got_t, ref_j)
    else:
        getattr(TV, save)(voc_t, path)
        got_j = getattr(JV, load)(path)
        assert_same_voc(getattr(TV, load)(path, device="cpu"), got_j)
        np.testing.assert_array_equal(np.asarray(got_j.node_desc),
                                      np.asarray(voc_j.node_desc))
        np.testing.assert_allclose(np.asarray(got_j.word_weight),
                                   np.asarray(voc_j.word_weight), rtol=1e-6)


def test_general_tree_file_round_trip(tmp_path):
    """A pruned tree written by either package's DBoW2 writer loads in
    the other with the same tables; the two files are the same bytes."""
    nd, ww, children, leaf_word = pruned_tree(np.random.default_rng(9))
    voc_j = JV.Vocabulary(jnp.asarray(nd), jnp.asarray(ww), 3, 3,
                          jnp.asarray(children), jnp.asarray(leaf_word))
    pj, pt = str(tmp_path / "j.dbow2"), str(tmp_path / "t.dbow2")
    JV.save_dbow2_binary(voc_j, pj)
    TV.save_dbow2_binary(to_port(voc_j), pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert_same_voc(TV.load_dbow2_binary(pj, device="cpu"),
                    JV.load_dbow2_binary(pt))


def test_bad_tables_are_refused(tmp_path):
    with pytest.raises(ValueError, match="complete"):
        convert.vocabulary_from_numpy(np.zeros((5, 8), np.uint32),
                                      np.zeros(4, np.float32), 2, 2,
                                      device="cpu")
    with pytest.raises(ValueError, match="come together"):
        convert.vocabulary_from_numpy(np.zeros((7, 8), np.uint32),
                                      np.zeros(4, np.float32), 2, 2,
                                      children=np.zeros((7, 2), np.int32),
                                      device="cpu")
    p = tmp_path / "junk.bin"
    p.write_bytes(b"NOTAVOC!" + bytes(64))
    with pytest.raises(ValueError, match="not a gslam"):
        TV.load_binary(str(p), device="cpu")


def test_committed_dbow2_artifact_words():
    """The committed 10^6-word tree loads in the port as a general tree
    and gives the JAX package's words."""
    path = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "voc_1m.dbow2")
    voc_t = TV.load_dbow2_binary(path, device="cpu")
    voc_j = JV.load_dbow2_binary(path)
    assert voc_t.n_words == voc_j.n_words == 1_000_000
    assert voc_t.children is not None
    q = rand_desc(np.random.default_rng(4), 200)
    valid = np.ones(200, bool)
    valid[::17] = False
    gold = np.asarray(JV.transform_words(voc_j, jnp.asarray(q),
                                         jnp.asarray(valid)))
    out = TV.transform_words(voc_t, convert.desc_from_numpy(q, "cpu"),
                             torch.tensor(valid), use_kernels=True)
    np.testing.assert_array_equal(out.numpy(), gold)
    assert len(np.unique(gold)) > 100
