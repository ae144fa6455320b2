"""Bag-of-words vocabulary for place recognition.

Counterpart of ``gslam_tpu/ops/vocab.py``: a k-ary tree over binary
descriptors (DBoW2 / DBoW3 compatible), trained offline by hierarchical
binary k-means, TF-IDF BoW vectors in a dense and a fixed-slot sparse
form, L1 / L2 scoring, and four file formats that both packages read
and write.

* a *complete* tree is a level-major node table, so the descent is L
  gather-then-argmin steps over (N, k) Hamming distances;
  :func:`_transform_words` is that descent in PyTorch operations and the
  plain version of the descent kernel (B7,
  :mod:`gslam_tpu_torch.ops.cuda.vocab`);
* a *general* tree (a loaded DBoW2 tree, possibly pruned) follows an
  explicit child table in PyTorch operations, in both packages;
* training runs on the host in numpy with the same
  ``np.random.default_rng(seed)`` stream as the JAX package; only the
  two distance passes run as tensor functions on ``device``.

Descriptors and node centres are int32 tensors carrying the uint32 bit
pattern.  The scatter-adds here are bit-stable on the card although
``index_add`` is atomic there: every addend of one slot has the same
value (one word's weight, or zero), so the order cannot matter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gslam_tpu_torch.map.arena import _popcount32
from gslam_tpu_torch.ops.frontend import DESC_WORDS
from gslam_tpu_torch.utils.platform import require_device


class Vocabulary(NamedTuple):
    """k-ary BoW tree.

    Two layouts share this type:

    * **complete** (the trained / default layout): level-major node
      table; level l occupies [(k^l - 1)/(k-1), (k^(l+1) - 1)/(k-1));
      ``children`` / ``leaf_word`` are None and child indices are
      arithmetic.
    * **general** (loaded DBoW2 trees, possibly pruned with early
      leaves): explicit ``children`` (n_nodes, k) int32 table (-1 = no
      child) and ``leaf_word`` (n_nodes,) int32 word id per leaf (-1 for
      interior nodes).

    node_desc: (n_nodes, DESC_WORDS) int32, per-node cluster centre.
    word_weight: (n_words,) float32, IDF weight per leaf word.
    k, L: branching factor and depth (Python ints).
    """

    node_desc: torch.Tensor
    word_weight: torch.Tensor
    k: int
    L: int
    children: Optional[torch.Tensor] = None
    leaf_word: Optional[torch.Tensor] = None

    @property
    def n_words(self) -> int:
        return int(self.word_weight.shape[0])

    @property
    def device(self) -> torch.device:
        return self.node_desc.device


class SparseBow(NamedTuple):
    """Sparse BowVector: up to S (word id, TF-IDF weight) pairs, S * 8
    bytes per frame at any vocabulary size.

    words: (S,) int32, valid entries first in ascending word order, -1
        in the empty slots.
    weights: (S,) float32, L1-normalized over the valid slots, 0 in the
        empty ones.
    """

    words: torch.Tensor
    weights: torch.Tensor


def _level_offset(k: int, l: int) -> int:
    """Index of the first node of level l (root = level 0 at index 0)."""
    return (k ** l - 1) // (k - 1)


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise-broadcast Hamming distance of packed descriptors:
    popcount(xor) summed over the last (word) axis, int32."""
    return _popcount32(a ^ b).sum(-1).to(torch.int32)


def vocabulary_from_numpy(node_desc: np.ndarray, word_weight: np.ndarray,
                          k: int, L: int,
                          children: Optional[np.ndarray] = None,
                          leaf_word: Optional[np.ndarray] = None,
                          device="cuda") -> Vocabulary:
    """A :class:`Vocabulary` on ``device`` from the JAX package's arrays
    as numpy (uint32 node words, float32 weights, optional int32 child
    and leaf tables)."""
    dev = require_device(device)
    nd = np.ascontiguousarray(np.asarray(node_desc), np.uint32)
    if nd.ndim != 2 or nd.shape[1] != DESC_WORDS:
        raise ValueError(f"node_desc must be (n_nodes, {DESC_WORDS}), got "
                         f"{nd.shape}")
    if (children is None) != (leaf_word is None):
        raise ValueError("children and leaf_word come together")
    if children is None and nd.shape[0] != _level_offset(int(k), int(L) + 1):
        raise ValueError(
            f"a complete k={k}, L={L} tree has "
            f"{_level_offset(int(k), int(L) + 1)} nodes, got {nd.shape[0]}")

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    return Vocabulary(
        node_desc=torch.from_numpy(nd.view(np.int32).copy()).to(dev),
        word_weight=t(word_weight, np.float32), k=int(k), L=int(L),
        children=None if children is None else t(children, np.int32),
        leaf_word=None if leaf_word is None else t(leaf_word, np.int32))


def vocabulary_to_numpy(voc: Vocabulary) -> dict:
    """The fields of ``voc`` as numpy in the JAX package's dtypes (node
    words as uint32); ``children`` / ``leaf_word`` None for a complete
    tree."""
    def n(t):
        return None if t is None else t.detach().cpu().numpy()

    return dict(
        node_desc=n(voc.node_desc).astype(np.int32).view(np.uint32),
        word_weight=n(voc.word_weight), k=voc.k, L=voc.L,
        children=n(voc.children), leaf_word=n(voc.leaf_word))


# ---------------------------------------------------------------------------
# transform


def _transform_words(node_desc: torch.Tensor, desc: torch.Tensor,
                     valid: torch.Tensor, k: int, L: int) -> torch.Tensor:
    """Descend a complete tree: (N, W) packed descriptors -> (N,) int32
    word ids, -1 where invalid; ties go to the lowest child.  The plain
    version of the descent kernel (B7)."""
    N = desc.shape[0]
    node = torch.zeros(N, dtype=torch.long, device=desc.device)
    ar = torch.arange(k, device=desc.device)
    for l in range(L):
        child_idx = _level_offset(k, l + 1) + node[:, None] * k + ar[None, :]
        d = hamming_packed(node_desc[child_idx], desc[:, None, :])  # (N, k)
        node = node * k + torch.argmin(d, dim=-1)      # first minimum
    return torch.where(valid, node, -1).to(torch.int32)


def _transform_words_tree(node_desc: torch.Tensor, children: torch.Tensor,
                          leaf_word: torch.Tensor, desc: torch.Tensor,
                          valid: torch.Tensor, L: int) -> torch.Tensor:
    """General-tree descent (pruned DBoW trees with early leaves):
    follow the explicit child table; a node with no children is a leaf
    and the descent parks there."""
    N = desc.shape[0]
    node = torch.zeros(N, dtype=torch.long, device=desc.device)
    for _ in range(L):
        ch = children[node].long()                      # (N, k)
        ok = ch >= 0
        d = hamming_packed(node_desc[ch.clamp_min(0)], desc[:, None, :])
        d = torch.where(ok, d, 1 << 30)
        best = torch.argmin(d, dim=-1, keepdim=True)    # first minimum
        nxt = torch.take_along_dim(ch, best, 1)[:, 0]
        node = torch.where(ok.any(-1), nxt, node)
    w = leaf_word[node]
    return torch.where(valid & (w >= 0), w, -1).to(torch.int32)


def transform_words(voc: Vocabulary, desc: torch.Tensor,
                    valid: torch.Tensor, use_kernels: bool = False
                    ) -> torch.Tensor:
    """(N,) leaf word id per descriptor (-1 for invalid).

    Routing is a rule of the tree's layout: a general tree (explicit
    ``children``) descends in PyTorch operations; a complete tree goes
    through the descent kernel (B7) when ``use_kernels`` (its wrapper
    takes the plain version on CPU tensors), else through the plain
    :func:`_transform_words`."""
    if voc.children is not None:
        return _transform_words_tree(voc.node_desc, voc.children,
                                     voc.leaf_word, desc, valid, voc.L)
    if use_kernels:
        from gslam_tpu_torch.ops.cuda.vocab import transform_words_kernel

        return transform_words_kernel(voc.node_desc, desc, valid, voc.k,
                                      voc.L)
    return _transform_words(voc.node_desc, desc, valid, voc.k, voc.L)


def _word_weights(voc: Vocabulary, words: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    w = voc.word_weight[words.clamp_min(0).long()]
    return torch.where(valid & (words >= 0), w, torch.zeros_like(w))


def transform(voc: Vocabulary, desc: torch.Tensor,
              valid: Optional[torch.Tensor] = None,
              use_kernels: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense BowVector (n_words,) L1-normalized TF-IDF + word ids (N,).
    Fine for small vocabularies; :func:`transform_sparse` scales."""
    if valid is None:
        valid = torch.ones(desc.shape[0], dtype=torch.bool,
                           device=desc.device)
    words = transform_words(voc, desc, valid, use_kernels=use_kernels)
    bow = torch.zeros(voc.n_words, device=desc.device).index_add(
        0, words.clamp_min(0).long(), _word_weights(voc, words, valid))
    return bow / bow.abs().sum().clamp_min(1e-12), words


def _sparsify_words(words: torch.Tensor, w: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dedup (word, weight) pairs: stable sort by word, sum runs,
    L1-normalize, valid entries compacted to the front."""
    S = words.shape[0]
    sent = 2 ** 30                              # sorts after any word id
    key = torch.where(words >= 0, words, sent)
    sw, order = torch.sort(key, stable=True)
    ww = torch.where(words >= 0, w, torch.zeros_like(w))[order]
    pos = torch.arange(S, device=words.device)
    first = (sw != torch.roll(sw, 1)) | (pos == 0)
    seg = torch.cumsum(first.to(torch.long), 0) - 1     # run id per slot
    sums = torch.zeros(S, dtype=w.dtype, device=w.device).index_add(
        0, seg, ww)
    out_w = torch.where(first & (sw < sent), sums[seg],
                        torch.zeros_like(sums))
    out_words = torch.where(out_w > 0, sw, -1)
    norm = out_w.sum().clamp_min(1e-12)
    comp = torch.argsort((out_words < 0).to(torch.int32), stable=True)
    return out_words[comp].to(torch.int32), out_w[comp] / norm


def transform_sparse(voc: Vocabulary, desc: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     use_kernels: bool = False
                     ) -> Tuple[SparseBow, torch.Tensor]:
    """SparseBow + per-descriptor word ids: O(S) memory at any
    vocabulary size."""
    if valid is None:
        valid = torch.ones(desc.shape[0], dtype=torch.bool,
                           device=desc.device)
    words = transform_words(voc, desc, valid, use_kernels=use_kernels)
    sw, swt = _sparsify_words(words, _word_weights(voc, words, valid))
    return SparseBow(sw, swt), words


def score_l1_sparse(q: SparseBow, db_words: torch.Tensor,
                    db_weights: torch.Tensor, n_words: int) -> torch.Tensor:
    """DBoW L1 score of one SparseBow against a sparse database
    (F, S) -> (F,).

    For L1-normalized non-negative vectors 1 - 0.5 |a - b|_1 equals the
    sum of elementwise minima over the common words: the query is
    scattered into a transient dense (n_words,) vector and gathered at
    the database's word slots, O(F S) whatever the vocabulary size."""
    qd = torch.zeros(n_words, dtype=q.weights.dtype,
                     device=q.weights.device).index_add(
        0, q.words.clamp_min(0).long(),
        torch.where(q.words >= 0, q.weights, torch.zeros_like(q.weights)))
    g = qd[db_words.clamp_min(0).long()]                 # (F, S) gather
    g = torch.where(db_words >= 0, g, torch.zeros_like(g))
    return torch.minimum(g, db_weights).sum(-1)


def score_l1(bow_a: torch.Tensor, bow_db: torch.Tensor) -> torch.Tensor:
    """DBoW L1 score of one dense BoW against a database (D, n_words)."""
    return torch.minimum(bow_a[None, :], bow_db).sum(-1)


def score_l2(bow_a: torch.Tensor, bow_db: torch.Tensor) -> torch.Tensor:
    """Cosine score of one dense BoW against a database (D, n_words)."""
    na = torch.linalg.vector_norm(bow_a).clamp_min(1e-12)
    nb = torch.linalg.vector_norm(bow_db, dim=-1).clamp_min(1e-12)
    return (bow_db @ bow_a) / (na * nb)


# ---------------------------------------------------------------------------
# training (host numpy; the two distance passes on the device)


def _unpack_bits_np(desc: np.ndarray) -> np.ndarray:
    """(N, W) uint32 -> (N, W*32) uint8 bits, LSB first per word."""
    d = np.ascontiguousarray(desc.astype('<u4'))
    return np.unpackbits(d.view(np.uint8), axis=1, bitorder="little")


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    N, B = bits.shape
    W = B // 32
    w = bits.reshape(N, W, 32).astype(np.uint32)
    return (w << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)


def _assign_chunk(packed: torch.Tensor, gid: torch.Tensor,
                  centres: torch.Tensor, k: int) -> torch.Tensor:
    """Per-descriptor nearest of ITS group's k centres: packed (C, W),
    gid (C,) group ids, centres (G*k, W) -> (C,) child index in [0, k),
    ties to the lowest child."""
    idx = gid[:, None] * k + torch.arange(k, device=gid.device)[None, :]
    d = hamming_packed(packed[:, None, :], centres[idx])     # (C, k)
    return torch.argmin(d, dim=1)


def _dist_to_seed(packed: torch.Tensor, seed_desc: torch.Tensor
                  ) -> torch.Tensor:
    """Hamming distance of each descriptor to its group's latest seed
    (gathered per row)."""
    return hamming_packed(packed, seed_desc)


def _words_tensor(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(a, np.uint32).view(np.int32)).to(dev)


def train_vocabulary(desc: np.ndarray, k: int = 8, L: int = 3,
                     seed: int = 0, iters: int = 8,
                     device="cuda") -> Vocabulary:
    """Hierarchical binary k-means over (N, W) uint32 descriptors, every
    group of a level trained at once:

    * kmeans++-style seeding: each round computes all descriptors'
      distance to their group's latest seed in one pass on ``device``,
      then draws one D^2-weighted sample per group on the host;
    * Lloyd assignment: one chunked pass on ``device``
      (:func:`_assign_chunk`), each descriptor against its own group's k
      centres;
    * centre update: majority vote through a (group * k + child) sort
      and segment sums of the unpacked bit matrix, on the host.

    The random stream is ``np.random.default_rng(seed)`` drawn in the
    JAX package's order, so one seed gives the same tree in both."""
    dev = require_device(device)
    rng = np.random.default_rng(seed)
    packed_np = np.ascontiguousarray(np.asarray(desc, np.uint32))
    N, W = packed_np.shape
    B = W * 32
    bits = _unpack_bits_np(packed_np) if N else np.zeros((0, B), np.uint8)
    packed = _words_tensor(packed_np, dev)
    n_nodes = _level_offset(k, L + 1)
    node_bits = np.zeros((n_nodes, B), np.uint8)

    gid = np.zeros(N, np.int64)          # group of each descriptor
    chunk = 1 << 17

    def assign_all(centres_packed, gid_np):
        cj = _words_tensor(centres_packed, dev)
        out = np.empty(N, np.int32)
        for s in range(0, N, chunk):
            e = min(N, s + chunk)
            gc = torch.from_numpy(gid_np[s:e]).to(dev)
            out[s:e] = _assign_chunk(packed[s:e], gc, cj, k).cpu().numpy()
        return out

    for l in range(L):
        G = k ** l
        off = _level_offset(k, l + 1)
        # group-sorted layout: contiguous slices per group
        order = np.argsort(gid, kind="stable")
        bounds = np.searchsorted(gid[order], np.arange(G + 1))
        centres = np.zeros((G * k, W), np.uint32)

        # ---- seeding: kmeans++ across all groups per round ----------
        d_min = np.full(N, np.iinfo(np.int32).max, np.int64)
        seed_of_group = np.zeros((G, W), np.uint32)
        for j in range(k):
            for g in range(G):
                lo, hi = bounds[g], bounds[g + 1]
                if hi <= lo:
                    centres[g * k + j] = rng.integers(
                        0, 2 ** 32, W, dtype=np.uint64).astype(np.uint32)
                    continue
                sl = order[lo:hi]
                if j == 0:
                    pick = sl[rng.integers(hi - lo)]
                else:
                    # D^2 weighting: linear weights let two seeds land
                    # in one well-separated cloud
                    wts = d_min[sl].astype(np.float64) ** 2 + 1e-3
                    pick = sl[rng.choice(hi - lo, p=wts / wts.sum())]
                centres[g * k + j] = packed_np[pick]
                seed_of_group[g] = packed_np[pick]
            if j < k - 1 and N:
                d = _dist_to_seed(
                    packed, _words_tensor(seed_of_group[gid], dev))
                d_min = np.minimum(d_min, d.cpu().numpy())

        # ---- Lloyd iterations over every group at once --------------
        child = np.zeros(N, np.int32)
        for _ in range(iters):
            child = assign_all(centres, gid)
            cid = gid * k + child
            o2 = np.argsort(cid, kind="stable")
            seg = np.searchsorted(cid[o2], np.arange(G * k + 1))
            sizes = (seg[1:] - seg[:-1])
            # segment bit-sums over the sorted bit matrix: a column-
            # blocked cumsum and boundary differences (exact)
            sums = np.zeros((G * k, B), np.int64)
            if N:
                bo = bits[o2]
                for c0 in range(0, B, 64):
                    cs = np.zeros((N + 1, 64), np.int32)
                    np.cumsum(bo[:, c0:c0 + 64], axis=0,
                              dtype=np.int32, out=cs[1:])
                    sums[:, c0:c0 + 64] = (cs[seg[1:]]
                                           - cs[seg[:-1]])
            maj = (sums * 2 >= sizes[:, None]).astype(np.uint8)
            keep = sizes > 0
            new_packed = _pack_bits_np(maj)
            centres = np.where(keep[:, None], new_packed, centres)
            # an empty cluster is re-seeded from a random member of its
            # (non-empty) group
            for c in np.nonzero(~keep)[0]:
                g = c // k
                lo, hi = bounds[g], bounds[g + 1]
                if hi > lo:
                    centres[c] = packed_np[order[lo + rng.integers(
                        hi - lo)]]
        node_bits[off:off + G * k] = _unpack_bits_np(centres)
        gid = gid * k + child

    # IDF weights: ln(N_docs / n_i) approximated with descriptor counts
    n_words = k ** L
    counts = np.bincount(gid, minlength=n_words) if N else \
        np.zeros(n_words)
    idf = np.log(max(N, 1) / np.maximum(counts, 1.0))
    return vocabulary_from_numpy(_pack_bits_np(node_bits),
                                 idf.astype(np.float32), k, L, device=dev)


# ---------------------------------------------------------------------------
# persistence (the JAX package's four formats, byte for byte)


def save_vocabulary(voc: Vocabulary, path: str) -> None:
    """npz of a complete tree (node table, weights, k, L)."""
    f = vocabulary_to_numpy(voc)
    np.savez_compressed(path, node_desc=f["node_desc"],
                        word_weight=f["word_weight"], k=voc.k, L=voc.L)


def load_vocabulary(path: str, device="cuda") -> Vocabulary:
    with np.load(path) as z:
        return vocabulary_from_numpy(z["node_desc"], z["word_weight"],
                                     int(z["k"]), int(z["L"]), device=device)


_VOC_MAGIC = b"GSLAMVOC"
_VOC_VERSION = 1


def save_binary(voc: Vocabulary, path: str) -> None:
    """Flat binary vocabulary: 8-byte magic, u32 version, u32 k, u32 L,
    u32 descriptor bytes per node, then the node table as raw
    little-endian uint32 words, then the leaf weights as raw float32."""
    f = vocabulary_to_numpy(voc)
    nd = np.ascontiguousarray(f["node_desc"], np.uint32)
    ww = np.ascontiguousarray(f["word_weight"], np.float32)
    with open(path, "wb") as fh:
        fh.write(_VOC_MAGIC)
        np.asarray([_VOC_VERSION, voc.k, voc.L, nd.shape[1] * 4],
                   np.uint32).tofile(fh)
        nd.tofile(fh)
        ww.tofile(fh)


def load_binary(path: str, device="cuda") -> Vocabulary:
    """Load a :func:`save_binary` vocabulary."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:8] != _VOC_MAGIC:
        raise ValueError(f"not a gslam binary vocabulary: {path}")
    ver, k, L, dbytes = np.frombuffer(buf, np.uint32, 4, 8)
    if ver != _VOC_VERSION:
        raise ValueError(f"unsupported vocabulary version {ver}")
    k, L = int(k), int(L)
    n_nodes = _level_offset(k, L + 1)
    words = int(dbytes) // 4
    off = 8 + 16
    nd = np.frombuffer(buf, np.uint32, n_nodes * words, off) \
        .reshape(n_nodes, words)
    ww = np.frombuffer(buf, np.float32, k ** L, off + nd.nbytes)
    return vocabulary_from_numpy(nd, ww, k, L, device=device)


def save_dbow3_text(voc: Vocabulary, path: str) -> None:
    """DBoW3 text layout: first line 'k L scoring weighting', then one
    line per non-root node, 'parent_id is_leaf d0 ... d31 weight'
    (descriptor bytes), in complete-tree node order."""
    f = vocabulary_to_numpy(voc)
    nd, ww = f["node_desc"], f["word_weight"]
    k, L = voc.k, voc.L
    lines = [f"{k} {L} 0 0"]
    for l in range(1, L + 1):
        off = _level_offset(k, l)
        for i in range(k ** l):
            parent = _level_offset(k, l - 1) + i // k if l > 1 else 0
            is_leaf = 1 if l == L else 0
            by = np.ascontiguousarray(nd[off + i]).view(np.uint8)
            w = ww[i] if l == L else 0.0
            lines.append(f"{parent} {is_leaf} "
                         + " ".join(str(int(b)) for b in by)
                         + f" {w}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def load_dbow3_text(path: str, device="cuda") -> Vocabulary:
    """Parse the DBoW3 text format (a complete tree, as
    :func:`save_dbow3_text` and standard DBoW3 dumps write it)."""
    with open(path) as fh:
        header = fh.readline().split()
        k, L = int(header[0]), int(header[1])
        n_nodes = _level_offset(k, L + 1)
        nd = np.zeros((n_nodes, DESC_WORDS), np.uint32)
        ww = np.zeros(k ** L, np.float32)
        idx = 1
        for line in fh:
            parts = line.split()
            if len(parts) < 3:
                continue
            is_leaf = int(parts[1])
            by = np.asarray([int(x) for x in parts[2:2 + 32]], np.uint8)
            nd[idx] = by.view(np.uint32)
            if is_leaf:
                ww[idx - _level_offset(k, L)] = float(parts[-1])
            idx += 1
    return vocabulary_from_numpy(nd, ww, k, L, device=device)


_DBOW2_REC = np.dtype([("parent", "<i4"), ("desc", "u1", (32,)),
                       ("weight", "<f4"), ("leaf", "u1")])  # 41 bytes


def save_dbow2_binary(voc: Vocabulary, path: str) -> None:
    """The ORB-SLAM community binary vocabulary format: header
    [nb_nodes u32, size_node u32, k i32, L i32], then one 41-byte record
    per non-root node in node-id order: parent i32, 32 descriptor bytes,
    weight f32, is_leaf u8."""
    f = vocabulary_to_numpy(voc)
    nd = np.ascontiguousarray(f["node_desc"], np.uint32)
    ww = np.asarray(f["word_weight"], np.float32)
    n_nodes = nd.shape[0]
    rec = np.zeros(n_nodes - 1, _DBOW2_REC)
    if voc.children is not None:
        ch, lw = f["children"], f["leaf_word"]
        pid = np.repeat(np.arange(n_nodes, dtype=np.int32), ch.shape[1])
        cid = ch.ravel()
        parent = np.full(n_nodes, -1, np.int32)
        parent[cid[cid >= 0]] = pid[cid >= 0]
        rec["parent"] = parent[1:]
        rec["leaf"] = (lw[1:] >= 0).astype(np.uint8)
        rec["weight"] = np.where(lw[1:] >= 0, ww[lw[1:].clip(0)], 0.0)
    else:
        k, L = voc.k, voc.L
        for l in range(1, L + 1):
            off = _level_offset(k, l)
            idx = np.arange(k ** l)
            rec["parent"][off - 1 + idx] = \
                (_level_offset(k, l - 1) + idx // k) if l > 1 else 0
            rec["leaf"][off - 1 + idx] = 1 if l == L else 0
            if l == L:
                rec["weight"][off - 1 + idx] = ww[idx]
    rec["desc"] = nd[1:].view(np.uint8).reshape(n_nodes - 1, -1)
    with open(path, "wb") as fh:
        np.asarray([n_nodes, _DBOW2_REC.itemsize], np.uint32).tofile(fh)
        np.asarray([voc.k, voc.L], np.int32).tofile(fh)
        rec.tofile(fh)


def load_dbow2_binary(path: str, device="cuda") -> Vocabulary:
    """Load an ORB-SLAM-style binary vocabulary (see
    :func:`save_dbow2_binary`) as a general tree: pruned trees (clusters
    smaller than k become early leaves) are handled by the explicit
    ``children`` table and per-node ``leaf_word`` ids.  Word ids go to
    leaves in node-id order, as DBoW2's ``createWords`` assigns them."""
    with open(path, "rb") as fh:
        buf = fh.read()
    n_nodes, size_node = np.frombuffer(buf, np.uint32, 2, 0)
    k, L = (int(x) for x in np.frombuffer(buf, np.int32, 2, 8))
    n_nodes = int(n_nodes)
    if int(size_node) != _DBOW2_REC.itemsize:
        raise ValueError(
            f"unsupported DBoW2 binary node size {int(size_node)} "
            f"(expected {_DBOW2_REC.itemsize}: ORB 32-byte descriptors)")
    rec = np.frombuffer(buf, _DBOW2_REC, n_nodes - 1, 16)
    desc_bytes = np.concatenate(
        [np.zeros((1, 32), np.uint8), rec["desc"]])
    nd = np.ascontiguousarray(desc_bytes).view(np.uint32)
    # child table: stable-sort nodes by parent, rank within each parent
    # group = child slot
    children = np.full((n_nodes, k), -1, np.int32)
    parents = rec["parent"].astype(np.int64)
    order = np.argsort(parents, kind="stable")
    p_sorted = parents[order]
    first = np.r_[True, p_sorted[1:] != p_sorted[:-1]]
    grp_start = np.maximum.accumulate(
        np.where(first, np.arange(len(p_sorted)), 0))
    rank = np.arange(len(p_sorted)) - grp_start
    if len(rank) and rank.max() >= k:
        raise ValueError("node with more than k children")
    children[p_sorted, rank] = order.astype(np.int32) + 1
    is_leaf = np.concatenate([[0], rec["leaf"]]).astype(bool)
    leaf_word = np.full(n_nodes, -1, np.int32)
    leaf_word[is_leaf] = np.arange(int(is_leaf.sum()), dtype=np.int32)
    ww = np.zeros(int(is_leaf.sum()), np.float32)
    ww[leaf_word[1:][is_leaf[1:]]] = rec["weight"][is_leaf[1:]]
    return vocabulary_from_numpy(nd, ww, k, L, children=children,
                                 leaf_word=leaf_word, device=device)
