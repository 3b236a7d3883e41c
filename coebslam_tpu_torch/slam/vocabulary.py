"""Binary BoW vocabulary: hierarchical k-means tree over ORB descriptors.

Counterpart of ``coebslam_tpu/slam/vocabulary.py`` (DBoW2's
``TemplatedVocabulary<FORB>``): a branching-k, depth-L tree of binary
centroids with tf-idf weights and L1 scoring. Descriptors descend the tree
level by level as a gather + Hamming argmin over the node's children. A
``Vocabulary`` holds numpy arrays, field for field as in the JAX package,
so one loaded there carries over as ``Vocabulary(*jax_voc)``. Training
(host, numpy: binary k-means with majority-vote centroids) gives the same
arrays as the JAX package's for the same seed. ``load_orbvoc_text`` and
``save_orbvoc_text`` read and write the reference's ORBvoc.txt (DBoW2
text) format, parsed with numpy as a whole and not line by line.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops import brief


class Vocabulary(NamedTuple):
    """Flat-array vocabulary tree.

    Nodes are stored in breadth-first order; node 0 is the root (its
    descriptor is unused). ``children[i]`` lists up to k child node ids
    (-1 padded). Leaves carry word ids; internal nodes -1.
    """
    node_desc: np.ndarray       # [n_nodes, 32] uint8
    children: np.ndarray        # [n_nodes, k] int32
    word_id: np.ndarray         # [n_nodes] int32 (-1 internal)
    word_weight: np.ndarray     # [n_words] float32 (idf)
    node_level: np.ndarray      # [n_nodes] int32
    depth: int
    branching: int

    @property
    def n_words(self) -> int:
        return len(self.word_weight)


class DeviceVocabulary(NamedTuple):
    """The tensors the descent reads, on one device (``to_device``)."""
    node_bits: torch.Tensor     # [n_nodes, 256] uint8
    children: torch.Tensor      # [n_nodes, k] int64
    word_id: torch.Tensor       # [n_nodes] int64
    word_weight: torch.Tensor   # [n_words] float32
    depth: int


def _unpack(desc_u8: np.ndarray) -> np.ndarray:
    return np.unpackbits(desc_u8, axis=1, bitorder="little")


def _majority_center(bits: np.ndarray) -> np.ndarray:
    """[M, 256] bits -> [32] uint8 majority-vote centroid."""
    maj = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(maj, bitorder="little")


def train(descriptors: np.ndarray, branching: int = 10, depth: int = 6,
          seed: int = 0, max_iters: int = 8) -> Vocabulary:
    """Train the tree on [N, 32] uint8 descriptors (k-majority clustering,
    random distinct initial centres from ``numpy.random.RandomState(seed)``;
    idf weights from the training descriptors' word counts)."""
    rng = np.random.RandomState(seed)
    bits_all = _unpack(descriptors)

    node_desc = [np.zeros(32, np.uint8)]
    children: list = [[]]
    node_level = [0]

    def cluster(idx: np.ndarray, level: int, parent: int):
        bits = bits_all[idx]
        if level == depth or len(idx) <= branching:
            return                       # this node stays a leaf
        k = min(branching, len(idx))
        picks = rng.choice(len(idx), k, replace=False)
        centers = bits[picks].astype(np.float32)
        assign = None
        for _ in range(max_iters):
            d = (bits[:, None, :] != (centers[None] >= 0.5)).sum(-1)
            new_assign = d.argmin(1)
            if assign is not None and (new_assign == assign).all():
                break
            assign = new_assign
            for c in range(k):
                sel = assign == c
                if sel.any():
                    centers[c] = bits[sel].mean(0)
        for c in range(k):
            sel = assign == c
            if not sel.any():
                continue
            node_id = len(node_desc)
            node_desc.append(_majority_center(bits[sel]))
            children.append([])
            node_level.append(level + 1)
            children[parent].append(node_id)
            cluster(idx[sel], level + 1, node_id)

    cluster(np.arange(len(descriptors)), 0, 0)

    n_nodes = len(node_desc)
    child_arr = np.full((n_nodes, branching), -1, np.int32)
    for i, ch in enumerate(children):
        child_arr[i, :len(ch)] = ch
    word_id = np.full(n_nodes, -1, np.int32)
    leaves = [i for i in range(n_nodes) if not children[i] and i != 0]
    for w, i in enumerate(leaves):
        word_id[i] = w

    # idf = log(N / (count + 1)) with each training descriptor as its own
    # document, floored at 1e-3.
    voc = Vocabulary(np.asarray(node_desc), child_arr, word_id,
                     np.ones(len(leaves), np.float32),
                     np.asarray(node_level, np.int32), depth, branching)
    words, _ = transform_host(voc, descriptors)
    counts = np.bincount(words[words >= 0], minlength=len(leaves)) + 1
    idf = np.log(len(descriptors) / counts).astype(np.float32)
    idf = np.maximum(idf, 1e-3)
    return voc._replace(word_weight=idf)


def to_device(voc: Vocabulary, device) -> DeviceVocabulary:
    """Unpacked node bits, children, word ids and weights on ``device``."""
    dev = torch.device(device)
    return DeviceVocabulary(
        torch.from_numpy(_unpack(voc.node_desc)).to(dev),
        torch.from_numpy(np.asarray(voc.children, np.int64)).to(dev),
        torch.from_numpy(np.asarray(voc.word_id, np.int64)).to(dev),
        torch.from_numpy(np.asarray(voc.word_weight, np.float32)).to(dev),
        int(voc.depth))


def transform_host(voc: Vocabulary, descriptors: np.ndarray,
                   group_up_levels: int = 4
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host (numpy) descent, the oracle of the tensor descent.

    Returns (word ids [N], group-node ids [N] at depth-``group_up_levels``).
    """
    bits = _unpack(descriptors)
    node_bits = _unpack(voc.node_desc)
    n = len(descriptors)
    cur = np.zeros(n, np.int32)
    group = np.zeros(n, np.int32)
    group_level = max(voc.depth - group_up_levels, 1)
    for level in range(voc.depth):
        ch = voc.children[cur]                       # [N, k]
        has_child = (ch >= 0).any(1)
        cb = node_bits[np.clip(ch, 0, None)]         # [N, k, 256]
        d = (bits[:, None, :] != cb).sum(-1)
        d = np.where(ch >= 0, d, 1 << 30)
        nxt = np.take_along_axis(ch, d.argmin(1)[:, None], 1)[:, 0]
        cur = np.where(has_child, nxt, cur).astype(np.int32)
        if level + 1 == group_level:
            group = cur.copy()
    return voc.word_id[cur], group


def descend(dv: DeviceVocabulary, desc_u8, group_level: int = 0):
    """Tensor descent of [N, 32] uint8 descriptors.

    Returns (leaf node ids [N], node ids at ``group_level`` [N]; zeros when
    ``group_level`` is 0). Ties go to the lowest child, as ``argmin`` does
    in both packages.
    """
    bits = brief.unpack_bits(desc_u8)                # [N, 256]
    cur = torch.zeros(desc_u8.shape[0], dtype=torch.int64,
                      device=desc_u8.device)
    group = cur
    for level in range(dv.depth):
        ch = dv.children[cur]                        # [N, k]
        cb = dv.node_bits[torch.clamp(ch, min=0)]    # [N, k, 256]
        d = torch.sum(bits[:, None, :] != cb, dim=-1)
        d = torch.where(ch >= 0, d, torch.full_like(d, 1 << 30))
        nxt = torch.take_along_dim(ch, torch.argmin(d, 1)[:, None], 1)[:, 0]
        cur = torch.where((ch >= 0).any(1), nxt, cur)
        if level + 1 == group_level:
            group = cur
    return cur, group


def transform_words(dv: DeviceVocabulary, desc_u8, valid,
                    group_up_levels: int = 4):
    """Batched descent returning (word ids [N] (-1 invalid), group ids
    [N] at depth-``group_up_levels``).

    Args:
      dv: the vocabulary on the descriptors' device (``to_device``).
      desc_u8: [N, 32] uint8.
      valid: [N] bool.
    """
    cur, group = descend(dv, desc_u8, max(dv.depth - group_up_levels, 1))
    neg = torch.full_like(cur, -1)
    return (torch.where(valid, dv.word_id[cur], neg),
            torch.where(valid, group, neg))


def transform(dv: DeviceVocabulary, desc_u8, valid,
              group_up_levels: int = 4):
    """``transform_words`` plus the tf-idf BoW vector [n_words] float32,
    L1-normalized: (word ids, group ids, BoW)."""
    words, group = transform_words(dv, desc_u8, valid, group_up_levels)
    w_ok = valid & (words >= 0)
    wc = torch.clamp(words, min=0)
    bow = torch.zeros(dv.word_weight.shape[0], dtype=torch.float32,
                      device=desc_u8.device).index_add_(
        0, wc, torch.where(w_ok, dv.word_weight[wc], 0.0))
    norm = torch.clamp(torch.sum(torch.abs(bow)), min=1e-9)
    return words, group, bow / norm


def l1_score(bow_a, bow_b):
    """DBoW2 L1 similarity: 1 - 0.5 * |va - vb|_1 on L1-normalized vectors
    (the metric behind min-score gating)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(bow_a - bow_b), dim=-1)


def save(path: str, voc: Vocabulary) -> None:
    """Persist a vocabulary as .npz (the JAX package's layout)."""
    np.savez_compressed(
        path, node_desc=voc.node_desc, children=voc.children,
        word_id=voc.word_id, word_weight=voc.word_weight,
        node_level=voc.node_level,
        meta=np.asarray([voc.depth, voc.branching], np.int32))


def load(path: str) -> Vocabulary:
    """A vocabulary saved as .npz by ``save`` (either package's)."""
    z = np.load(path)
    return Vocabulary(z["node_desc"], z["children"], z["word_id"],
                      z["word_weight"], z["node_level"],
                      int(z["meta"][0]), int(z["meta"][1]))


def _orbvoc_rows(text: str) -> np.ndarray:
    """The data lines of an ORBvoc text body as [n, 35] float64 rows, as
    the line-by-line reading gives them: lines of fewer than 35 fields are
    skipped and fields past the 35th ignored. Files whose every line has
    35 fields are parsed in one numpy call."""
    n_lines = sum(1 for line in text.splitlines() if line.strip())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vals = np.fromstring(text, dtype=np.float64, sep=" ")
    if vals.size == 35 * n_lines:
        rows = vals.reshape(-1, 35)
        if np.isin(rows[:, 1], (0.0, 1.0)).all() and \
                (rows[:, 2:34] == np.floor(rows[:, 2:34])).all():
            return rows
    rows = [[float(x) for x in parts[:35]]
            for parts in (line.split() for line in text.splitlines())
            if len(parts) >= 35]
    return np.asarray(rows, np.float64).reshape(-1, 35)


def load_orbvoc_text(path: str) -> Vocabulary:
    """Load the reference's ORBvoc.txt (DBoW2 text format).

    Format (TemplatedVocabulary::saveToTextFile): a header line
    ``k L scoring weighting``, then one line per node except the root:
    ``parent is_leaf d0 .. d31 weight``. Node ids are implicit: the root
    is node 0 and the i-th data line (from 1) is node i; ``parent`` is the
    parent's final node id (root 0). A parent takes at most k children, in
    file order. Word ids go to the leaves in file order.
    """
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        rows = _orbvoc_rows(f.read())
    n = len(rows)
    n_nodes = n + 1
    ids = np.arange(1, n_nodes)
    parent = rows[:, 0].astype(np.int64)
    node_desc = np.zeros((n_nodes, 32), np.uint8)
    node_desc[1:] = rows[:, 2:34].astype(np.uint8)
    # Each node's rank among its parent's children, in file order.
    ok = (parent >= 0) & (parent < n_nodes)
    order = np.argsort(np.where(ok, parent, n_nodes), kind="stable")
    sp = parent[order]
    first = np.searchsorted(sp, sp, side="left")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - first
    linked = ok & (rank < k)
    children = np.full((n_nodes, k), -1, np.int32)
    children[parent[linked], rank[linked]] = ids[linked]
    # A linked node's level is its parent's level + 1, the parent's level
    # as it stood when the node was read (0 when the parent comes later).
    node_level = np.zeros(n_nodes, np.int32)
    before = linked & (parent < ids)
    node_level[ids[linked & ~before]] = 1
    while True:
        new = node_level.copy()
        new[ids[before]] = node_level[parent[before]] + 1
        if np.array_equal(new, node_level):
            break
        node_level = new
    leaf = rows[:, 1] != 0
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[ids[leaf]] = np.arange(int(leaf.sum()), dtype=np.int32)
    weights = rows[leaf, 34].astype(np.float32)
    return Vocabulary(node_desc, children, word_id, weights, node_level, L,
                      k)


def save_orbvoc_text(path: str, voc: Vocabulary) -> None:
    """Write a vocabulary in DBoW2's ORBvoc.txt text format, the inverse of
    ``load_orbvoc_text`` (the JAX package's writer, byte for byte).

    Nodes must be stored parent before child (true of trees built by
    ``train`` and read by ``load_orbvoc_text``).
    """
    n_nodes = len(voc.node_desc)
    parent = np.zeros(n_nodes, np.int64)
    ch = np.asarray(voc.children)
    has = ch >= 0
    parent[ch[has]] = np.nonzero(has)[0]
    word_id = np.asarray(voc.word_id)[1:]
    leaf = word_id >= 0
    w = np.zeros(n_nodes - 1, np.float64)
    w[leaf] = np.asarray(voc.word_weight)[word_id[leaf]]
    table = np.array([str(i) for i in range(256)], dtype=object)
    descs = table[np.asarray(voc.node_desc)[1:]].tolist()
    lines = [f"{p} {int(f)} {' '.join(d)} {x}\n" for p, f, d, x in zip(
        parent[1:].tolist(), leaf.tolist(), descs, w.tolist())]
    with open(path, "w") as f:
        f.write(f"{voc.branching} {voc.depth} 0 0\n")
        f.writelines(lines)
