"""Train an ORB vocabulary at production scale (>= 10^5 leaves).

Counterpart of ``tools/train_vocab.py`` of the JAX package (which made
``artifacts/vocab_1e5.npz``). The reference ships a 10^6-leaf DBoW2
ORBvoc trained on public imagery; this trains the same tree shape
(branching 10) on descriptors harvested from rendered views of varied
synthetic rooms and, optionally, the TUM-format replica's frames, and
saves it as .npz (``slam/vocabulary.load`` reads it).

The harvest runs the port's extractor on the card (one FAST launch per
frame; --cpu runs it on the CPU). The trainer is host numpy, the JAX
package's: a chunked packed-bit k-majority clusterer (Hamming distances
by XOR and an 8-bit popcount table on the packed descriptors), seeded
with ``RandomState(seed)``, so the same descriptors give the same tree.

Usage:
  python3 -m coebslam_tpu_torch.tools.train_vocab OUT.npz
      [--branching 10] [--depth 5] [--frames 240] [--replica DIR]
      [--seed 0] [--cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint16)


def hamming_chunked(descs: np.ndarray, centers: np.ndarray,
                    chunk: int = 65536) -> np.ndarray:
    """[N] argmin Hamming(desc, center) over [k, 32] packed centers."""
    out = np.empty(len(descs), np.int32)
    for i in range(0, len(descs), chunk):
        d = descs[i:i + chunk]
        x = POP8[np.bitwise_xor(d[:, None, :], centers[None])].sum(-1)
        out[i:i + chunk] = x.argmin(1)
    return out


def majority_center(descs: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(descs, axis=1, bitorder="little")
    return np.packbits(bits.mean(0) >= 0.5, bitorder="little")


def kmajority(descs: np.ndarray, k: int, rng, iters: int = 6):
    """Packed-bit k-majority clustering; returns (centers [k,32], assign)."""
    k = min(k, len(descs))
    picks = rng.choice(len(descs), k, replace=False)
    centers = descs[picks].copy()
    assign = None
    for _ in range(iters):
        new_assign = hamming_chunked(descs, centers)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            sel = assign == c
            if sel.any():
                centers[c] = majority_center(descs[sel])
    return centers, assign


def train_tree(descriptors: np.ndarray, branching: int, depth: int,
               seed: int = 0, min_cluster: int = 4):
    """Hierarchical k-majority -> ``slam.vocabulary.Vocabulary``.

    Node order is parent before child (``save_orbvoc_text`` needs it, and
    it is DBoW2's node layout)."""
    from ..slam.vocabulary import Vocabulary, transform_host

    rng = np.random.RandomState(seed)
    node_desc = [np.zeros(32, np.uint8)]
    children: list = [[]]
    node_level = [0]

    # Iterative BFS, so a 10^5-node tree does not hit the recursion limit.
    queue = [(np.arange(len(descriptors)), 0, 0)]
    t0 = time.perf_counter()
    processed = 0
    while queue:
        idx, level, parent = queue.pop(0)
        if level == depth or len(idx) <= branching:
            continue
        centers, assign = kmajority(descriptors[idx], branching, rng)
        for c in range(len(centers)):
            sel = assign == c
            if sel.sum() < 1:
                continue
            node_id = len(node_desc)
            node_desc.append(centers[c])
            children.append([])
            node_level.append(level + 1)
            children[parent].append(node_id)
            if sel.sum() >= min_cluster:
                queue.append((idx[sel], level + 1, node_id))
        processed += len(idx)
        if processed > 2_000_000:
            print(f"  ... level~{level} nodes={len(node_desc)} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
            processed = 0

    n_nodes = len(node_desc)
    child_arr = np.full((n_nodes, branching), -1, np.int32)
    for i, ch in enumerate(children):
        child_arr[i, :len(ch)] = ch
    word_id = np.full(n_nodes, -1, np.int32)
    leaves = [i for i in range(n_nodes) if not children[i] and i != 0]
    for w, i in enumerate(leaves):
        word_id[i] = w

    voc = Vocabulary(np.asarray(node_desc), child_arr, word_id,
                     np.ones(len(leaves), np.float32),
                     np.asarray(node_level, np.int32), depth, branching)
    # idf weights from the training corpus (DBoW2 TF_IDF).
    sub = descriptors[rng.choice(len(descriptors),
                                 min(len(descriptors), 200_000),
                                 replace=False)]
    words, _ = transform_host(voc, sub)
    counts = np.bincount(words[words >= 0], minlength=len(leaves)) + 1
    idf = np.maximum(np.log(len(sub) / counts), 1e-3).astype(np.float32)
    return voc._replace(word_weight=idf)


def harvest_descriptors(n_frames: int, replica_dir: str = None,
                        seed: int = 0, device=None) -> np.ndarray:
    """Render varied synthetic rooms on ``device`` (default CUDA) and
    extract their ORB descriptors there; then every 4th frame of a
    replica directory's rgb/ images, when given."""
    import torch
    from ..config import SystemConfig
    from ..io import png
    from ..ops import extractor
    from ..utils import synthetic
    from ..utils.device import resolve_device

    device = resolve_device(device, "harvest_descriptors")
    cfg = SystemConfig()

    def descs(g):
        f = extractor.extract(g, cfg.orb)
        return f.desc[f.valid].cpu().numpy()

    out = []
    rng = np.random.RandomState(seed)
    rooms = [synthetic.make_room(seed=s, device=device) for s in range(8)]
    t0 = time.perf_counter()
    for i in range(n_frames):
        room = rooms[i % len(rooms)]
        poses = synthetic.camera_trajectory(
            36, radius=0.3 + 0.3 * rng.rand(), forward=0.004 * rng.rand())
        p = poses[rng.randint(len(poses))]
        out.append(descs(synthetic.render(cfg.camera, p, room, None, i)[0]))
        if i % 40 == 0:
            print(f"  harvested {i}/{n_frames} frames "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    if replica_dir and os.path.isdir(os.path.join(replica_dir, "rgb")):
        names = sorted(os.listdir(os.path.join(replica_dir, "rgb")))[::4]
        for nme in names:
            g = png.read(os.path.join(replica_dir, "rgb", nme)).astype(
                np.float32)
            out.append(descs(torch.from_numpy(g).to(device)))
        print(f"  + {len(names)} replica frames", flush=True)
    return np.concatenate(out)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m coebslam_tpu_torch.tools.train_vocab",
        description="Train an ORB vocabulary on rendered views.")
    ap.add_argument("out")
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--replica", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Returns the vocabulary, the descriptor count and the seconds of
    the harvest and of the training."""
    from ..slam import vocabulary as voc_mod

    t0 = time.perf_counter()
    descs = harvest_descriptors(args.frames, args.replica, args.seed,
                                device="cpu" if args.cpu else None)
    t1 = time.perf_counter()
    print(f"{len(descs)} descriptors in {t1 - t0:.0f}s", flush=True)
    voc = train_tree(descs, args.branching, args.depth, args.seed)
    t2 = time.perf_counter()
    print(f"trained: {voc.n_words} words, {len(voc.node_desc)} nodes, "
          f"depth {voc.depth} in {t2 - t1:.0f}s", flush=True)
    voc_mod.save(args.out, voc)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return {"vocabulary": voc, "n_descriptors": len(descs),
            "harvest_s": t1 - t0, "train_s": t2 - t1}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
