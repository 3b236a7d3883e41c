"""Keyframe database: sparse BoW rows + loop / relocalization retrieval.

Counterpart of ``coebslam_tpu/slam/keyframe_db.py`` (the reference's
``KeyFrameDatabase``), numpy over the host arena as there:
``detect_loop_candidates`` (shared-word counting, the 0.8x most-common-
words gate, the min-score floor, covisibility-group score accumulation and
the 0.75x best retention) and ``detect_relocalization_candidates`` (the
same without the floor and the exclusion set). Each keyframe is stored as a
sparse tf-idf row of (word id, weight) pairs padded to the keypoint
capacity, so the database does not grow with the vocabulary; scoring uses
1 - 0.5*|q - v|_1 = sum over common words of 0.5*(|q| + |v| - |q - v|) for
L1-normalized rows. The candidate lists depend only on numpy's ``unique``,
``nonzero`` and ``sorted``, so they equal the JAX package's.
"""
from __future__ import annotations

import numpy as np

from .map import MapArena
from .vocabulary import Vocabulary


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary, arena: MapArena, max_kf: int):
        self.voc = voc
        self.map = arena
        W = arena.kf_uv.shape[1]
        # word ids per keyframe keypoint slot ([K, N] int32, -1 invalid).
        self.kf_words = np.full((max_kf, W), -1, np.int32)
        # Sparse L1-normalized tf-idf rows: sorted distinct word ids + weights.
        self.kf_bow_words = np.full((max_kf, W), -1, np.int32)
        self.kf_bow_vals = np.zeros((max_kf, W), np.float32)
        self.registered = np.zeros(max_kf, bool)
        self._scratch = np.zeros(voc.n_words + 1, np.float32)

    # ------------------------------------------------------------------ #

    def sparse_bow(self, words: np.ndarray):
        """Distinct (word, weight) pairs from per-keypoint word ids,
        tf-idf weighted and L1-normalized."""
        w = words[words >= 0]
        uniq, counts = np.unique(w, return_counts=True)
        vals = counts.astype(np.float32) * self.voc.word_weight[uniq]
        norm = max(float(vals.sum()), 1e-9)
        return uniq.astype(np.int32), vals / norm

    def add(self, kf_id: int, words: np.ndarray) -> None:
        """Register a keyframe from its per-keypoint word ids."""
        self.kf_words[kf_id] = words
        uniq, vals = self.sparse_bow(words)
        n = min(len(uniq), self.kf_bow_words.shape[1])
        self.kf_bow_words[kf_id] = -1
        self.kf_bow_vals[kf_id] = 0.0
        self.kf_bow_words[kf_id, :n] = uniq[:n]
        self.kf_bow_vals[kf_id, :n] = vals[:n]
        self.registered[kf_id] = True

    def erase(self, kf_id: int) -> None:
        self.registered[kf_id] = False

    # ------------------------------------------------------------------ #

    def score(self, q_words: np.ndarray, q_vals: np.ndarray,
              kf_ids) -> np.ndarray:
        """L1 similarity of a sparse query against stored rows:
        sum over common words of 0.5*(|q| + |v| - |q - v|)."""
        kf_ids = np.atleast_1d(np.asarray(kf_ids, np.int64))
        scratch = self._scratch
        scratch[q_words] = q_vals
        vw = self.kf_bow_words[kf_ids]
        vv = self.kf_bow_vals[kf_ids]
        qv = scratch[np.clip(vw, 0, None)] * (vw >= 0)
        s = 0.5 * (np.abs(qv) + np.abs(vv) - np.abs(qv - vv)).sum(1)
        scratch[q_words] = 0.0
        return s

    def score_kf(self, kf_id: int, kf_ids) -> np.ndarray:
        row = self.kf_bow_words[kf_id]
        sel = row >= 0
        return self.score(row[sel], self.kf_bow_vals[kf_id][sel], kf_ids)

    # ------------------------------------------------------------------ #

    def _shared_words(self, words: np.ndarray, exclude) -> np.ndarray:
        """Count shared words between a query word set and every registered
        KF ([K] int32) — one boolean-scratch pass over the stored rows."""
        present = np.zeros(self.voc.n_words + 1, bool)
        present[words[words >= 0]] = True
        kw = self.kf_words
        shared = (present[np.clip(kw, 0, None)] & (kw >= 0)).sum(1)
        shared[~self.registered] = 0
        if exclude is not None:
            shared[list(exclude)] = 0
        return shared

    def detect_loop_candidates(self, kf_id: int, min_score: float,
                               max_candidates: int = 10) -> np.ndarray:
        """DetectLoopCandidates (KeyFrameDatabase.cc:76-197): exclude the
        covisibility neighborhood, gate by shared words and min_score, rank
        by covisibility-accumulated score, keep >= 0.75x best."""
        connected = set(int(k) for k in
                        self.map.covisible_keyframes(kf_id, min_weight=1))
        connected.add(kf_id)
        shared = self._shared_words(self.kf_words[kf_id], connected)
        if shared.max(initial=0) == 0:
            return np.zeros(0, np.int64)
        min_common = int(0.8 * shared.max())
        cands = np.nonzero(shared > max(min_common, 0))[0]

        scores = self.score_kf(kf_id, cands)
        keep = scores >= min_score
        cands, scores = cands[keep], scores[keep]
        if len(cands) == 0:
            return np.zeros(0, np.int64)

        # Covisibility-accumulated score (each candidate + its top-10 covis
        # group; best single KF of the best groups is returned).
        acc = []
        for c, s in zip(cands, scores):
            group = self.map.best_covisible(int(c), 10)
            group = [g for g in group
                     if self.registered[g] and shared[g] > min_common]
            group_scores = [float(s)]
            if group:
                group_scores += list(self.score_kf(kf_id, group))
            acc.append((sum(group_scores), float(max(group_scores)), int(c)))
        best_acc = max(a for a, _, _ in acc)
        out = [(bs, c) for a, bs, c in acc if a >= 0.75 * best_acc]
        out.sort(reverse=True)
        return np.asarray([c for _, c in out[:max_candidates]], np.int64)

    def detect_relocalization_candidates(self, words: np.ndarray,
                                         max_candidates: int = 5
                                         ) -> np.ndarray:
        """DetectRelocalizationCandidates (KeyFrameDatabase.cc:199-309) —
        same covisibility-group accumulation scheme as loop detection but
        with no min-score floor and no exclusion set."""
        shared = self._shared_words(words, None)
        if shared.max(initial=0) == 0:
            return np.zeros(0, np.int64)
        min_common = int(0.8 * shared.max())
        cands = np.nonzero(shared > max(min_common, 0))[0]
        if len(cands) == 0:
            return np.zeros(0, np.int64)
        qw, qv = self.sparse_bow(words)
        scores = self.score(qw, qv, cands)

        score_of = dict(zip(cands.tolist(), scores.tolist()))
        acc = []  # (acc_score, best_kf_score, best_kf)
        for c, s in zip(cands, scores):
            total, best_s, best_kf = float(s), float(s), int(c)
            for g in self.map.best_covisible(int(c), 10):
                if not (self.registered[g] and shared[g] > min_common):
                    continue
                gs = score_of.get(int(g))
                if gs is None:
                    gs = float(self.score(qw, qv, [int(g)])[0])
                total += gs
                if gs > best_s:
                    best_s, best_kf = gs, int(g)
            acc.append((total, best_s, best_kf))
        best_acc = max(a for a, _, _ in acc)
        out = sorted({(bs, kf) for a, bs, kf in acc if a >= 0.75 * best_acc},
                     reverse=True)
        return np.asarray([kf for _, kf in out[:max_candidates]], np.int64)
