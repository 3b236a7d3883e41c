"""Fixed-capacity host map arena: keyframes, points, observations and
covisibility, as numpy arrays.

The port's own copy of ``coebslam_tpu/slam/map.py``: keyframe and point
insertion, observation back-references, covisibility counts with the
spanning parent, the distinctive descriptor and the scale band of each
point, the dirty-row flags that ``slam/map_device.py`` drains, keyframe
and point removal with id recycling (a culled keyframe keeps its pose
relative to its parent, ``kf_cull_rel``, and the ``on_keyframe_removed``
listeners run before its id is reused), fuse redirects (``replace_point``,
followed by ``resolve_ids``) and the queries the host tracker and mapper
make. The JAX package computes the covisibility row and the distinctive
descriptors in its native library when it is built; here both are
vectorised numpy with the same results (the median of a point's distances
is the element at index m // 2 of the sorted m distances, the first
observation wins a tie).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import SystemConfig

MAX_OBS_PER_POINT = 32
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def distinctive_descriptors(kf_desc, pt_obs_kf, pt_obs_slot, chunk=512):
    """Per point, the observed descriptor with the least median Hamming
    distance to the point's other observations.

    Returns (desc [n, 32] uint8, best_kf [n], best_slot [n]); a point with
    no observation gets best_kf = best_slot = -1.
    """
    n, m_max = pt_obs_kf.shape
    out = np.zeros((n, 32), np.uint8)
    best_kf = np.full(n, -1, np.int32)
    best_slot = np.full(n, -1, np.int32)
    for s in range(0, n, chunk):
        okf = pt_obs_kf[s:s + chunk]
        oslot = pt_obs_slot[s:s + chunk]
        live = okf >= 0
        # Observations in column order, packed to the front.
        order = np.argsort(~live, axis=1, kind="stable")
        kf = np.take_along_axis(okf, order, 1)
        slot = np.take_along_axis(oslot, order, 1)
        m = live.sum(1)
        ok = np.arange(m_max)[None, :] < m[:, None]
        d = kf_desc[np.clip(kf, 0, None), np.clip(slot, 0, None)]
        ham = _POPCOUNT[d[:, :, None, :] ^ d[:, None, :, :]].sum(
            -1, dtype=np.int32)
        ham = np.where(ok[:, None, :], ham, np.iinfo(np.int32).max)
        med = np.take_along_axis(
            np.sort(ham, axis=2), (m // 2)[:, None, None], 2)[..., 0]
        med = np.where(ok, med, np.iinfo(np.int32).max)
        best = np.argmin(med, axis=1)
        rows = np.arange(len(okf))
        has = m > 0
        bk, bs = kf[rows, best], slot[rows, best]
        best_kf[s:s + chunk] = np.where(has, bk, -1)
        best_slot[s:s + chunk] = np.where(has, bs, -1)
        out[s:s + chunk] = np.where(has[:, None], d[rows, best], 0)
    return out, best_kf, best_slot


class MapArena:
    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        K = cfg.map.max_keyframes
        P = cfg.map.max_points
        N = cfg.orb.max_keypoints

        # --- keyframes ---
        self.kf_R = np.zeros((K, 3, 3), np.float32)
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_stamp = np.zeros(K, np.float64)
        self.kf_valid = np.zeros(K, bool)
        self.kf_uv = np.zeros((K, N, 2), np.float32)
        self.kf_level = np.zeros((K, N), np.int32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_desc = np.zeros((K, N, 32), np.uint8)
        self.kf_depth = np.zeros((K, N), np.float32)
        self.kf_ur = np.full((K, N), -1.0, np.float32)
        self.kf_kp_valid = np.zeros((K, N), bool)
        # point id observed at each keypoint slot, -1 = none.
        self.kf_obs_pt = np.full((K, N), -1, np.int32)
        # covisibility weights (shared-point counts) and spanning parent.
        self.covis = np.zeros((K, K), np.int32)
        self.kf_parent = np.full(K, -1, np.int32)
        self.n_kf = 0
        # kf_seq[k] = how many keyframes were inserted before k.
        self.kf_seq = np.zeros(K, np.int64)
        self.kf_seq_counter = 0

        # --- map points ---
        self.pt_pos = np.zeros((P, 3), np.float32)
        self.pt_valid = np.zeros(P, bool)
        self.pt_desc = np.zeros((P, 32), np.uint8)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.zeros(P, np.float32)
        self.pt_angle = np.zeros(P, np.float32)
        self.pt_found = np.zeros(P, np.int32)
        self.pt_visible = np.zeros(P, np.int32)
        self.pt_first_kf = np.full(P, -1, np.int32)
        self.pt_first_seq = np.full(P, -1, np.int64)
        # observation back-references: (kf, slot) pairs per point.
        self.pt_obs_kf = np.full((P, MAX_OBS_PER_POINT), -1, np.int32)
        self.pt_obs_slot = np.full((P, MAX_OBS_PER_POINT), -1, np.int32)
        self.n_pt = 0
        self._free_pt: List[int] = []   # recycled point ids
        # Fuse redirect: replace_point(old, new) sets pt_redirect[old] = new.
        self.pt_redirect = np.full(P, -1, np.int32)
        # Culled keyframe -> (parent, R_cp, t_cp), its pose relative to the
        # parent at cull time.
        self.kf_cull_rel = {}
        # Recycled keyframe ids; an id is reused only after the listeners
        # re-anchored their references to it.
        self._free_kf: List[int] = []
        # Called with the removed keyframe id before the id is recycled.
        self.on_keyframe_removed: List = []
        # Monotonic mutation counter, and the dirty rows that
        # slam.map_device.DeviceMap.sync drains.
        self.version = 0
        self._dirty_pt = np.zeros(P, bool)
        self._dirty_kf = np.zeros(K, bool)
        self._dirty_all = True
        self._pose_version = 0

    def bump(self) -> None:
        self.version += 1

    def mark_points_dirty(self, pids) -> None:
        """Writers of point rows (BA writeback) call this after writing."""
        self._dirty_pt[np.asarray(pids, np.int64)] = True

    def mark_poses_dirty(self) -> None:
        self._pose_version += 1

    def anchored_pose(self, k: int):
        """World pose of keyframe k, walking the cull-parent chain if k was
        culled. Returns (R, t, found)."""
        R_rel = np.eye(3, dtype=np.float32)
        t_rel = np.zeros(3, np.float32)
        for _ in range(64):
            if self.kf_valid[k]:
                R = R_rel @ self.kf_R[k]
                t = R_rel @ self.kf_t[k] + t_rel
                return R, t, True
            if k not in self.kf_cull_rel:
                break
            parent, Rcp, tcp = self.kf_cull_rel[k]
            R_rel, t_rel = R_rel @ Rcp, R_rel @ tcp + t_rel
            k = parent
        return self.kf_R[k], self.kf_t[k], False

    # ------------------------------------------------------------------ #
    # keyframes
    # ------------------------------------------------------------------ #

    def add_keyframe(self, R_cw, t_cw, stamp, uv, level, angle, desc, depth,
                     ur, kp_valid, point_ids) -> int:
        """Insert a keyframe; wires its observations and covisibility.
        ``point_ids``: [N] map-point id per keypoint slot (-1 none).
        Returns the new keyframe id."""
        if self._free_kf:
            k = self._free_kf.pop()
            # Recycled slot: clear what the previous tenant left behind.
            self.kf_parent[k] = -1
            self.kf_cull_rel.pop(k, None)
        else:
            k = self.n_kf
            if k >= self.kf_R.shape[0]:
                raise RuntimeError("keyframe arena full")
            self.n_kf += 1
        self.kf_R[k] = R_cw
        self.kf_t[k] = t_cw
        self.kf_stamp[k] = stamp
        self.kf_uv[k] = uv
        self.kf_level[k] = level
        self.kf_angle[k] = angle
        self.kf_desc[k] = desc
        self.kf_depth[k] = depth
        self.kf_ur[k] = ur
        self.kf_kp_valid[k] = kp_valid
        self.kf_valid[k] = True
        self.kf_seq[k] = self.kf_seq_counter
        self.kf_seq_counter += 1
        self._dirty_kf[k] = True
        self._pose_version += 1

        pid = np.asarray(point_ids, np.int32).copy()
        pid[~np.asarray(kp_valid, bool)] = -1
        self.kf_obs_pt[k] = pid
        for s in np.nonzero(pid >= 0)[0]:
            self._add_observation(int(pid[s]), k, int(s))
        self.update_covisibility(k)
        return k

    def update_covisibility(self, k: int) -> None:
        """Recount shared points between keyframe k and all others; set the
        spanning parent on the first connection."""
        obs = self.kf_obs_pt[k]
        observed = obs[obs >= 0]
        if len(observed) == 0:
            return
        mask = np.zeros(self.pt_pos.shape[0], bool)
        mask[observed] = True
        other = self.kf_obs_pt[:self.n_kf]
        shared = (mask[np.clip(other, 0, None)] & (other >= 0)).sum(1)
        shared = shared.astype(np.int32)
        shared[k] = 0
        self.covis[k, :self.n_kf] = shared
        self.covis[:self.n_kf, k] = shared
        if self.kf_parent[k] < 0 and shared.max(initial=0) > 0:
            self.kf_parent[k] = int(np.argmax(shared))

    def covisible_keyframes(self, k: int, min_weight: int = 1,
                            top: Optional[int] = None) -> np.ndarray:
        w = self.covis[k, :self.n_kf] * self.kf_valid[:self.n_kf]
        ids = np.nonzero(w >= min_weight)[0]
        ids = ids[np.argsort(-w[ids])]
        if top is not None:
            ids = ids[:top]
        return ids

    def best_covisible(self, k: int, n: int) -> np.ndarray:
        return self.covisible_keyframes(k, min_weight=1, top=n)

    def remove_keyframe(self, k: int) -> None:
        """Cull keyframe k: clear its observations and covisibility; its
        children re-parent to their best remaining covisible neighbour.
        Keeps k's pose relative to its parent (``kf_cull_rel``) so records
        anchored to k can be re-anchored, calls the ``on_keyframe_removed``
        listeners, folds earlier cull chains through k, and frees the id."""
        parent = int(self.kf_parent[k])
        if parent < 0:
            parent = 0
        Rp, tp = self.kf_R[parent], self.kf_t[parent]
        Rcp = self.kf_R[k] @ Rp.T
        tcp = self.kf_t[k] - Rcp @ tp
        self.kf_cull_rel[k] = (parent, Rcp.copy(), tcp.copy())
        obs = self.kf_obs_pt[k]
        for s in np.nonzero(obs >= 0)[0]:
            self._remove_observation(int(obs[s]), k)
        self.kf_obs_pt[k] = -1
        self.kf_valid[k] = False
        # Points anchored to k fall back to their first live observation.
        owned = np.nonzero(self.pt_first_kf[:self.n_pt] == k)[0]
        if len(owned):
            okf = self.pt_obs_kf[owned]
            live = (okf >= 0) & self.kf_valid[np.clip(okf, 0, None)]
            has = live.any(1)
            first = okf[np.arange(len(owned)), np.argmax(live, 1)]
            self.pt_first_kf[owned] = np.where(has, first, -1)
        self._dirty_kf[k] = True
        self.covis[k, :] = 0
        self.covis[:, k] = 0
        children = np.nonzero(self.kf_parent[:self.n_kf] == k)[0]
        for c in children:
            nb = self.covisible_keyframes(int(c), min_weight=1, top=1)
            self.kf_parent[c] = int(nb[0]) if len(nb) else self.kf_parent[k]

        for cb in self.on_keyframe_removed:
            cb(k)
        _, Rk, tk = self.kf_cull_rel[k]
        for j, (pj, Rj, tj) in list(self.kf_cull_rel.items()):
            if pj == k and j != k:
                self.kf_cull_rel[j] = (parent, Rj @ Rk, Rj @ tk + tj)
        # kf_cull_rel[k] stays until the slot is reused (add_keyframe).
        self._free_kf.append(k)

    def keyframe_pose(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.kf_R[k], self.kf_t[k]

    def set_keyframe_pose(self, k: int, R, t) -> None:
        self.kf_R[k] = R
        self.kf_t[k] = t
        self._pose_version += 1

    def valid_keyframes(self) -> np.ndarray:
        return np.nonzero(self.kf_valid[:self.n_kf])[0]

    # ------------------------------------------------------------------ #
    # points
    # ------------------------------------------------------------------ #

    def add_points(self, positions, descs, first_kf: int,
                   normals=None, min_dists=None, max_dists=None,
                   angles=None) -> np.ndarray:
        """Batch-create map points; returns their ids (-1 where the arena
        is full)."""
        positions = np.atleast_2d(positions)
        m = len(positions)
        # Recycled ids first, then the arena tail.
        n_free = min(len(self._free_pt), m)
        alloc = [self._free_pt.pop() for _ in range(n_free)]
        n_tail = min(m - n_free, self.pt_pos.shape[0] - self.n_pt)
        alloc += list(range(self.n_pt, self.n_pt + n_tail))
        self.n_pt += n_tail
        ids = np.full(m, -1, np.int32)
        if alloc:
            sel = np.asarray(alloc, np.int64)
            k = len(sel)
            ids[:k] = sel
            self.pt_pos[sel] = positions[:k]
            self.pt_desc[sel] = np.atleast_2d(descs)[:k]
            self.pt_valid[sel] = True
            self.pt_found[sel] = 1
            self.pt_visible[sel] = 1
            self.pt_first_kf[sel] = first_kf
            self.pt_first_seq[sel] = self.kf_seq[first_kf] \
                if first_kf >= 0 else -1
            self.pt_obs_kf[sel] = -1
            self.pt_obs_slot[sel] = -1
            self.pt_redirect[sel] = -1
            if angles is not None:
                self.pt_angle[sel] = np.atleast_1d(angles)[:k]
            if normals is not None:
                self.pt_normal[sel] = np.atleast_2d(normals)[:k]
            if min_dists is not None:
                self.pt_min_dist[sel] = np.atleast_1d(min_dists)[:k]
                self.pt_max_dist[sel] = np.atleast_1d(max_dists)[:k]
            self._dirty_pt[sel] = True
        self.bump()
        return ids

    def _add_observation(self, pid: int, kf: int, slot: int) -> None:
        free = np.nonzero(self.pt_obs_kf[pid] < 0)[0]
        if len(free) == 0:
            return
        self.pt_obs_kf[pid, free[0]] = kf
        self.pt_obs_slot[pid, free[0]] = slot

    def _remove_observation(self, pid: int, kf: int) -> None:
        sel = self.pt_obs_kf[pid] == kf
        self.pt_obs_kf[pid, sel] = -1
        self.pt_obs_slot[pid, sel] = -1
        if not (self.pt_obs_kf[pid] >= 0).any():
            self.remove_point(pid)

    def point_observation_count(self, pids) -> np.ndarray:
        return (self.pt_obs_kf[pids] >= 0).sum(-1)

    def resolve_ids(self, pids: np.ndarray) -> np.ndarray:
        """Follow fuse redirects (at most three links) and drop dead ids, so
        a stale per-frame match list stays usable across a fuse or cull."""
        out = np.asarray(pids, np.int32).copy()
        for _ in range(3):
            live = out >= 0
            r = self.pt_redirect[np.clip(out, 0, None)]
            follow = live & (r >= 0)
            if not follow.any():
                break
            out[follow] = r[follow]
        out[(out >= 0) & ~self.pt_valid[np.clip(out, 0, None)]] = -1
        return out

    def remove_point(self, pid: int) -> None:
        """Drop a point and the keyframe slots that reference it."""
        kfs = self.pt_obs_kf[pid]
        slots = self.pt_obs_slot[pid]
        for kf, s in zip(kfs, slots):
            if kf >= 0:
                self.kf_obs_pt[kf, s] = -1
        self.pt_obs_kf[pid] = -1
        self.pt_obs_slot[pid] = -1
        self.pt_valid[pid] = False
        self._free_pt.append(pid)
        self._dirty_pt[pid] = True
        self.bump()

    def replace_point(self, old: int, new: int) -> None:
        """Merge ``old`` into ``new`` (fuse): its observations move to
        ``new`` unless ``new`` is already seen in that keyframe."""
        kfs = self.pt_obs_kf[old].copy()
        slots = self.pt_obs_slot[old].copy()
        self.pt_found[new] += self.pt_found[old]
        self.pt_visible[new] += self.pt_visible[old]
        for kf, s in zip(kfs, slots):
            if kf < 0:
                continue
            if (self.pt_obs_kf[new] == kf).any():
                self.kf_obs_pt[kf, s] = -1
            else:
                self.kf_obs_pt[kf, s] = new
                self._add_observation(new, kf, int(s))
        self.pt_obs_kf[old] = -1
        self.pt_obs_slot[old] = -1
        self.pt_valid[old] = False
        self.pt_redirect[old] = new
        self._free_pt.append(old)
        self._dirty_pt[old] = True
        self.bump()

    def update_point_stats(self, pids) -> None:
        """Recompute the distinctive descriptor (with its keypoint angle),
        the viewing normal and the scale band of the given points."""
        sf = self.cfg.orb.scale_factor
        n_levels = self.cfg.orb.n_levels
        pids = np.atleast_1d(np.asarray(pids, np.int64))
        pids = pids[pids >= 0]
        if len(pids) == 0:
            return
        okf = self.pt_obs_kf[pids]
        oslot = self.pt_obs_slot[pids]
        has_obs = (okf >= 0).any(1)

        desc, bkf, bslot = distinctive_descriptors(self.kf_desc, okf, oslot)
        sel = has_obs & (bkf >= 0)
        self.pt_desc[pids[sel]] = desc[sel]
        self.pt_angle[pids[sel]] = self.kf_angle[bkf[sel], bslot[sel]]

        kf_safe = np.clip(okf, 0, None)
        Rk = self.kf_R[kf_safe]                         # [n, m, 3, 3]
        tk = self.kf_t[kf_safe]                         # [n, m, 3]
        centers = -np.einsum("nmji,nmj->nmi", Rk, tk)
        vecs = self.pt_pos[pids][:, None, :] - centers
        norms = np.linalg.norm(vecs, axis=-1)
        w = (okf >= 0).astype(np.float32)
        unit = vecs / np.maximum(norms, 1e-9)[..., None]
        nrm = (unit * w[..., None]).sum(1)
        nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
        self.pt_normal[pids[has_obs]] = (nrm / np.maximum(nlen, 1e-9))[has_obs]

        # Reference observation = first valid column.
        first = np.argmax(okf >= 0, axis=1)
        rng = np.arange(len(pids))
        ref_kf = okf[rng, first]
        ref_slot = oslot[rng, first]
        dist = norms[rng, first]
        level = self.kf_level[np.clip(ref_kf, 0, None), ref_slot]
        max_d = dist * (sf ** level)
        self.pt_max_dist[pids[has_obs]] = max_d[has_obs]
        self.pt_min_dist[pids[has_obs]] = \
            (max_d / (sf ** (n_levels - 1)))[has_obs]
        self._dirty_pt[pids] = True
        self.bump()

    def local_map_points(self, kf_ids, cap: int) -> np.ndarray:
        """All valid points the given keyframes observe, padded with -1 or
        cut to ``cap``."""
        if len(kf_ids) == 0:
            return np.full(cap, -1, np.int32)
        pts = np.unique(self.kf_obs_pt[kf_ids])
        pts = pts[(pts >= 0)]
        pts = pts[self.pt_valid[pts]]
        out = np.full(cap, -1, np.int32)
        out[:min(len(pts), cap)] = pts[:cap]
        return out

    def valid_points(self) -> np.ndarray:
        return np.nonzero(self.pt_valid[:self.n_pt])[0]
