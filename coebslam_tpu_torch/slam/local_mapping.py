"""Local mapping: the per-keyframe map-refinement pipeline of the host path.

Counterpart of ``coebslam_tpu/slam/local_mapping.py``. Each keyframe walks
a host stage machine whose heavy stages are device programs:

  cull points -> triangulate -> fuse -> local BA -> cull keyframes

In ``async_mode`` the machine advances one stage per tracked frame through
``poll()``: a stage's program is dispatched, and its result is written
back to the map one frame later (``_age_ok`` counts frames, not
readiness, so the decisions are the reference's). A new keyframe arriving
mid-pipeline skips the pending local BA of the previous one, never twice
in a row. Synchronous mode (the default) drives the machine to the end
inside ``process_keyframe``.

Device data comes from the shared ``DeviceMap`` mirrors: the point arrays
and the keyframes' feature rows live on the device, and a dispatch uploads
only indices and masks. The reference ``vmap``s its per-neighbour
triangulation and fusion closures; here triangulation is
``torch.func.vmap`` of ``ops/triangulation.triangulate_pair`` and fusion
is written batched over the neighbour axis, so a stage is one set of
launches, not one per neighbour. The reference's ``lax.top_k`` compaction
of the triangulated rows is a stable descending sort (ties to the lowest
index). Each writeback reads its result in one transfer.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..geometry.se3 import SE3
from ..ops import brief
from ..ops import triangulation as tri
from ..optim import local_ba
from ..utils.device import resolve_device
from . import map_device
from .map import MapArena

WINDOW_KF = 16          # max optimized + fixed cameras in a BA window
WINDOW_PT = 4096        # max points in a window
WINDOW_OBS = 12         # max observations per point inside the window
N_FUSE_NBR = 10
K_OUT = 640             # compacted triangulation rows per neighbour


def _age_ok(a: dict) -> bool:
    """Advance a pending stage after one full frame interval."""
    return a.get("age", 0) >= 1


def triangulate_all(kf_feats, kf_poses, k1, nbr_idx, v1, v2,
                    cfg: SystemConfig) -> torch.Tensor:
    """Triangulate keyframe ``k1``'s candidates (``v1`` [N]) against each
    neighbour ``nbr_idx`` [B] (candidates ``v2`` [B, N]) and compact the
    triangulated rows to the front: [B, K_OUT, 6] of (slot in k1, good,
    slot in the neighbour, x, y, z)."""
    uv_a, desc_a, lvl_a, ur_a, _ = kf_feats
    R_a, t_a = kf_poses
    sd1 = brief.to_signed(brief.unpack_bits(desc_a[k1]))
    T1 = SE3(R_a[k1], t_a[k1])
    sd2 = brief.to_signed(brief.unpack_bits(desc_a[nbr_idx]))
    T2 = SE3(R_a[nbr_idx], t_a[nbr_idx])

    def one(uv2, s2, val2, lvl2, ur2, T2):
        return tri.triangulate_pair(uv_a[k1], sd1, v1, lvl_a[k1], uv2, s2,
                                    val2, lvl2, ur2, T1, T2, cfg.camera,
                                    cfg.orb, cfg.matcher)

    res = torch.func.vmap(one)(uv_a[nbr_idx], sd2, v2, lvl_a[nbr_idx],
                               ur_a[nbr_idx], T2)
    sel = torch.sort(res.good.to(torch.float32), dim=1, descending=True,
                     stable=True)[1][:, :K_OUT]
    good = torch.gather(res.good, 1, sel)
    idx2 = torch.gather(res.idx2, 1, sel)
    pts = torch.gather(res.points, 1, sel[..., None].expand(-1, -1, 3))
    f32 = torch.float32
    return torch.cat([sel.to(f32)[..., None], good.to(f32)[..., None],
                      idx2.to(f32)[..., None], pts], dim=-1)


def fuse_all(pts, kf_feats, kf_poses, own_ids, own_valid, nbr_idx,
             cfg: SystemConfig) -> torch.Tensor:
    """Project a keyframe's points ``own_ids`` [n] into each neighbour
    ``nbr_idx`` [B] and find, within 3 px, the keypoint of least Hamming
    distance: [B, n] neighbour slot, -1 where none passes ``th_low``."""
    cam = cfg.camera
    pos_a, sd_a = pts[0], pts[1]
    uv_a, desc_a, _, _, val_a = kf_feats
    R_a, t_a = kf_poses
    pos = pos_a[own_ids]                                   # [n, 3]
    own_signed = sd_a[own_ids]
    R, t = R_a[nbr_idx], t_a[nbr_idx]                      # [B, 3, 3], [B, 3]
    pc = pos[None] @ R.transpose(1, 2) + t[:, None, :]     # [B, n, 3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    vis = own_valid[None] & (pc[..., 2] > 0.05) & (u >= 0) \
        & (u < cam.width) & (v >= 0) & (v < cam.height)
    nb_signed = brief.to_signed(brief.unpack_bits(desc_a[nbr_idx]))
    ham = 0.5 * (brief.N_BITS - own_signed[None] @ nb_signed.transpose(1, 2))
    nb_uv = uv_a[nbr_idx]                                  # [B, N, 2]
    close = (torch.abs(nb_uv[:, None, :, 0] - u[..., None]) <= 3.0) \
        & (torch.abs(nb_uv[:, None, :, 1] - v[..., None]) <= 3.0) \
        & val_a[nbr_idx][:, None, :]
    ham = torch.where(close, ham, torch.full_like(ham, 1e9))
    slot = torch.argmin(ham, dim=2)
    hit = vis & (torch.amin(ham, dim=2) <= cfg.matcher.th_low)
    return torch.where(hit, slot, torch.full_like(slot, -1))


def ba_assemble_solve(kf_feats, kf_poses, pts_dev, window_ids, kf_fixed,
                      kf_valid, win_of_kf, pt_ids, pt_valid, packed,
                      cfg: SystemConfig) -> torch.Tensor:
    """Gather the window's observations from the keyframe mirror (``packed``
    [P, M] codes kf * N + slot, -1 empty), run the local BA, and pack the
    result as one flat float32 vector (poses, points, observation flags)."""
    uv_a, _, lvl_a, ur_a, _ = kf_feats
    R_a, t_a = kf_poses
    n_kp = uv_a.shape[1]
    sf2 = cfg.orb.scale_factor ** 2
    ok = packed >= 0
    code = torch.clamp(packed, min=0)
    g = code // n_kp
    s = code % n_kp
    widx = torch.where(ok, win_of_kf[g], torch.full_like(g, -1))
    uv = uv_a[g, s]
    ur = ur_a[g, s]
    lvl = lvl_a[g, s].to(torch.float32)
    obs_uvr = torch.cat([uv, ur[..., None]], -1)
    obs_w = 1.0 / torch.pow(torch.full_like(lvl, sf2), lvl)
    prob = local_ba.BAProblem(
        kf_R=R_a[window_ids], kf_t=t_a[window_ids], kf_fixed=kf_fixed,
        kf_valid=kf_valid, pt_pos=pts_dev[0][pt_ids], pt_valid=pt_valid,
        obs_kf=widx, obs_uvr=obs_uvr, obs_w=obs_w,
        obs_valid=ok & (widx >= 0))
    res = local_ba.optimize_local_ba(prob, cfg.camera, cfg.optimizer)
    return torch.cat([res.kf_R.reshape(-1), res.kf_t.reshape(-1),
                      res.pt_pos.reshape(-1),
                      res.obs_valid.to(torch.float32).reshape(-1)])


class LocalMapper:
    def __init__(self, cfg: SystemConfig, arena: MapArena, device=None):
        self.cfg = cfg
        self.map = arena
        self.device = resolve_device(device, "LocalMapper")
        self.async_mode = False
        self._queue: List[int] = []
        self._active: Optional[dict] = None
        self._ba_skips = 0
        self.stage_ms = {}
        self.n_local_ba = 0
        self.n_culled_kf = 0
        self.n_culled_pt = 0

    def _up(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a))
        if t.dtype in (torch.int32, torch.int16):
            t = t.to(torch.int64)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------------------------ #
    # driver
    # ------------------------------------------------------------------ #

    def process_keyframe(self, kf_id: int) -> None:
        """Entry point on keyframe insertion."""
        if self.async_mode and self._active is not None:
            # A new keyframe interrupts the previous window's BA, but never
            # twice in a row.
            if self._ba_skips < 2:
                self._active["skip_ba"] = True
                self._ba_skips += 1
        self._queue.append(kf_id)
        if self.async_mode:
            self.poll()
        else:
            self.poll(block=True)

    def poll(self, block: bool = False) -> None:
        """Advance the stage machine one step (one per tracked frame);
        ``block`` drives it to completion."""
        while True:
            if self._active is None:
                if not self._queue:
                    return
                kf = self._queue.pop(0)
                self._timed("cull_points", self.cull_map_points, kf)
                t0 = time.perf_counter()
                pending = self._tri_dispatch(kf)
                self._bump("triangulate", t0)
                self._active = {"kf": kf, "stage": "tri", "pending": pending,
                                "skip_ba": False, "age": 0}
                if not block:
                    return
            a = self._active
            if not block and a["pending"] is not None:
                a["age"] = a.get("age", 0) + 1
                if not _age_ok(a):
                    return
            kf = a["kf"]
            if a["stage"] == "tri":
                t0 = time.perf_counter()
                if a["pending"] is not None:
                    self._tri_writeback(kf, a["pending"])
                self._bump("triangulate", t0)
                t0 = time.perf_counter()
                a["pending"] = self._fuse_dispatch(kf)
                a["stage"] = "fuse"
                a["age"] = 0
                self._bump("fuse", t0)
            elif a["stage"] == "fuse":
                t0 = time.perf_counter()
                if a["pending"] is not None:
                    self._fuse_writeback(kf, a["pending"])
                self._bump("fuse", t0)
                if self.map.n_kf >= 3 and not a["skip_ba"]:
                    t0 = time.perf_counter()
                    a["pending"] = self._ba_dispatch(kf)
                    a["stage"] = "ba"
                    a["age"] = 0
                    self._bump("local_ba", t0)
                    self._ba_skips = 0
                else:
                    self._finish(kf)
            elif a["stage"] == "ba":
                t0 = time.perf_counter()
                if a["pending"] is not None:
                    self._ba_writeback(kf, a["pending"])
                self._bump("local_ba", t0)
                self._finish(kf)
            if not block:
                return
            if self._active is None and not self._queue:
                return

    def _finish(self, kf: int) -> None:
        self._timed("cull_kfs", self.cull_keyframes, kf)
        self._active = None

    def idle(self) -> bool:
        return self._active is None and not self._queue

    def flush(self) -> None:
        self.poll(block=True)

    def _timed(self, name, fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        self._bump(name, t0)

    def _bump(self, name, t0):
        self.stage_ms[name] = self.stage_ms.get(name, 0.0) \
            + (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------------------------ #
    # triangulation of new points against covisible neighbours
    # ------------------------------------------------------------------ #

    def _tri_dispatch(self, kf_id: int):
        """Triangulate the keyframe's unassociated keypoints against its
        covisible neighbours, all neighbours in one dispatch."""
        m = self.map
        cfg = self.cfg
        mono = cfg.sensor == "monocular"
        n_nbr = (cfg.mapping.triangulation_neighbors_mono if mono
                 else cfg.mapping.triangulation_neighbors_rgbd)
        nbrs = m.best_covisible(kf_id, n_nbr)
        if len(nbrs) == 0:
            m.update_covisibility(kf_id)
            return None
        # Baseline gate: RGB-D needs a baseline over the stereo baseline;
        # mono needs baseline / median depth > 0.01.
        C1 = -m.kf_R[kf_id].T @ m.kf_t[kf_id]
        keep = []
        for nb in nbrs:
            nb = int(nb)
            C2 = -m.kf_R[nb].T @ m.kf_t[nb]
            baseline = float(np.linalg.norm(C1 - C2))
            if mono:
                depths = m.kf_depth[nb][m.kf_kp_valid[nb]]
                med = np.median(depths[depths > 0]) if (depths > 0).any() \
                    else 0
                if med > 0 and baseline / med < 0.01:
                    continue
            elif baseline < self.cfg.camera.baseline:
                continue
            if (m.kf_kp_valid[nb] & (m.kf_obs_pt[nb] < 0)).sum() >= 10:
                keep.append(nb)
        v1 = (m.kf_kp_valid[kf_id]) & (m.kf_obs_pt[kf_id] < 0)
        if not keep or v1.sum() < 10:
            m.update_covisibility(kf_id)
            return None
        # Padded to the configured count as in the reference (padding rows
        # carry v2 = False and give no output).
        nbrs = np.asarray(keep + [keep[0]] * (n_nbr - len(keep)), np.int64)
        pad = np.arange(len(nbrs)) >= len(keep)
        v2 = m.kf_kp_valid[nbrs] & (m.kf_obs_pt[nbrs] < 0) & ~pad[:, None]
        dm = map_device.sync(m, self.cfg, self.device)
        res = triangulate_all(dm.kf_feats, dm.kf_poses, kf_id,
                              self._up(nbrs), self._up(v1), self._up(v2),
                              self.cfg)
        return {"res": res, "nbrs": nbrs, "n_keep": len(keep),
                "v1_len": v1.shape[0]}

    def _tri_writeback(self, kf_id: int, pending) -> None:
        m = self.map
        packed = pending["res"].cpu().numpy()
        idx1_all = packed[..., 0].astype(np.int64)
        good_all = packed[..., 1] > 0.5
        idx2_all = packed[..., 2].astype(np.int64)
        pts_all = packed[..., 3:6]
        nbrs, n_keep = pending["nbrs"], pending["n_keep"]

        # Sequential semantics: the first (best-covisible) neighbour that
        # triangulates a keypoint claims it; associations made since the
        # dispatch are respected.
        claimed = np.zeros(pending["v1_len"], bool)
        claimed |= m.kf_obs_pt[kf_id] >= 0
        for b, nb in enumerate(nbrs[:n_keep]):
            good = good_all[b] & ~claimed[idx1_all[b]]
            nb_free = m.kf_obs_pt[int(nb)] < 0
            good &= nb_free[idx2_all[b]]
            if not good.any():
                continue
            rows = np.nonzero(good)[0]
            slots1 = idx1_all[b][rows]
            claimed[slots1] = True
            slots2 = idx2_all[b][rows]
            pts = pts_all[b][rows]
            ids = m.add_points(pts, m.kf_desc[kf_id][slots1],
                               first_kf=kf_id,
                               angles=m.kf_angle[kf_id][slots1])
            ok = ids >= 0
            # New points have empty observation rows: wire both views.
            s1, s2, pid = slots1[ok], slots2[ok], ids[ok]
            m.kf_obs_pt[kf_id, s1] = pid
            m.kf_obs_pt[int(nb), s2] = pid
            m.pt_obs_kf[pid, 0] = kf_id
            m.pt_obs_slot[pid, 0] = s1
            m.pt_obs_kf[pid, 1] = int(nb)
            m.pt_obs_slot[pid, 1] = s2
            m.update_point_stats(pid)
        m.update_covisibility(kf_id)

    # ------------------------------------------------------------------ #
    # culling of recent points
    # ------------------------------------------------------------------ #

    def cull_map_points(self, kf_id: int) -> None:
        """Points created in the last keyframes must be found in >= 25 % of
        the frames that predicted them visible and gather enough
        observations; age is counted in insertion sequence numbers."""
        m = self.map
        cfg = self.cfg.mapping
        pids = m.valid_points()
        if len(pids) == 0:
            return
        age = m.kf_seq_counter - 1 - m.pt_first_seq[pids]
        recent = age <= 3
        found_ratio = m.pt_found[pids] / np.maximum(m.pt_visible[pids], 1)
        obs_count = m.point_observation_count(pids)
        bad = recent & ((found_ratio < cfg.min_found_ratio)
                        | ((age >= 2) & (obs_count < cfg.min_observations)))
        for pid in pids[bad]:
            m.remove_point(int(pid))
        self.n_culled_pt += int(bad.sum())

    # ------------------------------------------------------------------ #
    # fusion of duplicates across covisible neighbours
    # ------------------------------------------------------------------ #

    def _fuse_dispatch(self, kf_id: int):
        """Project the keyframe's points into its covisible neighbours and
        find merge candidates; uploads ids only."""
        m = self.map
        neighbors = m.best_covisible(kf_id, N_FUSE_NBR)
        if len(neighbors) == 0:
            return None
        own = m.kf_obs_pt[kf_id]
        own_pids = own[own >= 0]
        if len(own_pids) == 0:
            return None
        n_pad = m.kf_uv.shape[1]
        own_ids = np.zeros(n_pad, np.int64)
        own_ids[:len(own_pids)] = own_pids
        own_valid = np.zeros(n_pad, bool)
        own_valid[:len(own_pids)] = True
        nbp = np.asarray(list(neighbors)
                         + [int(neighbors[0])] * (N_FUSE_NBR - len(neighbors)),
                         np.int64)[:N_FUSE_NBR]
        dm = map_device.sync(m, self.cfg, self.device)
        slots = fuse_all(dm.points, dm.kf_feats, dm.kf_poses,
                         self._up(own_ids), self._up(own_valid),
                         self._up(nbp), self.cfg)
        return {"slots": slots, "own_pids": own_pids,
                "nbrs": nbp[:len(neighbors)]}

    def _fuse_writeback(self, kf_id: int, pending) -> None:
        m = self.map
        slots_all = pending["slots"].cpu().numpy()
        own_pids = pending["own_pids"]
        n_own = len(own_pids)
        for b, nb in enumerate(pending["nbrs"]):
            nb = int(nb)
            slots = slots_all[b][:n_own]
            cand = (slots >= 0) & m.pt_valid[own_pids]
            if not cand.any():
                continue
            pids_c = own_pids[cand]
            slots_c = slots[cand]
            # Two own points on one neighbour keypoint: the first wins.
            _, first = np.unique(slots_c, return_index=True)
            pids_c, slots_c = pids_c[first], slots_c[first]
            other = m.kf_obs_pt[nb, slots_c]

            # Unclaimed keypoint: extend the track.
            ext = other < 0
            if ext.any():
                p_ext, s_ext = pids_c[ext], slots_c[ext]
                rows = m.pt_obs_kf[p_ext]
                free = rows < 0
                has_free = free.any(1)
                col = np.argmax(free, 1)
                p_ext, s_ext, col = p_ext[has_free], s_ext[has_free], \
                    col[has_free]
                m.kf_obs_pt[nb, s_ext] = p_ext
                m.pt_obs_kf[p_ext, col] = nb
                m.pt_obs_slot[p_ext, col] = s_ext

            # Duplicate landmark: keep the better-observed one.
            dup = (other >= 0) & (other != pids_c) \
                & m.pt_valid[np.clip(other, 0, None)]
            if dup.any():
                own_counts = m.point_observation_count(pids_c[dup])
                other_counts = m.point_observation_count(other[dup])
                for pid_own, oth, co, ct in zip(pids_c[dup], other[dup],
                                                own_counts, other_counts):
                    if not (m.pt_valid[pid_own] and m.pt_valid[oth]):
                        continue
                    keep, drop = (int(pid_own), int(oth)) if co >= ct \
                        else (int(oth), int(pid_own))
                    m.replace_point(drop, keep)
        m.update_covisibility(kf_id)

    # ------------------------------------------------------------------ #
    # local bundle adjustment over the covisible window
    # ------------------------------------------------------------------ #

    def _ba_dispatch(self, kf_id: int):
        """Assemble the covisibility window and dispatch the local BA."""
        m = self.map
        opt_kfs = np.concatenate([[kf_id],
                                  m.best_covisible(kf_id, WINDOW_KF // 2 - 1)])
        opt_kfs = np.unique(opt_kfs)[:WINDOW_KF // 2]
        opt_set = set(int(k) for k in opt_kfs)

        pts = m.local_map_points(opt_kfs, WINDOW_PT)
        pts = pts[pts >= 0]

        # Fixed frontier: other keyframes observing window points.
        obs_kfs = np.unique(m.pt_obs_kf[pts])
        obs_kfs = obs_kfs[obs_kfs >= 0]
        frontier = np.array([k for k in obs_kfs if int(k) not in opt_set],
                            dtype=np.int64)[:WINDOW_KF - len(opt_kfs)]
        window = np.concatenate([opt_kfs, frontier]).astype(np.int64)
        # Anchor: the oldest keyframe of the window, plus the frontier.
        fixed = np.zeros(len(window), bool)
        fixed[len(opt_kfs):] = True
        fixed[np.argmin(window)] = True
        kf_index = {int(k): i for i, k in enumerate(window)}

        K, P, M = WINDOW_KF, WINDOW_PT, WINDOW_OBS
        kf_fixed = np.ones(K, bool)
        kf_valid = np.zeros(K, bool)
        kf_fixed[:len(window)] = fixed
        kf_valid[:len(window)] = True

        n_pts = min(len(pts), P)
        pts = pts[:n_pts]
        pt_ids = np.zeros(P, np.int64)
        pt_ids[:n_pts] = pts
        pt_valid = np.zeros(P, bool)
        pt_valid[:n_pts] = True

        # Observation table: (keyframe, slot) per cell as one code.
        okf = m.pt_obs_kf[pts]          # [n, MAX_OBS]
        oslot = m.pt_obs_slot[pts]
        in_window = np.isin(okf, window) & (okf >= 0)
        order = np.argsort(~in_window, axis=1, kind="stable")[:, :M]
        sel = np.take_along_axis(in_window, order, 1)
        gkf = np.take_along_axis(okf, order, 1)
        gslot = np.take_along_axis(oslot, order, 1)
        n_kp = m.kf_uv.shape[1]
        packed = np.full((P, M), -1, np.int64)
        packed[:n_pts] = np.where(sel, gkf.astype(np.int64) * n_kp + gslot,
                                  -1)

        kf_index_map = np.full(m.kf_R.shape[0] + 1, -1, np.int64)
        for g, w_idx in kf_index.items():
            kf_index_map[g] = w_idx

        window_ids = np.zeros(WINDOW_KF, np.int64)
        window_ids[:len(window)] = window
        dm = map_device.sync(m, self.cfg, self.device)
        result = ba_assemble_solve(
            dm.kf_feats, dm.kf_poses, dm.points, self._up(window_ids),
            self._up(kf_fixed), self._up(kf_valid), self._up(kf_index_map),
            self._up(pt_ids), self._up(pt_valid), self._up(packed), self.cfg)
        self.n_local_ba += 1
        return {"result": result, "window": window, "fixed": fixed,
                "pts": pts, "n_pts": n_pts, "okf": okf, "oslot": oslot,
                "in_window": in_window, "packed": packed}

    def _ba_writeback(self, kf_id: int, pending) -> None:
        m = self.map
        window, fixed = pending["window"], pending["fixed"]
        pts, n_pts = pending["pts"], pending["n_pts"]
        flat = pending["result"].cpu().numpy()
        K, P, M = WINDOW_KF, WINDOW_PT, WINDOW_OBS
        o = 0
        new_R = flat[o:o + K * 9].reshape(K, 3, 3); o += K * 9
        new_t = flat[o:o + K * 3].reshape(K, 3); o += K * 3
        new_pos = flat[o:o + P * 3].reshape(P, 3); o += P * 3
        ov = flat[o:o + P * M].reshape(P, M) > 0.5

        for i, k in enumerate(window):
            if not fixed[i]:
                m.set_keyframe_pose(int(k), new_R[i], new_t[i])
        live = m.pt_valid[pts]       # points culled since dispatch stay dead
        m.pt_pos[pts[live]] = new_pos[:n_pts][live]
        m.mark_points_dirty(pts[live])
        m.bump()

        # Erase the observations the BA gated out: map each filled cell
        # back to its source column, then loop over the removals only.
        okf, oslot = pending["okf"], pending["oslot"]
        in_window, packed = pending["in_window"], pending["packed"]
        ov = ov[:n_pts]
        filled = packed[:n_pts] >= 0
        order = np.argsort(~in_window, axis=1, kind="stable")
        src_col = order[:, :WINDOW_OBS]
        bad_i, bad_j = np.nonzero(filled & ~ov)
        for i, j in zip(bad_i, bad_j):
            if not m.pt_valid[pts[i]]:
                continue
            c = src_col[i, j]
            kf_g, slot = int(okf[i, c]), int(oslot[i, c])
            m._remove_observation(int(pts[i]), kf_g)
            if m.kf_obs_pt[kf_g, slot] == pts[i]:
                m.kf_obs_pt[kf_g, slot] = -1

    # ------------------------------------------------------------------ #
    # culling of redundant keyframes
    # ------------------------------------------------------------------ #

    # The stages one at a time, dispatch then write-back (as the tests of
    # either package drive them).
    def create_new_map_points(self, kf_id: int) -> None:
        pending = self._tri_dispatch(kf_id)
        if pending is not None:
            self._tri_writeback(kf_id, pending)

    def fuse_neighbors(self, kf_id: int) -> None:
        pending = self._fuse_dispatch(kf_id)
        if pending is not None:
            self._fuse_writeback(kf_id, pending)

    def run_local_ba(self, kf_id: int) -> None:
        self._ba_writeback(kf_id, self._ba_dispatch(kf_id))

    def cull_keyframes(self, kf_id: int) -> None:
        """A covisible keyframe whose points are >= 90 % observed by >= 3
        other keyframes is redundant."""
        m = self.map
        cfg = self.cfg.mapping
        for k in m.best_covisible(kf_id, 10):
            k = int(k)
            if k == 0 or not m.kf_valid[k]:
                continue
            obs = m.kf_obs_pt[k]
            slots = np.nonzero(obs >= 0)[0]
            if len(slots) < 50:
                continue
            counts = m.point_observation_count(obs[slots])
            redundant = (counts >= cfg.kf_cull_min_obs + 1).sum()
            if redundant > cfg.kf_cull_redundancy_ratio * len(slots):
                m.remove_keyframe(k)
                self.n_culled_kf += 1
