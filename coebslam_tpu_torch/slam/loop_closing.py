"""Loop closing: detection, Sim3 computation, correction, pose graph, GBA.

Counterpart of ``coebslam_tpu/slam/loop_closing.py`` (the reference's
``LoopClosing`` thread) as a host-driven procedure over the arena, with
the solves on the device:

  detect       — BoW candidates above the covisibility min-score, kept
                 only after 3 consecutive consistent detections
  compute_sim3 — descriptor matches current KF <-> candidate's points,
                 batched 3-point Horn RANSAC, Sim3 refinement, guided
                 projection of the loop neighbourhood for enough matches
  correct      — move the current covisibility group and its points by the
                 corrected pose, fuse duplicates (``_search_and_fuse``,
                 batched over the group), add the loop edge, solve the
                 essential graph (``run_pose_graph``), then flush the
                 mapper and run global BA

The host reads the card at each gate of ``compute_sim3`` (the matches, the
RANSAC and Sim3 inlier counts, the guided matches), once for the group's
corrected poses and points, once for the fused slots and once for the
pose graph's solution. The RANSAC draws come from a generator seeded 13,
or from ``sampler`` (a test hook).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..config import SystemConfig
from ..geometry import camera as cam_ops
from ..geometry import se3 as se3_mod
from ..geometry.se3 import SE3
from ..geometry.sim3 import Sim3
from ..ops import brief, matching, procrustes
from ..ops.fundamental import RansacSampler, draw
from ..optim import pose_graph as pg_mod
from ..optim import sim3_opt
from ..utils.device import resolve_device
from . import map_device
from .keyframe_db import KeyFrameDatabase
from .map import MapArena

LOOP_SEED = 13
# The JAX package's public constant, which neither package reads; kept so
# that every public name of the JAX package has its counterpart here
# (tests/test_torch_surface.py).
MAX_EDGES = 4096
FUSE_POINTS = 4096   # loop points projected into the corrected group
FUSE_CHUNK = 8       # group keyframes per batch of the fuse search


class LoopCloser:
    def __init__(self, cfg: SystemConfig, arena: MapArena,
                 kf_db: KeyFrameDatabase, mapper=None, device=None,
                 sampler: Optional[RansacSampler] = None):
        self.cfg = cfg
        self.map = arena
        self.db = kf_db
        self.mapper = mapper
        self.device = resolve_device(device, "LoopCloser")
        self.sampler = sampler
        self._global_ba = None      # made at the first correction
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(LOOP_SEED)
        # Sequence number (not keyframe id: ids are recycled) of the last
        # accepted loop; gates re-detection for 10 insertions.
        self.last_loop_seq = -(10 ** 9)
        self._consistency: List[Dict] = []   # prior candidate groups
        self.loop_edges: List = []           # (kf_a, kf_b) accepted loops
        self.n_loops_closed = 0

    def _up(self, a, dtype=None) -> torch.Tensor:
        """Host rows -> device, through pinned memory on the card, without
        waiting for queued device work."""
        t = torch.from_numpy(np.array(a))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _signed(self, desc_u8) -> torch.Tensor:
        return brief.to_signed(brief.unpack_bits(self._up(desc_u8)))

    # ------------------------------------------------------------------ #

    def insert_keyframe(self, kf_id: int) -> None:
        cand = self.detect(kf_id)
        if cand < 0:
            return
        ok, S_corr = self.compute_sim3(kf_id, cand)
        if not ok:
            return
        self.correct(kf_id, cand, S_corr)
        self.n_loops_closed += 1

    # ------------------------------------------------------------------ #

    def detect(self, kf_id: int) -> int:
        """Returns a consistent loop-candidate KF id or -1."""
        m = self.map
        seq = int(m.kf_seq[kf_id])
        if seq < 10 or seq - self.last_loop_seq < 10:
            self._consistency = []
            return -1
        # minScore: lowest BoW similarity among covisible neighbours.
        nbrs = m.covisible_keyframes(kf_id, min_weight=15)
        if len(nbrs) == 0:
            return -1
        sims = self.db.score_kf(kf_id, nbrs)
        min_score = float(sims.min()) * self.cfg.loop.min_score_factor

        cands = self.db.detect_loop_candidates(kf_id, min_score)
        if len(cands) == 0:
            self._consistency = []
            return -1

        # Covisibility consistency over 3 consecutive keyframes.
        new_groups = []
        chosen = -1
        for c in cands:
            group = set(int(k) for k in m.covisible_keyframes(int(c), 1))
            group.add(int(c))
            count = 0
            for prev in self._consistency:
                if group & prev["group"]:
                    count = prev["count"] + 1
                    break
            new_groups.append({"group": group, "count": count})
            if count >= self.cfg.loop.covisibility_consistency_threshold \
                    and chosen < 0:
                chosen = int(c)
        self._consistency = new_groups
        return chosen

    # ------------------------------------------------------------------ #

    def _kf_point_table(self, kf: int):
        obs = self.map.kf_obs_pt[kf]
        slots = np.nonzero((obs >= 0)
                           & self.map.pt_valid[np.clip(obs, 0, None)])[0]
        return slots, obs[slots]

    def compute_sim3(self, kf_id: int, cand: int):
        """Returns (ok, corrected Sim3 S_cw for the current KF)."""
        m = self.map
        cfg = self.cfg
        self.last_debug = {"stage": "points", "n1": 0, "n2": 0}
        slots1, pids1 = self._kf_point_table(kf_id)
        slots2, pids2 = self._kf_point_table(cand)
        self.last_debug.update(n1=len(pids1), n2=len(pids2))
        if len(pids1) < cfg.loop.min_bow_matches \
                or len(pids2) < cfg.loop.min_bow_matches:
            return False, None

        # Descriptor matching between the two keyframes' map points.
        dist = matching.hamming_matrix(self._signed(m.pt_desc[pids1]),
                                       self._signed(m.pt_desc[pids2]))
        res = matching.match(dist, max_distance=cfg.matcher.th_low,
                             ratio=cfg.matcher.nn_ratio_bow, mutual=True)
        sel, idx2 = torch.stack([res.valid.to(torch.int64),
                                 res.idx]).cpu().numpy()
        sel = sel.astype(bool)
        self.last_debug.update(stage="match", n_match=int(sel.sum()))
        if sel.sum() < cfg.loop.min_bow_matches:
            return False, None

        # Matched landmark positions in each keyframe's camera frame.
        i2 = np.clip(idx2, 0, None)
        T1 = SE3(self._up(m.kf_R[kf_id]), self._up(m.kf_t[kf_id]))
        T2 = SE3(self._up(m.kf_R[cand]), self._up(m.kf_t[cand]))
        p1_c1 = se3_mod.transform_points(T1, self._up(m.pt_pos[pids1]))
        p2_c2 = se3_mod.transform_points(T2, self._up(m.pt_pos[pids2[i2]]))
        uv1 = self._up(m.kf_uv[kf_id, slots1])
        uv2 = self._up(m.kf_uv[cand, slots2[i2]])
        sel_d = self._up(sel)

        # RANSAC Sim3 (fixed scale for RGB-D): src = cam2 coords,
        # dst = cam1 coords; S12 maps cam2 -> cam1.
        H = cfg.loop.sim3_ransac_iters
        align = procrustes.ransac_alignment(
            p2_c2, p1_c1, sel_d,
            idx=draw(self.sampler, self._gen, sel_d, H, 3),
            n_hypotheses=H, cam=cfg.camera, obs_uv=uv1, px_threshold=6.0,
            with_scale=(cfg.sensor == "monocular"))
        n_ransac = int(align.n_inliers)
        self.last_debug.update(stage="ransac", ransac_inl=n_ransac)
        if n_ransac < cfg.loop.sim3_ransac_min_inliers:
            return False, None

        S12 = Sim3(align.scale, align.R, align.t)
        opt = sim3_opt.optimize_sim3(
            S12, p1_c1, p2_c2, uv1, uv2, sel_d & align.inliers, cfg.camera,
            cfg.optimizer, fix_scale=(cfg.sensor != "monocular"))
        n_sim3 = int(opt.n_inliers)
        self.last_debug.update(stage="sim3opt", sim3_inl=n_sim3)
        if n_sim3 < cfg.loop.min_sim3_inliers:
            return False, None

        # Guided projection against the loop neighbourhood for total
        # support.
        nbr = np.concatenate([[cand], m.best_covisible(cand, 10)])
        nbr_pts = m.local_map_points(nbr, 4096)
        nbr_pts = nbr_pts[nbr_pts >= 0]
        # Kept for correct's search-and-fuse (the reference's
        # mvpLoopMapPoints).
        self._loop_pts = nbr_pts.copy()
        S1w = opt.S12.compose(Sim3.from_se3(T2.R, T2.t))   # corrected S_cw
        pn_c1 = S1w.apply(self._up(m.pt_pos[nbr_pts]))
        uv_pred = cam_ops.project(cfg.camera, pn_c1)
        vis = (pn_c1[:, 2] > 0.05) \
            & (uv_pred[:, 0] >= 0) & (uv_pred[:, 0] < cfg.camera.width) \
            & (uv_pred[:, 1] >= 0) & (uv_pred[:, 1] < cfg.camera.height)
        dmat = matching.hamming_matrix(self._signed(m.kf_desc[kf_id]),
                                       self._signed(m.pt_desc[nbr_pts]))
        dmat = dmat + matching.window_penalty(self._up(m.kf_uv[kf_id]),
                                              uv_pred, 8.0)
        res2 = matching.match(dmat, max_distance=cfg.matcher.th_low,
                              mutual=True,
                              row_valid=self._up(m.kf_kp_valid[kf_id]),
                              col_valid=vis)
        total = int(res2.valid.sum())
        self.last_debug.update(stage="guided", total=total)
        if total < cfg.loop.min_total_matches:
            return False, None
        self.last_debug.update(stage="accepted")
        return True, S1w

    # ------------------------------------------------------------------ #

    def correct(self, kf_id: int, cand: int, S_corr: Sim3) -> None:
        """CorrectLoop: the group's poses and points, search-and-fuse, the
        loop edge, the essential graph, then global BA."""
        m = self.map
        # Pre-correction poses: the essential graph's edges between
        # uncorrected keyframes are measured in the drifted-but-consistent
        # frame (the reference's NonCorrectedSim3).
        self._snapshot_R = m.kf_R.copy()
        self._snapshot_t = m.kf_t.copy()
        group = np.concatenate([[kf_id], m.covisible_keyframes(kf_id, 1)])
        group = group.astype(np.int64)

        # Every group member k: S_new = (T_k T_cur^-1) S_corr, one batch.
        T_old = Sim3.from_se3(self._up(m.kf_R[kf_id]),
                              self._up(m.kf_t[kf_id]))
        T_k = Sim3.from_se3(self._up(m.kf_R[group]), self._up(m.kf_t[group]))
        S_new = T_k.compose(Sim3(*(x.expand(len(group), *x.shape)
                                   for x in T_old.inverse()))).compose(
            Sim3(*(x.expand(len(group), *x.shape) for x in S_corr)))

        # The group's points move through the first member (in group order)
        # that observes them: X_new = S_new^-1(T_k(X)).
        moved: Set[int] = set()
        per_k = []
        for k in group:
            obs = m.kf_obs_pt[k]
            pids = obs[obs >= 0]
            pids = pids[m.pt_valid[pids]]
            pids = np.asarray([p for p in pids if p not in moved], np.int64)
            moved.update(int(p) for p in pids)
            per_k.append(pids)
        all_p = np.concatenate(per_k)
        which = self._up(np.repeat(np.arange(len(group)),
                                   [len(p) for p in per_k]))
        X = self._up(m.pt_pos[all_p])
        Tw = Sim3(*(x[which] for x in T_k))
        Sw = Sim3(*(x[which] for x in S_new))
        X_new = Sw.inverse().apply(Tw.apply(X))
        mtx = S_new.to_se3_matrix()
        out = torch.cat([mtx.reshape(-1), X_new.reshape(-1)]).cpu().numpy()
        mtx = out[:mtx.numel()].reshape(-1, 4, 4)
        X_new = out[mtx.size:].reshape(-1, 3)

        start = 0
        for b, k in enumerate(group):
            Rn = mtx[b, :3, :3]
            for _ in range(2):          # polar re-projection onto SO(3)
                Rn = 1.5 * Rn - 0.5 * Rn @ Rn.T @ Rn
            m.set_keyframe_pose(int(k), Rn, mtx[b, :3, 3])
            pids = per_k[b]
            if len(pids) == 0:
                continue
            m.pt_pos[pids] = X_new[start:start + len(pids)]
            start += len(pids)
            m.mark_points_dirty(pids)
            m.bump()

        self.loop_edges.append((kf_id, cand))
        self.last_loop_seq = int(m.kf_seq[kf_id])
        self._consistency = []

        # Search-and-fuse: the covisibility links it creates across the
        # loop ("fused connections") become extra essential-graph edges.
        group_ids = [int(k) for k in group]
        pre_nbrs = {k: set(int(j) for j in m.covisible_keyframes(k, 1))
                    for k in group_ids}
        self._search_and_fuse(group_ids)
        fused = []
        group_set = set(group_ids)
        for k in group_ids:
            post = set(int(j) for j in m.covisible_keyframes(k, 1))
            for j in post - pre_nbrs[k] - group_set:
                fused.append((k, j))
        self._fused_edges = fused

        self.run_pose_graph(fixed_kf=cand)
        # Global BA after the essential graph, with the mapper drained
        # first so nothing is created mid-solve.
        if self.mapper is not None:
            self.mapper.flush()
        if self._global_ba is None:
            from .global_ba import GlobalBA
            self._global_ba = GlobalBA(self.cfg, device=self.device)
        self._global_ba.run(self.map, fixed_kf=cand)

    # ------------------------------------------------------------------ #

    def _fuse_slots(self, dm, pt_ids, pt_valid, kf_idx):
        """[G, P] keypoint slot each loop point fuses into in each group
        keyframe (-1 none): projection with the corrected pose, a 4 px
        window, the least Hamming distance within ``th_low``."""
        cam = self.cfg.camera
        pos = dm.points[0][pt_ids]
        sd = dm.points[1][pt_ids]
        uv_a, desc_a, _, _, val_a = dm.kf_feats
        R_a, t_a = dm.kf_poses
        out = []
        for s in range(0, kf_idx.shape[0], FUSE_CHUNK):
            k = kf_idx[s:s + FUSE_CHUNK]
            pc = torch.einsum("gij,pj->gpi", R_a[k], pos) + t_a[k][:, None]
            z = torch.clamp(pc[..., 2], min=1e-6)
            u = cam.fx * pc[..., 0] / z + cam.cx
            v = cam.fy * pc[..., 1] / z + cam.cy
            vis = pt_valid & (pc[..., 2] > 0.05) & (u >= 0) \
                & (u < cam.width) & (v >= 0) & (v < cam.height)
            nb_sd = brief.to_signed(brief.unpack_bits(desc_a[k]))
            ham = 0.5 * (brief.N_BITS - sd @ nb_sd.transpose(-1, -2))
            uv = uv_a[k]
            # Fuse radius 4 px.
            close = (torch.abs(uv[:, None, :, 0] - u[..., None]) <= 4.0) \
                & (torch.abs(uv[:, None, :, 1] - v[..., None]) <= 4.0) \
                & val_a[k][:, None, :]
            ham = torch.where(close, ham, torch.full_like(ham, 1e9))
            best, slot = torch.min(ham, -1)
            hit = vis & (best <= self.cfg.matcher.th_low)
            out.append(torch.where(hit, slot, torch.full_like(slot, -1)))
        return torch.cat(out)

    def _search_and_fuse(self, group_ids) -> None:
        """Project the kept loop map points into each corrected group
        keyframe: a keypoint that already observes a landmark gets it
        replaced by the loop point (the loop side wins, MapPoint::Replace);
        a free keypoint gains an observation. One device search over the
        group; the host writes back only the hits, in loop-point order."""
        m = self.map
        loop_pts = getattr(self, "_loop_pts", None)
        if loop_pts is None or len(loop_pts) == 0 or len(group_ids) == 0:
            return
        loop_pts = loop_pts[m.pt_valid[loop_pts]]
        if len(loop_pts) == 0:
            return

        pt_ids = np.zeros(FUSE_POINTS, np.int64)
        n = min(len(loop_pts), FUSE_POINTS)
        pt_ids[:n] = loop_pts[:n]
        pt_valid = np.zeros(FUSE_POINTS, bool)
        pt_valid[:n] = True
        dm = map_device.sync(m, self.cfg, self.device)
        slots = self._fuse_slots(dm, self._up(pt_ids), self._up(pt_valid),
                                 self._up(np.asarray(group_ids, np.int64))
                                 ).cpu().numpy()

        for b, k in enumerate(group_ids):
            hits = np.nonzero(slots[b][:n] >= 0)[0]
            if len(hits) == 0:
                continue
            # One keypoint slot can win several loop points: the first (in
            # loop-point order) is kept, as the reference's sequential Fuse.
            seen = set()
            for i in hits:
                lp = int(pt_ids[i])
                s = int(slots[b][i])
                if s in seen or not m.pt_valid[lp]:
                    continue
                seen.add(s)
                cur = int(m.kf_obs_pt[k, s])
                if cur == lp:
                    continue
                if cur >= 0 and m.pt_valid[cur]:
                    # Duplicate landmark across the loop: loop point wins.
                    m.replace_point(cur, lp)
                elif not (m.pt_obs_kf[lp] == k).any():
                    m.kf_obs_pt[k, s] = lp
                    m._add_observation(lp, k, s)
        for k in group_ids:
            m.update_covisibility(k)
        m.bump()

    def run_pose_graph(self, fixed_kf: int) -> None:
        """Build and solve the essential graph over all valid keyframes."""
        m = self.map
        cfg = self.cfg
        kfs = m.valid_keyframes()
        if len(kfs) < 3:
            return
        K = int(kfs.max()) + 1

        edges_i, edges_j = [], []
        # Spanning tree edges.
        for k in kfs:
            p = m.kf_parent[k]
            if p >= 0 and m.kf_valid[p]:
                edges_i.append(int(k))
                edges_j.append(int(p))
        # Strong covisibility edges (weight >= 100).
        cov = m.covis[:K, :K]
        ii, jj = np.nonzero(np.triu(cov, 1)
                            >= cfg.loop.essential_graph_min_covis)
        edges_i += ii.tolist()
        edges_j += jj.tolist()
        # Loop edges + fused cross-loop connections: measured from the
        # corrected poses below (they encode the closure, not the drift).
        fresh = [e for e in getattr(self, "_fused_edges", [])
                 if m.kf_valid[e[0]] and m.kf_valid[e[1]]]
        fresh += [e for e in self.loop_edges
                  if m.kf_valid[e[0]] and m.kf_valid[e[1]]]
        for a, b in fresh:
            edges_i.append(int(a))
            edges_j.append(int(b))

        E = len(edges_i)
        if E == 0:
            return
        ei = np.asarray(edges_i, np.int64)
        ej = np.asarray(edges_j, np.int64)
        n_loop = len(fresh)
        # Other edges: measured from the pre-correction snapshot (drifted
        # but internally consistent); that is what makes the graph
        # distribute the loop correction.
        snap_R = getattr(self, "_snapshot_R", m.kf_R)
        snap_t = getattr(self, "_snapshot_t", m.kf_t)
        Ri, ti = snap_R[ei].copy(), snap_t[ei].copy()
        Rj, tj = snap_R[ej].copy(), snap_t[ej].copy()
        if n_loop:
            Ri[-n_loop:] = m.kf_R[ei[-n_loop:]]
            ti[-n_loop:] = m.kf_t[ei[-n_loop:]]
            Rj[-n_loop:] = m.kf_R[ej[-n_loop:]]
            tj[-n_loop:] = m.kf_t[ej[-n_loop:]]
        R_rel = np.einsum("eij,ekj->eik", Ri, Rj)      # Ri Rj^T
        t_rel = ti - np.einsum("eij,ej->ei", R_rel, tj)

        valid_k = np.zeros(K, bool)
        valid_k[kfs] = True
        fixed = np.zeros(K, bool)
        fixed[fixed_kf] = True
        fixed[~valid_k] = True

        up, f32 = self._up, torch.float32
        ones = lambda n: torch.ones(n, dtype=f32, device=self.device)
        prob = pg_mod.PoseGraphProblem(
            s=ones(K), R=up(m.kf_R[:K]), t=up(m.kf_t[:K]),
            fixed=up(fixed), valid=up(valid_k),
            edge_i=up(ei), edge_j=up(ej), edge_s=ones(E),
            edge_R=up(R_rel, f32), edge_t=up(t_rel, f32),
            edge_valid=torch.ones(E, dtype=torch.bool, device=self.device),
            edge_weight=ones(E))
        out = pg_mod.optimize_pose_graph(
            prob, cfg.optimizer, fix_scale=(cfg.sensor != "monocular"))
        sol = torch.cat([out.R.reshape(K, 9), out.t, out.s[:, None]],
                        1).cpu().numpy()

        # Recover SE3 poses and remap points through their first-observing
        # keyframe; Newton polar re-projection of the rotations (the chain
        # of Sim3 composes leaves small manifold drift).
        new_R = sol[:, :9].reshape(K, 3, 3)
        for _ in range(2):
            new_R = 1.5 * new_R \
                - 0.5 * new_R @ new_R.transpose(0, 2, 1) @ new_R
        new_t = sol[:, 9:12] / sol[:, 12:]
        old_R = m.kf_R[:K].copy()
        old_t = m.kf_t[:K].copy()
        pids = m.valid_points()
        owner = m.pt_first_kf[pids]
        ok = (owner >= 0) & valid_k[np.clip(owner, 0, K - 1)]
        pids, owner = pids[ok], owner[ok]
        X = m.pt_pos[pids]
        Xc = np.einsum("pij,pj->pi", old_R[owner], X) + old_t[owner]
        Rn = new_R[owner]
        X_new = np.einsum("pji,pj->pi", Rn, Xc - new_t[owner])
        m.pt_pos[pids] = X_new
        m.mark_points_dirty(pids)
        m.bump()
        for k in kfs:
            m.set_keyframe_pose(int(k), new_R[k], new_t[k])
