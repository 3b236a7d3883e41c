"""Global bundle adjustment of a host map arena: every keyframe and point
in one solve, with the first keyframe fixed.

Counterpart of ``coebslam_tpu/slam/global_ba.py``. The problem keeps the
reference's shapes: keyframes padded to a bucket K in 16...512, points to
P in 4096...32768, streamed through the Schur assembly in P // 4096
blocks (``optim.local_ba.optimize_global_ba``), and at most
``GLOBAL_OBS`` observations per point (the cut ones are counted in
``truncated_obs``). The host uploads one packed (keyframe, slot) table per
run; uv, ur and level are gathered on the device from the arena's mirror
(``slam/map_device.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..optim import local_ba
from ..utils.device import resolve_device
from . import map_device
from .map import MapArena

GLOBAL_OBS = 16      # observations per point carried into the solve


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class GlobalBA:
    """Assembles the arena's problem, solves it on ``device`` (default
    CUDA) and writes the poses and points back."""

    def __init__(self, cfg: SystemConfig, max_obs: int = GLOBAL_OBS,
                 device=None):
        self.cfg = cfg
        self.max_obs = max_obs
        self.device = resolve_device(device, "GlobalBA")
        self.truncated_obs = 0       # observations cut at max_obs

    def _solve(self, dm, n_kp: int, n_blocks: int, window_ids, kf_fixed,
               kf_valid, win_of_kf, pt_ids, pt_valid, packed):
        uv_a, _, lvl_a, ur_a, _ = dm.kf_feats
        R_a, t_a = dm.kf_poses
        ok = packed >= 0
        code = torch.clamp(packed, min=0)
        g = code // n_kp
        s = code % n_kp
        widx = torch.where(ok, win_of_kf[g], torch.full_like(g, -1))
        lvl = lvl_a[g, s].to(torch.float32)
        sf2 = torch.full_like(lvl, self.cfg.orb.scale_factor ** 2)
        prob = local_ba.BAProblem(
            kf_R=R_a[window_ids], kf_t=t_a[window_ids],
            kf_fixed=kf_fixed, kf_valid=kf_valid,
            pt_pos=dm.points[0][pt_ids], pt_valid=pt_valid,
            obs_kf=widx, obs_uvr=torch.cat([uv_a[g, s], ur_a[g, s][..., None]],
                                           -1),
            obs_w=1.0 / torch.pow(sf2, lvl), obs_valid=ok & (widx >= 0))
        return local_ba.optimize_global_ba(prob, self.cfg.camera,
                                           self.cfg.optimizer,
                                           n_blocks=n_blocks)

    def run(self, m: MapArena, fixed_kf: Optional[int] = None) -> int:
        """Optimize all valid keyframes and points in place. Returns the
        number of optimized keyframes. ``fixed_kf`` defaults to the map's
        first keyframe."""
        kfs = m.valid_keyframes()
        pts = m.valid_points()
        if len(kfs) < 3 or len(pts) == 0:
            return 0
        K = _bucket(len(kfs), (16, 64, 128, 256, 512))
        P = _bucket(len(pts), (4096, 8192, 16384, 32768))
        M = self.max_obs
        n_kp = m.kf_uv.shape[1]
        n_blocks = max(1, P // 4096)

        window_ids = np.zeros(K, np.int64)
        window_ids[:len(kfs)] = kfs
        kf_valid = np.zeros(K, bool)
        kf_valid[:len(kfs)] = True
        kf_fixed = ~kf_valid
        anchor = fixed_kf if fixed_kf is not None else int(kfs[0])
        kf_fixed[np.nonzero(window_ids == anchor)[0][:1]] = True

        win_of_kf = np.full(m.kf_R.shape[0] + 1, -1, np.int64)
        win_of_kf[window_ids[:len(kfs)]] = np.arange(len(kfs))

        pt_ids = np.zeros(P, np.int64)
        pt_ids[:len(pts)] = pts
        pt_valid = np.zeros(P, bool)
        pt_valid[:len(pts)] = True

        okf = m.pt_obs_kf[pts]                  # [n, MAX_OBS]
        oslot = m.pt_obs_slot[pts]
        live = okf >= 0
        order = np.argsort(~live, axis=1, kind="stable")[:, :M]
        sel = np.take_along_axis(live, order, 1)
        gkf = np.take_along_axis(okf, order, 1)
        gslot = np.take_along_axis(oslot, order, 1)
        self.truncated_obs += int(live.sum() - sel.sum())
        packed = np.full((P, M), -1, np.int64)
        packed[:len(pts)] = np.where(sel, gkf.astype(np.int64) * n_kp + gslot,
                                     -1)

        dm = map_device.sync(m, self.cfg, self.device)
        up = lambda a: torch.from_numpy(a).to(self.device)
        result = self._solve(dm, n_kp, n_blocks, up(window_ids),
                             up(kf_fixed), up(kf_valid), up(win_of_kf),
                             up(pt_ids), up(pt_valid), up(packed))
        new_R = result.kf_R.cpu().numpy()
        new_t = result.kf_t.cpu().numpy()
        new_pos = result.pt_pos.cpu().numpy()
        for i, k in enumerate(kfs):
            if int(k) != anchor:
                m.set_keyframe_pose(int(k), new_R[i], new_t[i])
        still = m.pt_valid[pts]
        m.pt_pos[pts[still]] = new_pos[:len(pts)][still]
        m.mark_points_dirty(pts[still])
        m.bump()
        return len(kfs)
