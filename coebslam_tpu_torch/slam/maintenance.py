"""Map maintenance for the realtime mode: BoW loop closing, the place bank
and relocalization, dispatched by the host every few frames.

Counterpart of ``coebslam_tpu/slam/maintenance.py`` (the reference's
LoopClosing thread and its relocalization, brought into the realtime
state). Each dispatch:

1. **Processes the pending keyframes**: each gets a tf-idf BoW row from
   its full keypoint descriptor set (vocabulary descent) in the [K,
   n_words] ring database, and a compact sparse entry in the persistent
   place bank (top-k words, pose, a landmark subset).
2. **Detects** against the older ring rows (dense L1 scores) and the bank
   entries the ring has evicted (sparse scores), gated by the temporal
   neighbours' minimum score, a keyframe gap and a 3-keyframe consistency
   streak.
3. **Solves** a confirmed candidate: mutual-best Hamming matching of the
   two keyframes' landmarks, 3D-3D RANSAC of the new keyframe's depth
   observations against the old map positions.
4. **Corrects** an accepted closure: the Sim3 pose graph over the ring,
   the point and trajectory remap, the live pose re-based, SearchAndFuse
   and the junction BA (ring); or the chain anchored at the solved pose
   and the bank entry's landmarks staged into the seed arena (bank).
5. **Relocalizes** when tracking has been lost for several frames: the
   stashed newest frame against the ring's best candidate, then, if that
   fails, the best evicted bank place.

The reference runs the whole dispatch as one program with no readback,
every stage behind ``lax.cond``. Eager PyTorch branches on the host, so a
dispatch reads: per processed keyframe, one pair of bools (a confirmed
ring or bank candidate); per attempted closure, whether it was accepted;
and once, whether relocalization is needed. The loop bounds (the pending
keyframes) come from the host's own keyframe count. The bank attempt of
relocalization is computed whenever relocalization runs and applied under
a device-side condition, which gives the reference's state without
another read.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..geometry import so3 as so3_mod
from ..ops import brief, matching as matching_ops, procrustes
from ..ops.fundamental import sample_indices
from ..optim import pose_graph as pg
from ..utils.device import resolve_device
from . import realtime as rt
from . import vocabulary as voc_mod

LOG_ROWS = 16         # loop-event log capacity (per session)

# Loop policy constants (the reference's equivalents).
MIN_KF_GAP = 15       # candidate must be >= this many keyframes older
COOLDOWN_KFS = 10     # no re-detection sooner than this after a closure
REUSE_TTL = 120       # frames the revisited chunks stay in the local map
LOOP_EDGE_WEIGHT = 3.0
ALIGN_INLIER_M = 0.08      # 3D RANSAC consensus radius (loop)
ALIGN_FINAL_M = 0.03       # annealed refit radius: acceptance counts here
RELOC_INLIER_M = 0.07      # 3D RANSAC consensus radius (reloc)
RELOC_FINAL_M = 0.05       # annealed refit radius (reloc)
RELOC_AFTER_LOST = 4       # frames lost before relocalization fires
RELOC_MIN_INLIERS = 15
MAX_BACKLOG = 8            # keyframes BoW-processed per dispatch (bound)
N_HYPOTHESES = 256         # RANSAC hypotheses per solve

#: ``sampler(tag, valid) -> [N_HYPOTHESES, 3]`` sample indices of one
#: RANSAC solve; tags are ("loop", lid), ("bank", lid), ("reloc_ring",)
#: and ("reloc_bank",). None draws from the dispatch's generator.
Sampler = Callable[[tuple, torch.Tensor], torch.Tensor]


class MaintState(NamedTuple):
    kf_bow: torch.Tensor        # [K, n_words] float32 L1-normalized tf-idf
    bow_lid: torch.Tensor       # [K] logical id the row was built for
    bow_next: torch.Tensor      # next logical keyframe to process
    cand_lid: torch.Tensor      # last detection candidate (-1)
    streak: torch.Tensor        # consecutive-detection count
    last_loop_lid: torch.Tensor # newest keyframe of the last closure
    loop_log: torch.Tensor      # [LOG_ROWS, 6] (lid, cand, score, pairs,
                                #                inliers, applied)
    n_events: torch.Tensor      # confirmed candidates attempted
    n_loops: torch.Tensor       # closures applied
    n_reloc: torch.Tensor       # relocalizations applied
    # Persistent place bank: every processed keyframe leaves a sparse
    # top-k BoW row, its pose and a landmark subset for re-seeding.
    bank_lid: torch.Tensor      # [B] logical keyframe id (-1 empty)
    bank_next: torch.Tensor     # ring insertion cursor
    bank_bow_w: torch.Tensor    # [B, KW] f32 top-k word weights
    bank_bow_i: torch.Tensor    # [B, KW] word indices (-1 pad)
    bank_R: torch.Tensor        # [B, 3, 3] pose at insertion
    bank_t: torch.Tensor        # [B, 3]
    bank_pos: torch.Tensor      # [B, LB, 3] landmark subset (world)
    bank_desc: torch.Tensor     # [B, LB, 32] uint8 packed BRIEF
    bank_angle: torch.Tensor    # [B, LB]
    bank_normal: torch.Tensor   # [B, LB, 3]
    bank_mind: torch.Tensor     # [B, LB]
    bank_maxd: torch.Tensor     # [B, LB]
    bank_ok: torch.Tensor       # [B, LB] bool
    n_bank_loops: torch.Tensor  # closures against bank places
    n_bank_reloc: torch.Tensor  # relocalizations against bank places


def maint_state_from_numpy(d, device) -> MaintState:
    """Turn the JAX package's MaintState (leaves as numpy, e.g.
    ``jax.tree.map(np.asarray, ms)``) into this package's MaintState."""
    return MaintState(**{k: rt._to_tensor(getattr(d, k), device)
                         for k in MaintState._fields})


# --------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------- #


def _take(a, i):
    """``a[i]`` for a 0-d device index, without a host read."""
    return a.index_select(0, i.reshape(1))[0]


def _row(a, r):
    """Row ``r`` of ``a``: a Python int or a 0-d device index."""
    return a[r] if isinstance(r, int) else _take(a, r)


def _put(a, i, v):
    """``a`` with row ``i`` (Python int or 0-d tensor) set to ``v``, out of
    place."""
    if isinstance(i, int):
        i = torch.full((1,), i, dtype=torch.int64, device=a.device)
    return a.index_copy(0, i.reshape(1), v[None].to(a.dtype))


def _const(v, dtype, device):
    return torch.full((), v, dtype=dtype, device=device)


def _bow_vector(words, valid, weights, n_words: int):
    """Returns (L1-normalized bow, has_words). An empty query is flagged: a
    zero vector scores a uniform 0.5 against every normalized row."""
    wc = torch.clamp(words, min=0)
    w = torch.where(valid & (words >= 0), weights[wc], 0.0)
    bow = torch.zeros(n_words, dtype=torch.float32,
                      device=words.device).index_add_(0, wc, w)
    total = torch.sum(bow)
    return bow / torch.clamp(total, min=1e-9), total > 0.0


def _l1_scores(bow, rows):
    """DBoW2 L1 similarity of one vector against a row matrix."""
    return 1.0 - 0.5 * torch.sum(torch.abs(rows - bow[None, :]), dim=-1)


def _sparse_scores(bow, w, i):
    """L1 similarity of a dense query against sparse top-k rows: for
    L1-normalized non-negative vectors 1 - 0.5*sum|a-b| == sum min(a,b),
    so only the stored (index, weight) pairs are needed. Truncation
    underestimates uniformly, so bank scores are compared only with bank
    scores."""
    qv = bow[torch.clamp(i, min=0)]                  # [B, k]
    return torch.sum(torch.where(i >= 0, torch.minimum(qv, w), 0.0), dim=-1)


def _compact(mask, take_n: int):
    """First ``take_n`` set rows of a bool mask, as (src_idx, slot_valid)."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    take = mask & (rank < take_n)
    oh = (rank[None, :] == torch.arange(take_n, device=mask.device)[:, None]) \
        & take[None, :]
    return torch.argmax(oh.to(torch.uint8), dim=1), oh.any(dim=1)


def _cam_points(cam, uv, z):
    return torch.stack([(uv[:, 0] - cam.cx) / cam.fx * z,
                        (uv[:, 1] - cam.cy) / cam.fy * z, z], dim=-1)


def _kf_landmarks(st: rt.RTState, row, lim):
    """(logical pids, physical rows, validity) of one keyframe row's
    observed landmarks."""
    pids = _row(st.kf_pid, row)
    ph = rt.pid_phys(pids, lim)
    ok = rt.pid_alive(pids, st.kf_lid, lim) & st.pt_valid[ph]
    return pids, ph, ok


def _words(desc_u8, valid, dv: voc_mod.DeviceVocabulary):
    cur, _ = voc_mod.descend(dv, desc_u8)
    return torch.where(valid, dv.word_id[cur], torch.full_like(cur, -1))


def _draw(sampler: Optional[Sampler], gen, tag, valid):
    if sampler is not None:
        return sampler(tag, valid).to(valid.device)
    return sample_indices(valid, N_HYPOTHESES, gen, k=3)


def _mutual_pairs(sd_n, ok_n, sd_c, ok_c, th_low):
    """Mutual-best Hamming pairs: (j [N] best column, pair [N] bool)."""
    ham = matching_ops.hamming_matrix(sd_n, sd_c)
    ham = torch.where(ok_n[:, None] & ok_c[None, :], ham,
                      torch.full_like(ham, 1e9))
    j = torch.argmin(ham, dim=1)
    dmin = torch.amin(ham, dim=1)
    ibest = torch.argmin(ham, dim=0)
    mutual = ibest[j] == torch.arange(ham.shape[0], device=ham.device)
    return j, ok_n & (dmin <= th_low) & mutual


def _new_kf_points(cam, obs):
    """Camera-frame 3D of a keyframe's stereo-virtual observations (depth =
    bf / disparity) and which of them carry depth."""
    ur = obs[:, 2]
    disp = obs[:, 0] - ur
    has_d = (torch.abs(ur + 1.0) > 1e-4) & (disp > 0.1)
    z = cam.bf / torch.clamp(disp, min=0.1)
    return _cam_points(cam, obs[:, :2], z), has_d


def _accept(res, cfg):
    solve_ok = torch.isfinite(res.R).all() & torch.isfinite(res.t).all()
    strong = res.n_consensus >= 3 * cfg.loop.min_sim3_inliers
    return solve_ok & ((res.n_inliers >= cfg.loop.min_sim3_inliers) | strong)


def _log_event(ms: MaintState, lid: int, cand_lid, score, pair, res,
               accepted) -> MaintState:
    f32 = torch.float32
    dev = score.device
    ev = torch.stack([_const(float(lid), f32, dev), cand_lid.to(f32), score,
                      pair.sum().to(f32), res.n_inliers.to(f32),
                      accepted.to(f32)])
    log = _put(ms.loop_log, ms.n_events % LOG_ROWS, ev)
    return ms._replace(loop_log=log, n_events=ms.n_events + 1)


def _chain_edges(st: rt.RTState, K: int):
    """The sequential chain over the live ring: edge lid -> lid - 1 with its
    measured relative pose from the pre-correction poses."""
    dev = st.kf_R.device
    low = torch.clamp(st.n_kf - K, min=0)
    e_lids = low + 1 + torch.arange(K - 1, device=dev)
    e_ok = e_lids < st.n_kf
    ei = e_lids % K
    ej = (e_lids - 1) % K
    R_i, t_i = st.kf_R[ei], st.kf_t[ei]
    R_j, t_j = st.kf_R[ej], st.kf_t[ej]
    R_m = torch.einsum("eij,ekj->eik", R_i, R_j)       # R_i R_j^T
    t_m = t_i - torch.einsum("eij,ej->ei", R_m, t_j)
    return ei, ej, R_m, t_m, e_ok


def _remap_points(st: rt.RTState, Rn, tn, moved_kf, lim):
    """Ring point chunks through their owner's correction: x_c invariant,
    so x_w' = Rn^T (Ro x + to - tn). Seed rows past the ring stay."""
    S, PT = lim.spawn_per_kf, lim.max_kf * lim.spawn_per_kf
    A = torch.einsum("kji,kjl->kil", Rn, st.kf_R)      # Rn^T Ro
    b = torch.einsum("kji,kj->ki", Rn, st.kf_t - tn)
    owner = torch.arange(PT, device=Rn.device) // S
    ring_pos = st.pt_pos[:PT]
    pos2 = torch.einsum("pij,pj->pi", A[owner], ring_pos) + b[owner]
    moved = moved_kf[owner] & st.pt_valid[:PT]
    return torch.where(moved[:, None], pos2, ring_pos)


def _rebase_track(st: rt.RTState, Rn, tn, K: int):
    """The live pose kept rigid with the newest live keyframe:
    T_track' = T_track o T_old(newest)^-1 o T_new(newest)."""
    row_last = (st.n_kf - 1) % K
    Ro_n, to_n = _take(st.kf_R, row_last), _take(st.kf_t, row_last)
    M_R = Ro_n.T @ _take(Rn, row_last)
    M_t = Ro_n.T @ (_take(tn, row_last) - to_n)
    dev = Rn.device
    return st.track._replace(
        R=so3_mod.orthonormalize(st.track.R @ M_R),
        t=st.track.R @ M_t + st.track.t,
        vR=torch.eye(3, dtype=torch.float32, device=dev),
        vt=torch.zeros(3, dtype=torch.float32, device=dev),
        has_vel=_const(False, torch.bool, dev))


def _seed_rows(arr, v, lim):
    """``arr`` with its seed rows (past the ring) replaced by ``v`` padded
    with zeros to ``seed_slots`` rows."""
    PT = lim.max_kf * lim.spawn_per_kf
    pad = torch.zeros((lim.seed_slots - v.shape[0],) + tuple(v.shape[1:]),
                      dtype=arr.dtype, device=arr.device)
    return torch.cat([arr[:PT], v.to(arr.dtype), pad])


# --------------------------------------------------------------------- #
# the dispatch
# --------------------------------------------------------------------- #


def backlog(n_kf: int, bow_next: int):
    """The logical keyframes a dispatch processes: [lo, hi)."""
    return max(bow_next, n_kf - MAX_BACKLOG), n_kf


def maintenance_step(st: rt.RTState, ms: MaintState, lo: int, hi: int,
                     dv: voc_mod.DeviceVocabulary, cfg: SystemConfig,
                     lim: rt.RTLimits, *,
                     generator: Optional[torch.Generator] = None,
                     sampler: Optional[Sampler] = None):
    """One maintenance dispatch over the pending keyframes ``lo..hi-1``
    (``backlog``). Returns (st, ms)."""
    K = lim.max_kf
    n_words = ms.kf_bow.shape[1]
    KW, LB, B = lim.bank_words, lim.bank_landmarks, lim.bank_cap
    dev = ms.kf_bow.device
    neg1 = _const(-1, torch.int64, dev)

    for lid in range(lo, hi):
        row = lid % K
        kp_ok = st.kf_kp_valid[row]
        words = _words(st.kf_desc[row], kp_ok, dv)
        bow, has_words = _bow_vector(words, kp_ok, dv.word_weight, n_words)
        _, ph, ok = _kf_landmarks(st, row, lim)

        # Detection against the pre-update database (self not included).
        scores = _l1_scores(bow, ms.kf_bow)
        db_ok = (ms.bow_lid >= 0) & (ms.bow_lid == st.kf_lid)
        elig = db_ok & (ms.bow_lid <= lid - MIN_KF_GAP)
        sc = torch.where(elig, scores, -1.0)
        best = torch.argmax(sc)
        best_sc = _take(sc, best)
        best_lid = _take(ms.bow_lid, best)
        # min-score: the weakest similarity among recent temporal
        # neighbours (the realtime stand-in for covisible neighbours).
        nbr = db_ok & (ms.bow_lid >= lid - 8) & (ms.bow_lid <= lid - 1)
        min_sc = torch.amin(torch.where(nbr, scores, 1.0))
        hit_ring = (best_sc > 0.0) & nbr.any() & has_words \
            & (best_sc >= min_sc * cfg.loop.min_score_factor)

        # Bank detection: places the ring evicted, against bank-side
        # neighbour scores of the same truncation.
        bsc_all = _sparse_scores(bow, ms.bank_bow_w, ms.bank_bow_i)
        evicted = st.kf_lid[torch.clamp(ms.bank_lid, min=0) % K] != ms.bank_lid
        b_elig = (ms.bank_lid >= 0) & evicted \
            & (ms.bank_lid <= lid - MIN_KF_GAP)
        bsc = torch.where(b_elig, bsc_all, -1.0)
        bbest = torch.argmax(bsc)
        bbest_sc = _take(bsc, bbest)
        bbest_lid = _take(ms.bank_lid, bbest)
        b_nbr = (ms.bank_lid >= 0) & (ms.bank_lid >= lid - 8) \
            & (ms.bank_lid <= lid - 1)
        b_min = torch.amin(torch.where(b_nbr, bsc_all, 1.0))
        hit_bank = (bbest_sc > 0.0) & b_nbr.any() & has_words \
            & (bbest_sc >= b_min * cfg.loop.min_score_factor) & ~hit_ring

        hit = hit_ring | hit_bank
        cand = torch.where(hit_ring, best_lid, bbest_lid)
        near_prev = torch.abs(cand - ms.cand_lid) <= 3
        one = torch.ones_like(ms.streak)
        streak = torch.where(hit & near_prev, ms.streak + 1,
                             torch.where(hit, one, 0 * one))
        confirmed = hit \
            & (streak >= cfg.loop.covisibility_consistency_threshold) \
            & (lid - ms.last_loop_lid >= COOLDOWN_KFS)

        # Bank insertion: the top-k over the keypoint word list (duplicate
        # words aggregated by an [N, N] equality product), stable on ties
        # like the reference's top_k.
        w_ok = kp_ok & (words >= 0)
        wkp = torch.where(w_ok, dv.word_weight[torch.clamp(words, min=0)], 0.0)
        eq = (words[None, :] == words[:, None]) & w_ok[None, :]
        agg = eq.to(torch.float32) @ wkp                # [N] per occurrence
        first = (torch.argmax(eq.to(torch.uint8), dim=1)
                 == torch.arange(words.shape[0], device=dev)) & w_ok
        total = torch.clamp(wkp.sum(), min=1e-9)
        cand_w = torch.where(first, agg / total, 0.0)
        topw, top_kp = torch.sort(cand_w, descending=True, stable=True)
        topw, top_kp = topw[:KW], top_kp[:KW]
        topi = torch.where(topw > 0, words[top_kp], -1)
        lsrc, lok = _compact(ok, LB)
        lph = ph[lsrc]
        brow = ms.bank_next % B

        def bank_row(arr, new):
            return _put(arr, brow, torch.where(has_words, new.to(arr.dtype),
                                               _take(arr, brow)))

        ms = ms._replace(
            kf_bow=_put(ms.kf_bow, row, bow),
            bow_lid=_put(ms.bow_lid, row, _const(lid, torch.int64, dev)),
            bow_next=_const(lid + 1, torch.int64, dev),
            cand_lid=torch.where(hit, cand, neg1),
            streak=streak,
            bank_lid=_put(ms.bank_lid, brow,
                          torch.where(has_words, _const(lid, torch.int64, dev),
                                      _take(ms.bank_lid, brow))),
            bank_next=ms.bank_next + has_words.to(torch.int64),
            bank_bow_w=bank_row(ms.bank_bow_w, topw),
            bank_bow_i=bank_row(ms.bank_bow_i, topi),
            bank_R=bank_row(ms.bank_R, st.kf_R[row]),
            bank_t=bank_row(ms.bank_t, st.kf_t[row]),
            bank_pos=bank_row(ms.bank_pos, st.pt_pos[lph]),
            bank_desc=bank_row(ms.bank_desc, st.pt_desc[lph]),
            bank_angle=bank_row(ms.bank_angle, st.pt_angle[lph]),
            bank_normal=bank_row(ms.bank_normal, st.pt_normal[lph]),
            bank_mind=bank_row(ms.bank_mind, st.pt_mind[lph]),
            bank_maxd=bank_row(ms.bank_maxd, st.pt_maxd[lph]),
            bank_ok=bank_row(ms.bank_ok, lok & ok[lsrc]))

        # The host branch: one read per processed keyframe.
        ring, bank = torch.stack([confirmed & hit_ring,
                                  confirmed & hit_bank]).tolist()
        if ring:
            st, ms = _close_loop(st, ms, lid, best, best_sc, cfg, lim,
                                 _draw_fn(sampler, generator, ("loop", lid)))
        if bank:
            st, ms = _close_loop_bank(st, ms, lid, bbest, bbest_sc, cfg, lim,
                                      _draw_fn(sampler, generator,
                                               ("bank", lid)))

    # ---- relocalization when tracking is lost (one read per dispatch)
    need = (~st.track.ok) & (st.n_lost >= RELOC_AFTER_LOST) & (st.n_kf > 0)
    if bool(need):
        st, ms = _relocalize(st, ms, dv, cfg, lim, generator, sampler)
    return st, ms


def _draw_fn(sampler, gen, tag):
    return lambda valid: _draw(sampler, gen, tag, valid)


def _relocalize(st: rt.RTState, ms: MaintState, dv, cfg: SystemConfig,
                lim: rt.RTLimits, gen, sampler):
    """Ring candidate first; the best evicted bank place only if the ring
    solve fails (applied under a device-side condition)."""
    K = lim.max_kf
    cam = cfg.camera
    dev = st.kf_R.device
    n_words = ms.kf_bow.shape[1]
    words = _words(st.fr_desc, st.fr_valid, dv)
    bow, has_words = _bow_vector(words, st.fr_valid, dv.word_weight, n_words)
    db_ok = (ms.bow_lid >= 0) & (ms.bow_lid == st.kf_lid)
    sc = torch.where(db_ok & has_words, _l1_scores(bow, ms.kf_bow), -1.0)
    best = torch.argmax(sc)

    bsc_all = _sparse_scores(bow, ms.bank_bow_w, ms.bank_bow_i)
    evicted = st.kf_lid[torch.clamp(ms.bank_lid, min=0) % K] != ms.bank_lid
    b_elig = (ms.bank_lid >= 0) & evicted & has_words
    bsc = torch.where(b_elig, bsc_all, -1.0)
    bbest = torch.argmax(bsc)

    has_d = st.fr_depth > 0
    dst_c = _cam_points(cam, st.fr_uv, st.fr_depth)
    sd_f = brief.to_signed(brief.unpack_bits(st.fr_desc))

    def solve_against(desc_u8, src_ok, src_pos, tag):
        sd_b = brief.to_signed(brief.unpack_bits(desc_u8))
        ham = matching_ops.hamming_matrix(sd_f, sd_b)
        ham = torch.where(st.fr_valid[:, None] & src_ok[None, :], ham,
                          torch.full_like(ham, 1e9))
        j = torch.argmin(ham, dim=1)
        dmin = torch.amin(ham, dim=1)
        pair = st.fr_valid & (dmin <= cfg.matcher.th_high)
        valid = pair & has_d
        res = procrustes.ransac_alignment(
            src_pos[j], dst_c, valid, idx=_draw(sampler, gen, tag, valid),
            threshold=RELOC_INLIER_M, with_scale=False,
            final_threshold=RELOC_FINAL_M)
        ok = (res.n_inliers >= RELOC_MIN_INLIERS) \
            & torch.isfinite(res.R).all() & torch.isfinite(res.t).all()
        return res, j, ok

    def repair_track(st, res, applied, pids_new):
        R_cw = so3_mod.orthonormalize(res.R)
        return st.track._replace(
            R=torch.where(applied, R_cw, st.track.R),
            t=torch.where(applied, res.t, st.track.t),
            vR=torch.eye(3, dtype=torch.float32, device=dev),
            vt=torch.zeros(3, dtype=torch.float32, device=dev),
            has_vel=_const(False, torch.bool, dev),
            ok=st.track.ok | applied,
            pids=torch.where(applied, pids_new, st.track.pids))

    zero = torch.zeros_like(st.n_lost)
    ttl = _const(REUSE_TTL, torch.int64, dev)

    # Ring candidate.
    pids_b, ph_b, ok_b = _kf_landmarks(st, best, lim)
    res, j, applied = solve_against(st.pt_desc[ph_b], ok_b, st.pt_pos[ph_b],
                                    ("reloc_ring",))
    pids_new = torch.where(res.inliers, pids_b[j], -1)
    st = st._replace(
        track=repair_track(st, res, applied, pids_new),
        n_lost=torch.where(applied, zero, st.n_lost),
        # Re-expose the candidate's chunks so the next frames match
        # against the place we believe we are at.
        reuse_lid=torch.where(applied, _take(ms.bow_lid, best),
                              st.reuse_lid),
        reuse_ttl=torch.where(applied, ttl, st.reuse_ttl))
    ms = ms._replace(n_reloc=ms.n_reloc + applied.to(torch.int64))
    ring_applied = applied

    # Bank place: matched landmarks live only in the bank, so the subset is
    # staged into the seed arena and the track gets seed pids.
    bank_desc, bank_ok = _take(ms.bank_desc, bbest), _take(ms.bank_ok, bbest)
    bank_pos = _take(ms.bank_pos, bbest)
    res, j, ok_bank = solve_against(bank_desc, bank_ok, bank_pos,
                                    ("reloc_bank",))
    applied = ok_bank & ~ring_applied & b_elig.any()
    pids_new = torch.where(res.inliers, rt.SEED_BASE + j, -1)
    sv = torch.cat([bank_ok & applied,
                    torch.zeros(lim.seed_slots - lim.bank_landmarks,
                                dtype=torch.bool, device=dev)])

    def gated(arr, v):
        return torch.where(applied, _seed_rows(arr, v, lim), arr)

    PT = K * lim.spawn_per_kf
    st = st._replace(
        track=repair_track(st, res, applied, pids_new),
        n_lost=torch.where(applied, zero, st.n_lost),
        pt_pos=gated(st.pt_pos, bank_pos),
        pt_desc=gated(st.pt_desc, bank_desc),
        pt_angle=gated(st.pt_angle, _take(ms.bank_angle, bbest)),
        pt_normal=gated(st.pt_normal, _take(ms.bank_normal, bbest)),
        pt_mind=gated(st.pt_mind, _take(ms.bank_mind, bbest)),
        pt_maxd=gated(st.pt_maxd, _take(ms.bank_maxd, bbest)),
        pt_valid=torch.where(applied, torch.cat([st.pt_valid[:PT], sv]),
                             st.pt_valid),
        seed_ttl=torch.where(applied, ttl, st.seed_ttl))
    ms = ms._replace(
        n_reloc=ms.n_reloc + applied.to(torch.int64),
        n_bank_reloc=ms.n_bank_reloc + applied.to(torch.int64))
    return st, ms


def _remap_trajectory(traj, kf_lid, Ro, to, Rn, tn, moved, K: int):
    """Re-map written trajectory rows through their owner keyframe's
    correction (pose' = pose o To^-1 o Tn): a closure repairs the past
    trajectory too. Rows owned by evicted keyframes (or written before any)
    stay put."""
    own = traj[:, 13].to(torch.int64)
    own_row = torch.clamp(own, min=0) % K
    ok = (own >= 0) & (kf_lid[own_row] == own) & moved[own_row]
    M_R = torch.einsum("kji,kjl->kil", Ro, Rn)        # Ro^T Rn
    M_t = torch.einsum("kji,kj->ki", Ro, tn - to)     # Ro^T (tn - to)
    R_f = traj[:, 1:10].reshape(-1, 3, 3)
    t_f = traj[:, 10:13]
    R2 = torch.einsum("fij,fjk->fik", R_f, M_R[own_row])
    t2 = torch.einsum("fij,fj->fi", R_f, M_t[own_row]) + t_f
    R2 = torch.where(ok[:, None, None], R2, R_f)
    t2 = torch.where(ok[:, None], t2, t_f)
    return torch.cat([traj[:, :1], R2.reshape(-1, 9), t2, traj[:, 13:]],
                     dim=1)


def _close_loop(st: rt.RTState, ms: MaintState, lid: int, cand_row, score,
                cfg: SystemConfig, lim: rt.RTLimits, draw):
    """Stages 3+4 against a ring candidate: solve the closure and, when it
    is accepted (one host read), propagate the correction."""
    K, S = lim.max_kf, lim.spawn_per_kf
    cam = cfg.camera
    dev = st.kf_R.device
    row_new = lid % K
    cand_lid = _take(st.kf_lid, cand_row)

    # ---- stage 3: landmark matching + 3D-3D RANSAC
    pids_n, ph_n, ok_n = _kf_landmarks(st, row_new, lim)
    pids_c, ph_c, ok_c = _kf_landmarks(st, cand_row, lim)
    sd_n = brief.to_signed(brief.unpack_bits(st.pt_desc[ph_n]))
    sd_c = brief.to_signed(brief.unpack_bits(st.pt_desc[ph_c]))
    j, pair = _mutual_pairs(sd_n, ok_n, sd_c, ok_c, cfg.matcher.th_low)
    src, has_d = _new_kf_points(cam, st.kf_obs[row_new])
    dst = st.pt_pos[ph_c[j]]           # candidate-era world positions
    valid = pair & has_d
    res = procrustes.ransac_alignment(
        src, dst, valid, idx=draw(valid), threshold=ALIGN_INLIER_M,
        with_scale=False, final_threshold=ALIGN_FINAL_M)
    # Accept on tight (annealed) inliers, or on an overwhelming wide
    # consensus (a rank-deficient set can give a non-finite solve: never).
    accepted = _accept(res, cfg)
    ms = _log_event(ms, lid, cand_lid, score, pair, res, accepted)
    if not bool(accepted):
        return st, ms

    # Corrected world->cam pose of the new keyframe: RANSAC solved
    # cam->old-world (dst = R src + t), so T_cw = (R^T, -R^T t).
    R_corr = so3_mod.orthonormalize(res.R.T)
    t_corr = -R_corr @ res.t

    # ---- stage 4: sequential-chain + loop-edge pose graph
    lids = st.kf_lid
    valid_nodes = lids >= 0
    R0 = _put(st.kf_R, row_new, R_corr)
    t0 = _put(st.kf_t, row_new, t_corr)
    fixed = (lids <= cand_lid) | ~valid_nodes
    ei, ej, R_m, t_m, e_ok = _chain_edges(st, K)
    # Loop edge: corrected newest vs candidate.
    R_cl = R_corr @ _take(st.kf_R, cand_row).T
    t_cl = t_corr - R_cl @ _take(st.kf_t, cand_row)
    prob = pg.PoseGraphProblem(
        s=torch.ones(K, device=dev), R=R0, t=t0, fixed=fixed,
        valid=valid_nodes,
        edge_i=torch.cat([ei, torch.full((1,), row_new, device=dev)]),
        edge_j=torch.cat([ej, cand_row.reshape(1)]),
        edge_s=torch.ones(K, device=dev),
        edge_R=torch.cat([R_m, R_cl[None]]),
        edge_t=torch.cat([t_m, t_cl[None]]),
        edge_valid=torch.cat([e_ok, torch.ones(1, dtype=torch.bool,
                                               device=dev)]),
        edge_weight=torch.cat([torch.ones(K - 1, device=dev),
                               torch.full((1,), LOOP_EDGE_WEIGHT,
                                          device=dev)]))
    sol = pg.optimize_pose_graph(prob, cfg.optimizer, fix_scale=True)

    # Per-node finite guard: a degenerate system must not write NaN.
    node_ok = torch.isfinite(sol.R).flatten(1).all(1) \
        & torch.isfinite(sol.t).all(1)
    changed = (~fixed) & valid_nodes & node_ok
    Rn = torch.where(changed[:, None, None], sol.R, st.kf_R)
    tn = torch.where(changed[:, None], sol.t, st.kf_t)

    PT = K * S
    pt_pos = torch.cat([_remap_points(st, Rn, tn, changed, lim),
                        st.pt_pos[PT:]])
    track = _rebase_track(st, Rn, tn, K)
    traj2 = _remap_trajectory(st.traj, st.kf_lid, st.kf_R, st.kf_t, Rn, tn,
                              changed, K)
    st = st._replace(kf_R=Rn, kf_t=tn, pt_pos=pt_pos, track=track,
                     traj=traj2, reuse_lid=cand_lid,
                     reuse_ttl=_const(REUSE_TTL, torch.int64, dev))

    # ---- SearchAndFuse: the new keyframe's fresh spawns whose match hit a
    # candidate-era landmark are duplicates of it; drop the fresh copy and
    # point the keyframe row (and the live track) at the old landmark.
    fuse = pair & res.inliers & (pids_n >= 0) & (pids_n // S == lid)
    slot_oh = ((torch.clamp(pids_n, min=0) % S)[None, :]
               == torch.arange(S, device=dev)[:, None]) & fuse[None, :]
    dup = slot_oh.any(dim=1)                         # [S] chunk slots
    n_of = torch.argmax(slot_oh.to(torch.uint8), dim=1)
    partner = torch.where(dup, pids_c[j[n_of]], -1)  # old pid per slot
    base = row_new * S
    pt_valid2 = st.pt_valid.clone()
    pt_valid2[base:base + S] = st.pt_valid[base:base + S] & ~dup
    row_pid = torch.where(fuse, pids_c[j], pids_n)
    kf_pid2 = _put(st.kf_pid, row_new, row_pid)
    tp = st.track.pids
    tp_new = (tp >= 0) & (tp // S == lid)
    tp_part = partner[torch.clamp(tp, min=0) % S]
    tp2 = torch.where(tp_new & (tp_part >= 0), tp_part, tp)
    st = st._replace(pt_valid=pt_valid2, kf_pid=kf_pid2,
                     track=st.track._replace(pids=tp2))

    # ---- junction BA over the corrected chain; the live pose stays rigid
    # with the newest keyframe through it.
    pre = st.track
    row_last = (st.n_kf - 1) % K
    Ro2, to2 = _take(st.kf_R, row_last), _take(st.kf_t, row_last)
    st = rt._windowed_ba(st, cfg, lim)
    B_R = Ro2.T @ _take(st.kf_R, row_last)
    B_t = Ro2.T @ (_take(st.kf_t, row_last) - to2)
    st = st._replace(track=st.track._replace(
        R=so3_mod.orthonormalize(pre.R @ B_R), t=pre.R @ B_t + pre.t))

    ms = ms._replace(n_loops=ms.n_loops + 1,
                     last_loop_lid=_const(lid, torch.int64, dev),
                     streak=torch.zeros_like(ms.streak),
                     cand_lid=torch.full_like(ms.cand_lid, -1))
    return st, ms


def _close_loop_bank(st: rt.RTState, ms: MaintState, lid: int, bidx, score,
                     cfg: SystemConfig, lim: rt.RTLimits, draw):
    """Stages 3+4 against a bank place the ring evicted: match and
    RANSAC-align its landmark subset like a ring candidate; an accepted
    correction anchors the newest keyframe at the solved pose, relaxes the
    live chain to it, and stages the subset into the seed arena."""
    K, S = lim.max_kf, lim.spawn_per_kf
    LB = lim.bank_landmarks
    assert LB <= lim.seed_slots, "seed arena smaller than a bank subset"
    cam = cfg.camera
    dev = st.kf_R.device
    row_new = lid % K
    cand_lid = _take(ms.bank_lid, bidx)

    # ---- stage 3: landmark matching + 3D-3D RANSAC vs the bank subset
    _, ph_n, ok_n = _kf_landmarks(st, row_new, lim)
    sd_n = brief.to_signed(brief.unpack_bits(st.pt_desc[ph_n]))
    bank_desc, bank_ok = _take(ms.bank_desc, bidx), _take(ms.bank_ok, bidx)
    bank_pos = _take(ms.bank_pos, bidx)
    sd_c = brief.to_signed(brief.unpack_bits(bank_desc))
    j, pair = _mutual_pairs(sd_n, ok_n, sd_c, bank_ok, cfg.matcher.th_low)
    src, has_d = _new_kf_points(cam, st.kf_obs[row_new])
    dst = bank_pos[j]                        # bank-era world positions
    valid = pair & has_d
    res = procrustes.ransac_alignment(
        src, dst, valid, idx=draw(valid), threshold=ALIGN_INLIER_M,
        with_scale=False, final_threshold=ALIGN_FINAL_M)
    accepted = _accept(res, cfg)
    ms = _log_event(ms, lid, cand_lid, score, pair, res, accepted)
    if not bool(accepted):
        return st, ms

    R_corr = so3_mod.orthonormalize(res.R.T)
    t_corr = -R_corr @ res.t

    # ---- stage 4: chain pose graph anchored at the corrected newest node
    # (the bank place has no live node).
    lids = st.kf_lid
    valid_nodes = lids >= 0
    R0 = _put(st.kf_R, row_new, R_corr)
    t0 = _put(st.kf_t, row_new, t_corr)
    is_new = torch.arange(K, device=dev) == row_new
    fixed = is_new | ~valid_nodes
    ei, ej, R_m, t_m, e_ok = _chain_edges(st, K)
    prob = pg.PoseGraphProblem(
        s=torch.ones(K, device=dev), R=R0, t=t0, fixed=fixed,
        valid=valid_nodes, edge_i=ei, edge_j=ej,
        edge_s=torch.ones(K - 1, device=dev), edge_R=R_m, edge_t=t_m,
        edge_valid=e_ok, edge_weight=torch.ones(K - 1, device=dev))
    sol = pg.optimize_pose_graph(prob, cfg.optimizer, fix_scale=True)

    node_ok = torch.isfinite(sol.R).flatten(1).all(1) \
        & torch.isfinite(sol.t).all(1)
    changed = (~fixed) & valid_nodes & node_ok
    Rn = torch.where(changed[:, None, None], sol.R, R0)
    tn = torch.where(changed[:, None], sol.t, t0)

    # Point remap: the newest node moved too (anchored at the solve).
    remap = (changed | is_new) & valid_nodes
    PT = K * S
    ring_new = _remap_points(st, Rn, tn, remap, lim)

    # ---- stage the bank subset into the seed arena (rows PT..)
    sv = torch.cat([bank_ok, torch.zeros(lim.seed_slots - LB,
                                         dtype=torch.bool, device=dev)])
    pt_pos = _seed_rows(torch.cat([ring_new, st.pt_pos[PT:]]), bank_pos, lim)
    track = _rebase_track(st, Rn, tn, K)
    traj2 = _remap_trajectory(st.traj, st.kf_lid, st.kf_R, st.kf_t, Rn, tn,
                              remap, K)
    st = st._replace(
        kf_R=Rn, kf_t=tn, pt_pos=pt_pos,
        pt_desc=_seed_rows(st.pt_desc, bank_desc, lim),
        pt_angle=_seed_rows(st.pt_angle, _take(ms.bank_angle, bidx), lim),
        pt_normal=_seed_rows(st.pt_normal, _take(ms.bank_normal, bidx), lim),
        pt_mind=_seed_rows(st.pt_mind, _take(ms.bank_mind, bidx), lim),
        pt_maxd=_seed_rows(st.pt_maxd, _take(ms.bank_maxd, bidx), lim),
        pt_valid=torch.cat([st.pt_valid[:PT], sv]), track=track, traj=traj2,
        seed_ttl=_const(REUSE_TTL, torch.int64, dev))
    ms = ms._replace(n_loops=ms.n_loops + 1,
                     n_bank_loops=ms.n_bank_loops + 1,
                     last_loop_lid=_const(lid, torch.int64, dev),
                     streak=torch.zeros_like(ms.streak),
                     cand_lid=torch.full_like(ms.cand_lid, -1))
    return st, ms


class Maintainer:
    """Host side of the maintenance program: owns the vocabulary's tensors
    on the device and the dispatch's random generator.

    ``device`` defaults to CUDA and there is no CPU fallback: it raises
    when CUDA is absent unless the caller asks for the CPU.
    """

    def __init__(self, cfg: SystemConfig, lim: rt.RTLimits,
                 voc: voc_mod.Vocabulary, device=None):
        self.device = resolve_device(device, "Maintainer")
        self.cfg, self.lim, self.voc = cfg, lim, voc
        self._n_words = int(voc.n_words)
        self._dev = voc_mod.to_device(voc, self.device)
        self._gen = torch.Generator(device=self.device)

    def init_state(self) -> MaintState:
        K = self.lim.max_kf
        B, KW, LB = (self.lim.bank_cap, self.lim.bank_words,
                     self.lim.bank_landmarks)
        i64, f32 = torch.int64, torch.float32
        dev = self.device

        def full(shape, v, dt):
            return torch.full(shape, v, dtype=dt, device=dev)

        return MaintState(
            kf_bow=full((K, self._n_words), 0.0, f32),
            bow_lid=full((K,), -1, i64), bow_next=full((), 0, i64),
            cand_lid=full((), -1, i64), streak=full((), 0, i64),
            last_loop_lid=full((), -10 ** 6, i64),
            loop_log=full((LOG_ROWS, 6), 0.0, f32),
            n_events=full((), 0, i64), n_loops=full((), 0, i64),
            n_reloc=full((), 0, i64),
            bank_lid=full((B,), -1, i64), bank_next=full((), 0, i64),
            bank_bow_w=full((B, KW), 0.0, f32),
            bank_bow_i=full((B, KW), -1, i64),
            bank_R=torch.eye(3, dtype=f32, device=dev).expand(B, 3, 3).clone(),
            bank_t=full((B, 3), 0.0, f32),
            bank_pos=full((B, LB, 3), 0.0, f32),
            bank_desc=full((B, LB, 32), 0, torch.uint8),
            bank_angle=full((B, LB), 0.0, f32),
            bank_normal=full((B, LB, 3), 0.0, f32),
            bank_mind=full((B, LB), 1e-2, f32),
            bank_maxd=full((B, LB), 1e3, f32),
            bank_ok=full((B, LB), False, torch.bool),
            n_bank_loops=full((), 0, i64), n_bank_reloc=full((), 0, i64))

    def step(self, st: rt.RTState, ms: MaintState, seed: int, *,
             n_kf: int, bow_next: int, sampler: Optional[Sampler] = None):
        """One dispatch. ``n_kf`` and ``bow_next`` are the host's counts of
        keyframes made and processed; ``seed`` seeds the RANSAC draws.
        Returns (st, ms)."""
        lo, hi = backlog(n_kf, bow_next)
        self._gen.manual_seed(int(seed))
        return maintenance_step(st, ms, lo, hi, self._dev, self.cfg,
                                self.lim, generator=self._gen,
                                sampler=sampler)

    def report(self, ms: MaintState) -> dict:
        """Session-end readback of the maintenance outcome. ``loop_events``
        is chronological (oldest surviving first): once more than LOG_ROWS
        events occurred, only the newest LOG_ROWS survive."""
        n_ev = int(ms.n_events)
        log = ms.loop_log.detach().cpu().numpy()
        if n_ev <= LOG_ROWS:
            log = log[:n_ev]
        else:
            log = np.roll(log, -(n_ev % LOG_ROWS), axis=0)
        return {
            "loop_events": [
                {"lid": int(r[0]), "cand_lid": int(r[1]),
                 "score": float(r[2]), "n_pairs": int(r[3]),
                 "n_inliers": int(r[4]), "applied": bool(r[5] > 0.5)}
                for r in log],
            "n_loop_events": n_ev,
            "n_loops_closed": int(ms.n_loops),
            "n_relocalizations": int(ms.n_reloc),
            "n_bank_loops": int(ms.n_bank_loops),
            "n_bank_reloc": int(ms.n_bank_reloc),
            "bank_entries": int((ms.bank_lid >= 0).sum()),
        }
