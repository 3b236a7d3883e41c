"""Map checkpoint and resume.

Counterpart of ``coebslam_tpu/io/checkpoint.py``: the whole host map — the
keyframe and point arrays, observations, covisibility, spanning tree and
the culled keyframes' re-anchoring chains — with the tracker's pose and
budget and, optionally, the keyframe database, in one compressed ``.npz``
under the same keys, so a map saved by either package loads into the
other. ``resume`` puts a saved map and pose into a fresh ``System``,
which then either goes on mapping or tracks against the map in
localization mode. All numpy: nothing here touches a device.
"""
from __future__ import annotations

import numpy as np

from ..config import SystemConfig
from ..slam.map import MapArena
from ..slam.vocabulary import Vocabulary

_ARENA_FIELDS = [
    "kf_R", "kf_t", "kf_stamp", "kf_valid", "kf_uv", "kf_level", "kf_angle",
    "kf_desc", "kf_depth", "kf_ur", "kf_kp_valid", "kf_obs_pt", "covis",
    "kf_parent", "kf_seq", "pt_pos", "pt_valid", "pt_desc", "pt_normal",
    "pt_min_dist", "pt_max_dist", "pt_angle", "pt_found", "pt_visible",
    "pt_first_kf", "pt_first_seq", "pt_obs_kf", "pt_obs_slot", "pt_redirect",
]
_DB_FIELDS = (("db_words", "kf_words"), ("db_bow_words", "kf_bow_words"),
              ("db_bow_vals", "kf_bow_vals"), ("db_registered", "registered"))


def save_map(path: str, arena: MapArena, tracker_state=None,
             kf_db=None) -> None:
    """Write the arena (and the tracker's pose and budget, and the
    keyframe database, when given) to ``path``."""
    data = {f: getattr(arena, f) for f in _ARENA_FIELDS}
    data["n_kf"] = np.asarray(arena.n_kf)
    data["n_pt"] = np.asarray(arena.n_pt)
    data["free_pt"] = np.asarray(arena._free_pt, np.int64)
    data["free_kf"] = np.asarray(arena._free_kf, np.int64)
    data["kf_seq_counter"] = np.asarray(arena.kf_seq_counter)
    cull = sorted(arena.kf_cull_rel.items())
    data["cull_ids"] = np.asarray([k for k, _ in cull], np.int64)
    data["cull_parent"] = np.asarray([v[0] for _, v in cull], np.int64)
    data["cull_R"] = (np.stack([v[1] for _, v in cull])
                      if cull else np.zeros((0, 3, 3), np.float32))
    data["cull_t"] = (np.stack([v[2] for _, v in cull])
                      if cull else np.zeros((0, 3), np.float32))
    if tracker_state is not None:
        data["tk_pose_R"] = tracker_state.pose_R
        data["tk_pose_t"] = tracker_state.pose_t
        data["tk_budget"] = np.asarray(tracker_state.budget)
    if kf_db is not None:
        for key, attr in _DB_FIELDS:
            data[key] = getattr(kf_db, attr)
    np.savez_compressed(path, **data)


def load_map(path: str, cfg: SystemConfig, kf_db=None) -> MapArena:
    """A new MapArena from ``path`` (and ``kf_db`` restored in place when
    given and saved). The arrays' shapes must match ``cfg``'s."""
    z = np.load(path)
    arena = MapArena(cfg)
    for f in _ARENA_FIELDS:
        src = z[f]
        dst = getattr(arena, f)
        if src.shape != dst.shape:
            raise ValueError(
                f"checkpoint field {f} has shape {src.shape}, the config "
                f"expects {dst.shape}: adjust MapConfig/OrbConfig to match")
        setattr(arena, f, src.copy())
    arena.n_kf = int(z["n_kf"])
    arena.n_pt = int(z["n_pt"])
    arena._free_pt = [int(i) for i in z["free_pt"]]
    if "free_kf" in z:
        arena._free_kf = [int(i) for i in z["free_kf"]]
        arena.kf_seq_counter = int(z["kf_seq_counter"])
        arena.kf_cull_rel = {
            int(k): (int(p), R.copy(), t.copy())
            for k, p, R, t in zip(z["cull_ids"], z["cull_parent"],
                                  z["cull_R"], z["cull_t"])}
    if kf_db is not None and "db_words" in z:
        for key, attr in _DB_FIELDS:
            setattr(kf_db, attr, z[key].copy())
    return arena


def restore_tracker_pose(path: str, tracker) -> bool:
    """Set the tracker's pose and budget from ``path``; False when the
    checkpoint holds no tracker state. The device state is rebuilt from
    them on the next frame."""
    z = np.load(path)
    if "tk_pose_R" not in z:
        return False
    tracker.state.pose_R = z["tk_pose_R"].copy()
    tracker.state.pose_t = z["tk_pose_t"].copy()
    tracker.state.budget = int(z["tk_budget"])
    tracker._dev_state = None
    return True


def resume(path: str, system, localization: bool = True) -> bool:
    """Resume a fresh ``System`` from ``path``: the map goes to every part
    that holds it (with the removal callbacks the system registered), the
    keyframe database is restored when the system has one and the file
    holds it, and the tracker takes the saved pose and budget, the newest
    keyframe as its reference and last frame, and the OK state, so the
    next frame is tracked against the map rather than initialised. With
    ``localization`` the map stays frozen. False, with the system left
    as it was, when the checkpoint holds no tracker state."""
    from ..slam.tracking import OK, FrameRecord
    if "tk_pose_R" not in np.load(path):
        return False
    arena = load_map(path, system.cfg, kf_db=system.kf_db)
    arena.on_keyframe_removed.extend(system.map.on_keyframe_removed)
    for part in (system, system.tracker, system.mapper, system.kf_db,
                 system.relocalizer, system.loop_closer):
        if part is not None:
            part.map = arena
    tracker = system.tracker
    restore_tracker_pose(path, tracker)
    ref = int(arena.valid_keyframes()[-1])
    tracker.ref_kf = ref
    tracker.state.last_kf = ref
    tracker.state.mode = OK
    tracker.last_frame = FrameRecord(
        uv=arena.kf_uv[ref], level=arena.kf_level[ref],
        angle=arena.kf_angle[ref], desc=arena.kf_desc[ref],
        depth=arena.kf_depth[ref], ur=arena.kf_ur[ref],
        valid=arena.kf_kp_valid[ref], point_ids=arena.kf_obs_pt[ref])
    if localization:
        system.activate_localization_mode()
    return True


def save_vocabulary(path: str, voc: Vocabulary) -> None:
    np.savez_compressed(path, node_desc=voc.node_desc, children=voc.children,
                        word_id=voc.word_id, word_weight=voc.word_weight,
                        node_level=voc.node_level,
                        depth=np.asarray(voc.depth),
                        branching=np.asarray(voc.branching))


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    return Vocabulary(z["node_desc"], z["children"], z["word_id"],
                      z["word_weight"], z["node_level"], int(z["depth"]),
                      int(z["branching"]))
