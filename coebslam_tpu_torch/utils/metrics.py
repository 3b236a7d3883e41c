"""Structured per-frame metrics and stage timing.

Counterpart of ``coebslam_tpu/utils/metrics.py`` (numpy only): per-frame
records, a summary, and a context-manager stage timer.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class FrameMetrics:
    frame: int
    stamp: float
    state: str
    n_inliers: int
    n_keypoints: int = 0
    n_map_points: int = 0
    n_keyframes: int = 0
    budget: int = 0
    wall_ms: float = 0.0
    stage_ms: Dict[str, float] = field(default_factory=dict)


class MetricsCollector:
    def __init__(self):
        self.frames: List[FrameMetrics] = []
        self._stage_acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stage_acc[name] = self._stage_acc.get(name, 0.0) \
                + (time.perf_counter() - t0) * 1e3

    def record(self, **kw) -> FrameMetrics:
        fm = FrameMetrics(stage_ms=self._stage_acc, **kw)
        self._stage_acc = {}
        self.frames.append(fm)
        return fm

    # ------------------------------------------------------------------ #

    def summary(self) -> Dict:
        if not self.frames:
            return {}
        import numpy as np
        wall = np.asarray([f.wall_ms for f in self.frames])
        inl = np.asarray([f.n_inliers for f in self.frames])
        states = [f.state for f in self.frames]
        stages: Dict[str, List[float]] = defaultdict(list)
        for f in self.frames:
            for k, v in f.stage_ms.items():
                stages[k].append(v)
        return {
            "frames": len(self.frames),
            "fps_mean": float(1e3 / wall.mean()) if wall.mean() > 0 else 0.0,
            "wall_ms_mean": float(wall.mean()),
            "wall_ms_median": float(np.median(wall)),
            "inliers_mean": float(inl.mean()),
            "lost_frames": states.count("LOST"),
            "ok_ratio": states.count("OK") / len(states),
            "stage_ms_mean": {k: float(np.mean(v)) for k, v in stages.items()},
        }

    def print_summary(self) -> None:
        s = self.summary()
        if not s:
            print("no frames recorded")
            return
        print(f"frames={s['frames']} fps={s['fps_mean']:.1f} "
              f"median={s['wall_ms_median']:.1f}ms "
              f"inliers={s['inliers_mean']:.0f} lost={s['lost_frames']} "
              f"ok={100*s['ok_ratio']:.1f}%")
        for k, v in sorted(s["stage_ms_mean"].items()):
            print(f"  {k:24s} {v:7.2f} ms")
