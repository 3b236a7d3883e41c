"""Structured per-frame metrics, stage timing, and the process-wide
recorder of spans and counters.

Counterpart of ``coebslam_tpu/utils/metrics.py`` (numpy only): per-frame
records, a summary, and a context-manager stage timer. The recorder has
no JAX counterpart (the reference names its stages with
``jax.named_scope``); it is off until ``tracing(True)``:

    from coebslam_tpu_torch.utils import metrics
    metrics.tracing(True)
    ...                          # run frames
    rec = metrics.drain()        # {"spans", "counters", "device_counters"}

Off, ``span`` and ``host_read`` return one shared no-op context manager
and the ``count*`` functions return at once: no clock read, no allocation,
no device operation. On, each span keeps its name, its path (the names of
the open spans of its thread, outermost first, joined by ``/``), the
request id (the frame index ``request`` set last), its start and end on
``time.time_ns()`` (the clock of the profiler's events) and the thread's
CPU time (``time.thread_time_ns()``) at both ends; a ``host_read`` span also
keeps how many device values its statement reads to the host. Host
counters add up per request. Device counters keep one float32 row per
call on the device, read to the host only by ``drain()``, all at once
(counts are exact below 2**24).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

_on = False
_request = -1
_spans: List[dict] = []
_counts: Dict[str, Dict[int, int]] = {}
_device: Dict[str, tuple] = {}       # name -> (fields, requests, rows)
_local = threading.local()


class _NoSpan:
    """What ``span`` and ``host_read`` return while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """A timed interval. ``keep``: record it (with its path and request)
    when it closes; else only ``wall_ns`` and ``cpu_ns`` are set. The CPU
    interval is read inside the wall interval, so ``cpu_ns <= wall_ns``."""
    __slots__ = ("name", "reads", "keep", "path", "t0", "cpu0", "wall_ns",
                 "cpu_ns")

    def __init__(self, name: str, reads: int = 0, keep: bool = True):
        self.name, self.reads, self.keep = name, reads, keep

    def __enter__(self):
        if self.keep:
            st = _stack()
            self.path = f"{st[-1].path}/{self.name}" if st else self.name
            st.append(self)
        self.t0 = time.time_ns()
        self.cpu0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        cpu1 = time.thread_time_ns()
        t1 = time.time_ns()
        self.wall_ns, self.cpu_ns = t1 - self.t0, cpu1 - self.cpu0
        if self.keep:
            st = _stack()
            st.pop()
            _spans.append({"name": self.name, "path": self.path,
                           "parent": st[-1].path if st else None,
                           "request": _request, "t0": self.t0, "t1": t1,
                           "cpu_ns": self.cpu_ns, "reads": self.reads})
        return False


def tracing(on: bool = True) -> None:
    """Turn the recorder on or off (process-wide)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def request(frame: int) -> None:
    """The request id of the spans and counters that follow."""
    global _request
    _request = frame


def span(name: str):
    """A span called ``name`` around a ``with`` block."""
    return Span(name) if _on else NO_SPAN


def host_read(site: str, n: int = 1):
    """A span around one statement that reads ``n`` device values to the
    host, named ``read:<site>``."""
    return Span(f"read:{site}", n) if _on else NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` of the current request."""
    if not _on:
        return
    per = _counts.setdefault(name, {})
    per[_request] = per.get(_request, 0) + int(n)


def count_device(name: str, values: dict) -> None:
    """Keep the 0-d tensors ``values`` ({field: tensor}) as one float32 row
    of the device counter ``name``, on their device, without a read."""
    if not _on:
        return
    import torch
    fields = tuple(values)
    ent = _device.setdefault(name, (fields, [], []))
    if ent[0] != fields:
        raise ValueError(f"device counter {name!r}: fields {fields} "
                         f"after {ent[0]}")
    ent[1].append(_request)
    ent[2].append(torch.stack([v.reshape(()).to(torch.float32)
                               for v in values.values()]))


def drain() -> dict:
    """Return and clear what was recorded: ``spans`` (dicts with name,
    path, parent, request, t0, t1, cpu_ns, reads, in closing order),
    ``counters`` ({name: {request: n}}) and ``device_counters`` ({name:
    {"request": [...], field: [...]}}, one entry per row)."""
    global _spans, _counts, _device
    spans, counts, dev = _spans, _counts, _device
    _spans, _counts, _device = [], {}, {}
    out = {}
    if dev:
        import torch
        flat = torch.cat([torch.stack(rows).reshape(-1)
                          for _, _, rows in dev.values()]).cpu().tolist()
        at = 0
        for name, (fields, reqs, rows) in dev.items():
            k = len(fields)
            vals = flat[at:at + k * len(rows)]
            at += k * len(rows)
            out[name] = {"request": reqs,
                         **{f: vals[j::k] for j, f in enumerate(fields)}}
    return {"spans": spans, "counters": counts, "device_counters": out}


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
        """Time a stage into this frame's ``stage_ms`` (and, with the
        recorder on, record it as a span)."""
        s = Span(name, keep=_on)
        try:
            with s:
                yield
        finally:
            self._stage_acc[name] = self._stage_acc.get(name, 0.0) \
                + s.wall_ns / 1e6

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
