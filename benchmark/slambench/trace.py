"""Spans around the port's functions, and the reduction of one session's
profiler trace to per-layer sums.

Spans are host intervals that the benchmark records from outside around
the port's functions (the method of the repository's
``profile_torch_realtime.py``, which uses ``record_function`` ranges; here
the wrapper keeps the interval itself, so the profiler records only the
device's activity and its runtime calls, not every host operator). A
device operation belongs to a span when the runtime call that launched it
(its correlation id) lies inside the span. Times are wall-clock
nanoseconds, the profiler's clock, which every process of the host
shares, so the sessions' traces line up on one clock.
"""
from __future__ import annotations

import functools
import time

import numpy as np

from . import stats


def wrap(owner, name, label, sink, spans=None, after=None):
    """Replace ``owner.name`` by a wrapper that times each call on the host
    clock into ``sink[label]`` (a list of milliseconds), keeps the call's
    (start, end) on the profiler's wall clock in ``spans[label]`` when
    ``spans`` is given, and calls ``after(args, kwargs, out)``."""
    fn = getattr(owner, name)
    times = sink.setdefault(label, [])
    iv = None if spans is None else spans.setdefault(label, [])

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        w0 = time.time_ns() if iv is not None else 0
        out = fn(*args, **kwargs)
        if iv is not None:
            iv.append((w0, time.time_ns()))
        times.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after(args, kwargs, out)
        return out

    setattr(owner, name, wrapped)


def reduce(events, spans, lo_ns: int, hi_ns: int) -> dict:
    """One session's trace reduced to: the disjoint intervals in which a
    device operation of the session ran (ns), the device operations by
    name (count, ns), and per span label (``spans``: label -> [(start,
    end)] on the same clock) its calls, host ns, the device ns and count
    of the operations launched inside it, and its intervals (for
    labelling idle gaps). Only what lies in [lo, hi]. A device operation
    is placed by its launch (the runtime call with its correlation id), or
    by its own start where the trace holds no launch."""
    from torch.autograd import DeviceType
    cpu = DeviceType.CPU
    launch = {}
    dev_start, dev_dur, dev_corr, names = [], [], [], []
    for e in events:
        if e.device_type() == cpu:
            if e.name().startswith("cuda"):
                launch[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            dev_start.append(e.start_ns())
            dev_dur.append(e.duration_ns())
            dev_corr.append(e.correlation_id())
            names.append(e.name())
    a = np.asarray(dev_start, np.float64)
    d_iv = np.stack([a, a + np.asarray(dev_dur, np.float64)], 1) \
        if len(a) else np.zeros((0, 2))
    d_launch = np.asarray([launch.get(c, s) for c, s in
                           zip(dev_corr, dev_start)], np.float64)
    keep = (d_iv[:, 1] > lo_ns) & (d_iv[:, 0] < hi_ns)
    d_iv, d_launch = d_iv[keep], d_launch[keep]
    names = [n for n, k in zip(names, keep) if k]
    kernel = np.array([not (n.startswith("Memcpy") or n.startswith("Memset"))
                       for n in names], bool)
    dur = d_iv[:, 1] - d_iv[:, 0]
    by_name = {}
    for n, t in zip(names, dur.tolist()):
        c, s = by_name.get(n, (0, 0.0))
        by_name[n] = (c + 1, s + t)
    out_spans = {}
    for lab, iv in spans.items():
        iv = np.asarray(iv, np.float64).reshape(-1, 2)
        iv = iv[(iv[:, 1] > lo_ns) & (iv[:, 0] < hi_ns)]
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        if len(iv) and len(d_launch):
            k = np.searchsorted(iv[:, 0], d_launch, side="right") - 1
            inside = (k >= 0) & (d_launch < iv[np.clip(k, 0, None), 1])
        else:
            inside = np.zeros(len(d_launch), bool)
        out_spans[lab] = {"calls": int(len(iv)),
                          "host_ns": float((iv[:, 1] - iv[:, 0]).sum()),
                          "device_ns": float(dur[inside].sum()),
                          "kernels": int((inside & kernel).sum()),
                          "intervals": stats.union(iv)}
    return {"busy": stats.union(stats.clip(d_iv, lo_ns, hi_ns)),
            "by_name": by_name, "kernels": int(kernel.sum()),
            "launches_found": bool(launch), "spans": out_spans}
