"""The port's own spans and counters in a run of a cell.

With its recorder on (``coebslam_tpu_torch.utils.metrics``), the port
records spans and counters inside its realtime step: the frame's ``step``,
its stages, tracking's four stages each split into ``hamming`` and
``pose_gn``, the statements that read a device value to the host
(``read:<site>``), counts of keyframes, closures and relocalizations, and
a row of tracking counts per frame kept on the device. This module carries
them through a fleet run:

- ``Hook``, put in a run's ``opts``, is unpickled in each session's
  process: it turns the recorder on before the warm-up and makes the
  session's trace reduction take the program's spans as labels
  ``prog:<path>`` beside the wrappers' (calls, host ns, and the device ns
  and kernels launched inside, as ``trace.reduce`` gives them), with what
  the program recorded in the window (``window``).
- ``ProgramRun`` is ``fleet.Run`` with those labels in ``spans``, the
  sessions' windows summed in ``program``, and each idle gap named down to
  the innermost program span inside the wrapper label (``name_gaps``).
- ``run`` runs a cell so, reading ``METRICS`` besides its per-layer ones.

``session.py`` and ``fleet.py`` do not use this module: a run of
``run.py`` leaves the recorder off and reads none of ``METRICS``.
``profile_fleet.py`` at the repository's root runs a cell through ``run``.
"""
from __future__ import annotations

import numpy as np

from . import fleet, stats

PREFIX = "prog:"
GAP_NAME_MAX = 64
CELLS = ["rgbd_tum_walking.fleet", "stereo_euroc.fleet"]

# The program's span that a wrapper label of the configurations encloses.
LABEL_SPAN = {"extract": "frontend", "stereo_match": "stereo_match",
              "dynamic": "dynamic_frontend", "track": "tracking",
              "kf_ba": "keyframe_ba", "detect": "detect",
              "maint": "maintenance"}


def _metric(name, unit, better, source, layer):
    return {"name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": "fps", "workloads": list(CELLS)}


# The per-layer metrics that read the program's spans and counters, as
# BENCHMARK.json would list them; a reader each in metrics/.
METRICS = [
    _metric("track_gn_host_ms", "ms", "lower", "program_span", "tracking"),
    _metric("track_match_host_ms", "ms", "lower", "program_span",
            "tracking"),
    _metric("sync_wait_ms", "ms", "lower", "program_span", "host loop"),
    _metric("host_offcpu_ms", "ms", "lower", "program_span", "host loop"),
    _metric("retry_adopt_pct", "%", "higher", "program_counter", "tracking"),
]


def labels(spans) -> dict:
    """The recorder's spans as ``trace.reduce``'s labels: ``prog:<path>``
    -> [(start, end)] ns."""
    out = {}
    for s in spans:
        out.setdefault(PREFIX + s["path"], []).append((s["t0"], s["t1"]))
    return out


def window(rec: dict, lo_ns: float, hi_ns: float) -> dict:
    """What the recorder's ``drain()`` holds of the window [lo, hi]: the
    ``step`` spans that lie in it (as ``trace.reduce`` keeps intervals),
    their wall minus thread CPU ns, the reads and their wait per site, and
    the host and device counters of those steps' requests."""
    win = [s for s in rec["spans"] if s["t1"] > lo_ns and s["t0"] < hi_ns]
    steps = [s for s in win if s["path"] == "step"]
    req = {s["request"] for s in steps}
    reads, read_ns = {}, {}
    for s in win:
        if s["reads"]:
            site = s["name"][len("read:"):]
            reads[site] = reads.get(site, 0) + s["reads"]
            read_ns[site] = read_ns.get(site, 0) + s["t1"] - s["t0"]
    counters = {n: sum(v for r, v in per.items() if r in req)
                for n, per in rec["counters"].items()}
    device = {}
    for n, cols in rec["device_counters"].items():
        keep = [r in req for r in cols["request"]]
        device[n] = {f: float(sum(v for v, k in zip(vals, keep) if k))
                     for f, vals in cols.items() if f != "request"}
        device[n]["rows"] = sum(keep)
    return {"steps": len(steps),
            "offcpu_ns": sum(s["t1"] - s["t0"] - s["cpu_ns"] for s in steps),
            "reads": reads, "read_ns": read_ns, "counters": counters,
            "device_counters": device}


def merge(windows) -> dict:
    """The sessions' ``window``s summed."""
    out = {"steps": 0, "offcpu_ns": 0, "reads": {}, "read_ns": {},
           "counters": {}, "device_counters": {}}
    for w in windows:
        out["steps"] += w["steps"]
        out["offcpu_ns"] += w["offcpu_ns"]
        for key in ("reads", "read_ns", "counters"):
            for k, v in w[key].items():
                out[key][k] = out[key].get(k, 0) + v
        for n, f in w["device_counters"].items():
            d = out["device_counters"].setdefault(n, {})
            for k, v in f.items():
                d[k] = d.get(k, 0) + v
    return out


class Hook:
    """In a fleet run's ``opts``: unpickled in a session's process, it
    turns the port's recorder on and makes ``trace.reduce`` carry the
    program's spans and window (``_install``)."""

    def __reduce__(self):
        return (_install, ())


def _install():
    from coebslam_tpu_torch.utils import metrics
    from . import trace
    if not getattr(trace.reduce, "with_program", False):
        plain = trace.reduce

        def reduce(events, spans, lo_ns, hi_ns):
            rec = metrics.drain()
            red = plain(events, {**spans, **labels(rec["spans"])}, lo_ns,
                        hi_ns)
            red["program"] = window(rec, lo_ns, hi_ns)
            return red

        reduce.with_program = True
        trace.reduce = reduce
    metrics.tracing(True)
    return Hook()


def _innermost(labs, intervals, mid):
    """Per point of ``mid``, the index into ``labs`` of the deepest
    program span whose interval holds it (-1: none)."""
    best = np.full(len(mid), -1)
    depth = np.full(len(mid), -1)
    for j, lab in enumerate(labs):
        iv = intervals[lab]
        if not len(iv):
            continue
        k = np.searchsorted(iv[:, 0], mid, side="right") - 1
        inside = (k >= 0) & (mid < iv[np.clip(k, 0, None), 1])
        d = lab.count("/")
        take = inside & (d > depth)
        best[take], depth[take] = j, d
    return best


def _below(label, path):
    """The part of a program span's path below the span that the wrapper
    ``label`` encloses; None when the path does not pass through it."""
    parts = path[len(PREFIX):].split("/")
    inner = LABEL_SPAN.get(label)
    if inner not in parts:
        return None
    rest = parts[parts.index(inner) + 1:]
    return "/".join(rest) or None


def name_gaps(results, busy, lo, hi) -> dict:
    """{name: idle seconds}. A gap of the card (outside ``busy``) is
    labelled as ``fleet.Run`` labels it, by the wrapper label most sessions
    were in at its middle; then, among the sessions inside that label, by
    the innermost program span most of them were in, as
    ``host:<label>/<path below the label's span>`` (at most
    ``GAP_NAME_MAX`` characters). A gap with no program span below the
    label keeps the label's name, so the seconds under ``host:<label>``
    and its sub-names add up to what the label alone reads."""
    g = stats.gaps(busy, lo, hi)
    mid = 0.5 * (g[:, 0] + g[:, 1])
    spans = [r["trace"]["spans"] for r in results]
    bench = sorted({lab for s in spans for lab in s
                    if not lab.startswith(PREFIX)})
    votes = np.zeros((len(bench) + 1, len(mid)))
    votes[-1] = 0.5                       # "outside spans" below one vote
    inside = np.zeros((len(results), len(bench), len(mid)), bool)
    for i, s in enumerate(spans):
        for j, lab in enumerate(bench):
            iv = s.get(lab, {}).get("intervals")
            if iv is None or not len(iv):
                continue
            k = np.searchsorted(iv[:, 0], mid, side="right") - 1
            inside[i, j] = (k >= 0) & (mid < iv[np.clip(k, 0, None), 1])
            votes[j] += inside[i, j]
    who = votes.argmax(0)
    names = np.array([f"host:{lab}" for lab in bench] + ["host:outside spans"],
                     dtype=object)[who]
    # The innermost program span of each session at each middle.
    inner = []
    for s in spans:
        labs = sorted(lab for lab in s if lab.startswith(PREFIX))
        iv = {lab: s[lab]["intervals"] for lab in labs}
        inner.append((labs, _innermost(labs, iv, mid)))
    for n in range(len(mid)):
        j = who[n]
        if j == len(bench):
            continue
        tally = {}
        for i, (labs, best) in enumerate(inner):
            if inside[i, j, n] and best[n] >= 0:
                below = _below(bench[j], labs[best[n]])
                if below is not None:
                    tally[below] = tally.get(below, 0) + 1
        if tally:
            top = max(sorted(tally), key=lambda k: tally[k])
            names[n] = f"host:{bench[j]}/{top}"[:GAP_NAME_MAX]
    idle = {}
    for nm, (a, b) in zip(names, g):
        idle[nm] = idle.get(nm, 0.0) + float(b - a) / 1e9
    return {k: v for k, v in idle.items() if v > 0}


def _without_program(r):
    tr = dict(r["trace"])
    tr["spans"] = {k: v for k, v in tr["spans"].items()
                   if not k.startswith(PREFIX)}
    return dict(r, trace=tr)


class ProgramRun(fleet.Run):
    """``fleet.Run`` with the wrapper labels, busy time and kernels read as
    it reads them, plus the program's labels in ``spans``, every idle gap's
    name in ``idle`` (the ten longest in ``gaps``) and the sessions'
    windows in ``program``."""

    def _reduce_traces(self, results, t0):
        super()._reduce_traces([_without_program(r) for r in results], t0)
        for r in results:
            for lab, s in r["trace"]["spans"].items():
                if not lab.startswith(PREFIX):
                    continue
                a = self.spans.setdefault(lab, {"calls": 0, "host_ms": 0.0,
                                                "device_ms": 0.0,
                                                "kernels": 0})
                a["calls"] += s["calls"]
                a["host_ms"] += s["host_ns"] / 1e6
                a["device_ms"] += s["device_ns"] / 1e6
                a["kernels"] += s["kernels"]
        lo, hi = t0 * 1e9, (t0 + self.window_s) * 1e9
        busy = stats.clip(stats.union(np.concatenate(
            [r["trace"]["busy"] for r in results])), lo, hi)
        self.idle = name_gaps(results, busy, lo, hi)
        self.gaps = sorted(self.idle.items(), key=lambda x: -x[1])[:10]
        self.program = merge([r["trace"]["program"] for r in results
                              if "program" in r["trace"]])


def span_ms(run, match):
    """Host ms of the program's spans whose own name (the last part of the
    path) passes ``match``, a name or a predicate; None when the run holds
    no such span."""
    test = match if callable(match) else (lambda n: n == match)
    got = [s["host_ms"] for lab, s in run.spans.items()
           if lab.startswith(PREFIX) and s["calls"]
           and test(lab.rsplit("/", 1)[-1])]
    return sum(got) if got else None


def run(cell, seed, seconds, trace, t_start, opts=None, log=None,
        keep=None, recorder=True):
    """``fleet.run`` with the recorder on in every session and, when
    traced, the program's labels, window and ``METRICS`` read. ``keep``:
    a list that receives the run's ``ProgramRun``. ``recorder=False``
    leaves the recorder off (a plain run, kept as a ``ProgramRun``)."""
    cell = dict(cell, per_layer=list(cell["per_layer"]) + METRICS)
    opts = dict(opts or {})
    if recorder:
        opts["program"] = Hook()
    plain = fleet.Run

    class Kept(ProgramRun):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if keep is not None:
                keep.append(self)

    fleet.Run = Kept
    try:
        return fleet.run(cell, seed, seconds, trace, t_start, opts, log)
    finally:
        fleet.Run = plain
