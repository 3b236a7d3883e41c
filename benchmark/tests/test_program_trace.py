"""CPU tests of ``slambench.program``: the port's own spans and counters
carried through a fleet run (``program.run``), the five metrics that read
them, and idle gaps named down to the program's spans.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
"""
import json
import os
import sys
import time

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(0, ROOT)

from slambench import fleet, program, spec  # noqa: E402
from test_bench_harness import _bench, _schema, _small  # noqa: E402

NEW = {m["name"] for m in program.METRICS}


def test_the_metrics_resolve_and_keep_to_the_contract():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    known = {m["name"] for m in b["per_layer"]}
    layers = {m["layer"] for m in b["per_layer"]}
    for m in program.METRICS:
        assert name.match(m["name"]) and m["name"] not in known
        assert callable(spec.reader(m["name"]))
        assert set(m["workloads"]) <= cells and m["moves"] == "fps"
        assert m["layer"] in layers
        assert m["source"] in ("program_span", "program_counter")


def _run(name, trace, hooked, seconds=2.0):
    cell = _small(spec.cell(ROOT, _bench(), name))
    keep = []
    args = (cell, 2 ** 31 + 5, seconds, trace, time.monotonic(),
            {"device": "cpu"}, lambda s: None)
    if hooked:
        res, code = program.run(*args, keep=keep)
    else:
        res, code = fleet.run(*args)
    return res, code, keep


@pytest.mark.parametrize("name", ["rgbd_tum_walking.fleet",
                                  "stereo_euroc.fleet"])
def test_a_traced_run_reports_the_program_metrics(name):
    res, code, (run,) = _run(name, 1, True)
    assert code == 0 and res["correct"], res["checks"]
    _schema(res, 1)
    m = res["metrics"]
    assert NEW <= set(m), sorted(m)
    assert {"host_ms_per_frame", "track_host_ms"} <= set(m)
    track = m["track_host_ms"]["value"]
    split = m["track_gn_host_ms"]["value"] + m["track_match_host_ms"]["value"]
    assert 0.9 * track <= split <= track
    assert m["sync_wait_ms"]["value"] > 0
    assert 0 <= m["host_offcpu_ms"]["value"] \
        <= m["host_ms_per_frame"]["value"]
    assert 0 <= m["retry_adopt_pct"]["value"] <= 100
    # The tracking span encloses the wrapper of fused_step.
    labs = run.spans
    tracking = labs["prog:step/tracking"]
    assert tracking["calls"] == labs["track"]["calls"]
    assert tracking["host_ms"] >= labs["track"]["host_ms"]
    for k in range(4):
        assert labs[f"prog:step/tracking/track_stage{k}/pose_gn"]["calls"] \
            == tracking["calls"]
    prog = run.program
    assert prog["reads"]["kf_decision"] == prog["steps"]
    assert prog["reads"]["f_refit_svd"] == 2 * prog["steps"]
    assert prog["device_counters"]["tracking"]["rows"] == prog["steps"]
    json.dumps(res)


def test_an_untraced_run_has_the_same_keys_hooked_or_not():
    a, code_a, _ = _run("rgbd_tum_walking.fleet", 0, False)
    b, code_b, _ = _run("rgbd_tum_walking.fleet", 0, True)
    assert code_a == code_b == 0
    assert set(a) == set(b) and set(a["metrics"]) == set(b["metrics"])
    assert not NEW & set(b["metrics"])


def test_a_plain_traced_run_carries_nothing_of_the_program():
    res, code, _ = _run("rgbd_tum_walking.fleet", 1, False)
    assert code == 0
    assert not NEW & set(res["metrics"])
    assert not any("/" in n for n, _ in res["breakdown"]["idle_gaps"])


def _session(busy, spans):
    """A session's result as the fleet receives it, with the wrapper and
    program labels ``spans`` ({label: [[start, end] s]})."""
    lab = {k: {"calls": len(v), "host_ns": 1e9, "device_ns": 0.0,
               "kernels": 0, "intervals": np.array(v, float) * 1e9}
           for k, v in spans.items()}
    return {"hand": [0.0], "back": [0.1], "done": [0.2], "h_end": 20.0,
            "attempted": 1, "peak_bytes": 1, "chip_used_bytes": 1,
            "maint_host_ms": [], "syncs": 3,
            "trace": {"busy": np.array(busy, float) * 1e9, "kernels": 1,
                      "by_name": {}, "spans": lab,
                      "program": {"steps": 1, "offcpu_ns": 5e6,
                                  "reads": {"kf_decision": 1},
                                  "read_ns": {"kf_decision": 1e6},
                                  "counters": {},
                                  "device_counters": {"tracking": {
                                      "rows": 1, "retry_adopted": 0.0}}}}}


def test_idle_gaps_are_named_down_to_the_program_span():
    """Two sessions in ``track``: the gaps inside it take the innermost
    program span most sessions were in, and add up to today's
    ``host:track``; a gap with no program span below keeps today's name."""
    g0 = "prog:step/tracking/track_stage0"
    g2 = "prog:step/tracking/track_stage2"
    common = {"track": [[0, 14]], "extract": [[14, 20]],
              "prog:step": [[0, 20]], "prog:step/tracking": [[0.8, 14]],
              "prog:step/frontend": [[14, 20]]}
    s0 = _session([[1, 2], [6, 7], [11, 12], [15, 16]], {
        **common, g0: [[0.8, 5]], g0 + "/pose_gn": [[2, 5]],
        g2: [[5, 14]], g2 + "/hamming": [[5, 10]],
        g2 + "/pose_gn": [[10, 14]]})
    s1 = _session([[1, 2], [15, 16]], {
        **common, g0: [[0.8, 4.5]], g0 + "/pose_gn": [[2, 4.5]],
        g2: [[4.5, 14]], g2 + "/hamming": [[4.5, 9.5]],
        g2 + "/pose_gn": [[9.5, 14]]})
    res = [s0, s1]
    cell = {"config": {}}
    plain = fleet.Run(cell, [program._without_program(r) for r in res], 0.0,
                      1.0, {"fast": 1e-3}, 1e-3)
    run = program.ProgramRun(cell, res, 0.0, 1.0, {"fast": 1e-3}, 1e-3)
    today = dict(plain.gaps)
    assert today == {"host:track": 12.0, "host:extract": 4.0}
    assert run.idle == {
        "host:track": 1.0,                           # [0, 1]: only "step"
        "host:track/track_stage0/pose_gn": 4.0,      # [2, 6]
        "host:track/track_stage2/hamming": 4.0,      # [7, 11]
        "host:track/track_stage2/pose_gn": 3.0,      # [12, 15]
        "host:extract": 4.0}                         # [16, 20]: "frontend"
    for lab in ("track", "extract"):
        sub = sum(v for k, v in run.idle.items()
                  if k == f"host:{lab}" or k.startswith(f"host:{lab}/"))
        assert abs(sub - today[f"host:{lab}"]) < 1e-9
    assert run.busy_s == plain.busy_s and run.kernels == plain.kernels
    assert run.spans[g2 + "/pose_gn"]["calls"] == 2
    assert run.program["steps"] == 2 and run.program["offcpu_ns"] == 1e7
    assert abs(spec.reader("host_offcpu_ms")(run) - 10.0 / run.frames) < 1e-9
    assert spec.reader("retry_adopt_pct")(run) == 0.0
    assert spec.reader("track_gn_host_ms")(plain) is None
