"""What ``BENCHMARK.json`` and the files it names say about one cell.

Everything that belongs to one configuration, one cell or one metric sits
in a file of its own, found by name: ``configs/<config>.json`` (the
configuration as it is run; BENCHMARK.json names the file),
``cells/<cell>.json`` (the cell's traffic: sessions, frames, walkers,
warm-up, sample), ``limits/<cell>.json`` (the limits of the numbers that
decide ``correct``) and ``metrics/<metric>.py`` (the reader of one
metric). A cell, a configuration or a metric is added by adding files and
entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SpecError(ValueError):
    """A cell, configuration or metric that the files do not resolve."""


def load(root: str) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise SpecError(f"no BENCHMARK.json in {root}")
    with open(path) as f:
        return json.load(f)


def _json(path):
    if not os.path.exists(path):
        raise SpecError(f"missing {os.path.relpath(path, HERE)}")
    with open(path) as f:
        return json.load(f)


def cell(root: str, bench: dict, name: str, bench_dir: str = HERE) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise SpecError(f"no configuration {entry['config']!r}")
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(bench_dir, "cells", f"{name}.json"))
    limits = _json(os.path.join(bench_dir, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moves)]
    return {"name": name, "root": root, "entry": entry, "config": config,
            "traffic": traffic, "limits": limits, "end_to_end": e2e,
            "per_layer": layer, "chips": entry["chips"]}


def reader(name: str, bench_dir: str = HERE):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise SpecError(f"no reader metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
