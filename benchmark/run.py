"""Run one cell of the port's benchmark once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. A cell is a
fleet of realtime SLAM sessions of the port (``coebslam_tpu_torch``),
each in a process of its own on one NVIDIA GPU, fed closed-loop for
``--seconds``. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` when traced, and ``checks``, each number compared with its
limit, which are also the last lines of standard error. Without CUDA,
with fewer devices than the cell asks for, without the port beside this
directory, or with JAX or the JAX package loaded, it exits non-zero and
prints no result.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _environment():
    """Build and kernel caches at fixed paths inside the checkout, one
    intra-op thread per process, and no Flax through third-party
    imports."""
    cache = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def _finite(x):
    """The result with NaN and infinities as null (JSON has neither)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from slambench import fleet, spec
    try:
        bench = spec.load(ROOT)
        cell = spec.cell(ROOT, bench, args.workload)
    except spec.SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if importlib.util.find_spec("coebslam_tpu_torch") is None:
        print("benchmark: the port (coebslam_tpu_torch) is not beside "
              "benchmark/", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    result, code = fleet.run(cell, args.seed, args.seconds, args.trace,
                             T_START)
    if result is None:
        return code or 1
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
