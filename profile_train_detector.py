"""Detector training on the card under several numeric settings, to find
where and why the card's loss curve leaves the CPU's.

Run from the repository root (on a machine with a CUDA card):

    python3 profile_train_detector.py [--steps 700] [--width 0.25]
        [--json build/train_diag.json] [--cpu-json PATH]
    python3 profile_train_detector.py --tool-twice [--steps 700]
        [--width 0.25] [--cpu-json PATH] [--jax-json PATH]

``--tool-twice`` runs the tool as it ships (``train_detector.run`` with
its defaults, deterministic) twice and prints whether every loss, loss
term and trained weight and the held-out IoU are equal, the losses at the
tool's logged steps (every 100 and the last), and, given the CPU curves
(``cpu_reference.py port train-curve`` and ``jax train-curve`` JSON), the
logged steps whose loss exceeds 2x the larger of the two CPU losses.

Without it:

Renders the tool's dataset once (3 x 130 walker frames; the SHA-1 of the
frames and boxes is printed, so runs can be compared), then trains the
tool's network on it in these settings, each twice:

  default   PyTorch's defaults: cuDNN may pick non-deterministic
            convolution algorithms and computes float32 convolutions in
            TF32 (10-bit mantissa);
  fp32      TF32 off, nothing else changed;
  exact     train_detector.deterministic (what the tool runs): PyTorch's
            deterministic algorithms, cuDNN deterministic and not
            benchmarked, TF32 off. Ops that have no deterministic CUDA
            kernel are listed (``warn_only``), not raised.

For each run it prints the loss and its four terms (objectness BCE, class
BCE, xy, wh) every 10 steps, the largest loss and its step, and the
held-out IoU; for each pair the first step whose losses differ and by how
much. With ``--cpu-json`` (a ``{"losses": [...]}`` file of a CPU run of the
tool, e.g. written by ``cpu_reference.py port train-curve``), each run's
first step more than 1 %, 10 % and 2x away from the CPU's loss. ``--json``
writes every per-step loss and term.
"""
import argparse
import contextlib
import hashlib
import json
import os
import sys
import time
import warnings

import numpy as np

SETTINGS = ("default", "fp32", "exact")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu-json", default=None)
    ap.add_argument("--jax-json", default=None)
    ap.add_argument("--tool-twice", action="store_true")
    return ap.parse_args(argv)


def tool_twice(args, td, torch, card):
    """``--tool-twice`` (see above)."""
    outs = []
    for k in range(2):
        t0 = time.perf_counter()
        out = td.run(td.parse_args(
            ["--width", str(args.width), "--steps", str(args.steps),
             "--out", os.path.join("build", f"train_twice{k}.npz")]))
        out["seconds"] = time.perf_counter() - t0
        outs.append(out)
    a, b = outs
    same = (a["losses"] == b["losses"]
            and np.array_equal(a["terms"], b["terms"])
            and all(torch.equal(a["state_dict"][k], b["state_dict"][k])
                    for k in a["state_dict"]))
    logged = sorted(set(range(0, args.steps, 100)) | {args.steps - 1})
    print(f"train_detector --width {args.width} --steps {args.steps}, twice "
          f"on {card}: losses, terms and weights bit-equal {same}; held-out "
          f"IoU {a['miou']:.4f} / {b['miou']:.4f} over {a['n_boxes']} "
          f"boxes; {a['seconds']:.1f} / {b['seconds']:.1f} s, "
          f"{a['steps_per_s']:.2f} / {b['steps_per_s']:.2f} steps/s; largest "
          f"loss {max(a['losses']):.4f} at step "
          f"{int(np.argmax(a['losses']))}", flush=True)
    refs = {}
    for name, path in (("port CPU", args.cpu_json),
                       ("JAX CPU", args.jax_json)):
        if path:
            with open(path) as f:
                refs[name] = json.load(f)["losses"]
    over = []
    for s in logged:
        line = f"step {s}: card {a['losses'][s]:.4f}"
        for name, ref in refs.items():
            line += f", {name} {ref[s]:.4f}"
        if refs and a["losses"][s] > 2 * max(r[s] for r in refs.values()):
            over.append(s)
        print(line, flush=True)
    if refs:
        print(f"logged steps above 2x the larger CPU loss: {over}",
              flush=True)
    print(json.dumps({"card": card, "bit_equal": same,
                      "miou": [a["miou"], b["miou"]],
                      "logged": {s: a["losses"][s] for s in logged},
                      "over_2x": over}))


def first_gap(a, b, rel):
    """The first step at which |a - b| > rel * |b|, or None."""
    a, b = np.asarray(a), np.asarray(b)
    m = min(len(a), len(b))
    far = np.nonzero(np.abs(a[:m] - b[:m]) > rel * np.abs(b[:m]))[0]
    return int(far[0]) if len(far) else None


def main(argv=None):
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_train_detector: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from coebslam_tpu_torch.tools import train_detector as td

    args = parse_args(argv)
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"cuDNN {torch.backends.cudnn.version()}", flush=True)
    if args.tool_twice:
        tool_twice(args, td, torch, card)
        return
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    G, B = td.render_dataset(device=dev)
    digest = hashlib.sha1(G.tobytes() + B.tobytes()).hexdigest()
    print(f"dataset {G.shape} rendered in {time.perf_counter() - t0:.1f} s, "
          f"sha1 {digest}", flush=True)
    tool_args = td.parse_args(["--width", str(args.width), "--steps",
                               str(args.steps), "--log-every", "10",
                               "--out", os.path.join("build",
                                                     "train_diag.npz")])
    cpu = None
    if args.cpu_json:
        with open(args.cpu_json) as f:
            cpu = json.load(f)["losses"]
    runs = {}
    cudnn = torch.backends.cudnn
    for name in SETTINGS:
        for k in range(2):
            print(f"--- {name} run {k + 1}", flush=True)
            flagged = set()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if name == "exact":
                    ctx = td.deterministic(torch, warn_only=True)
                else:
                    ctx = contextlib.nullcontext()
                tf32 = cudnn.allow_tf32
                cudnn.allow_tf32 = name == "default"
                try:
                    with ctx:
                        t1 = time.perf_counter()
                        out = td._train(tool_args, dev, G, B, 0.0)
                        secs = time.perf_counter() - t1
                finally:
                    cudnn.allow_tf32 = tf32
            for w in caught:
                msg = str(w.message)
                if "deterministic" in msg:
                    flagged.add(msg.split(" does not")[0][-80:])
            losses = np.asarray(out["losses"])
            worst = int(np.argmax(losses))
            runs[f"{name}{k + 1}"] = r = {
                "losses": losses.tolist(), "terms": out["terms"].tolist(),
                "miou": out["miou"], "seconds": secs,
                "max_loss": float(losses[worst]), "max_step": worst,
                "flagged": sorted(flagged)}
            print(f"{name} run {k + 1}: {secs:.1f} s, loss "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f}, largest "
                  f"{r['max_loss']:.4f} at step {worst} (terms "
                  f"{np.round(out['terms'][worst], 4).tolist()}), IoU "
                  f"{out['miou']:.3f}; ops without a deterministic kernel: "
                  f"{r['flagged']}", flush=True)
            if cpu is not None:
                print(f"{name} run {k + 1} against the CPU: first step 1 % "
                      f"away {first_gap(losses, cpu, 0.01)}, 10 % away "
                      f"{first_gap(losses, cpu, 0.1)}, 2x away "
                      f"{first_gap(losses, cpu, 1.0)}", flush=True)
        a, b = runs[f"{name}1"], runs[f"{name}2"]
        same = np.asarray(a["losses"]) == np.asarray(b["losses"])
        diff = None if same.all() else int(np.argmin(same))
        print(f"{name}: the two runs' losses bit-equal at every step: "
              f"{bool(same.all())} (first differing step {diff}; largest "
              f"gap {np.abs(np.subtract(a['losses'], b['losses'])).max():.6g}"
              f"); IoU {a['miou']:.4f} / {b['miou']:.4f}", flush=True)
    print("per 10 steps (step: " + ", ".join(runs) + ")")
    for s in range(0, args.steps, 10):
        print(f"{s}: " + ", ".join(f"{r['losses'][s]:.4f}"
                                   for r in runs.values()))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "dataset_sha1": digest, "runs": runs}, f)
    print(json.dumps({"card": card, "dataset_sha1": digest, "summary": {
        k: {x: r[x] for x in ("max_loss", "max_step", "miou", "seconds",
                              "flagged")} for k, r in runs.items()}}))


if __name__ == "__main__":
    main()
