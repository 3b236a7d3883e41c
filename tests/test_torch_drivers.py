"""The port's offline drivers and tools, run as a user runs them
(``python3 -m ...`` in a subprocess, ``--cpu``) on small files, as
tests/test_example_drivers.py runs the JAX package's: KITTI stereo and
EuRoC mono on 6 rendered frames written as PNGs, ``run_tum_rgbd`` in host
and realtime mode on a few replica frames, ``make_tum_replica``, the
synthetic demo; and that the package imports none of JAX, the JAX
package, PIL or PyYAML. The drivers' feed and loaders are held in
process in tests/test_torch_driver_feed.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (HOST_SCHEDULE, N_EXAMPLE, example_frames,
                        write_example_sequences)
from coebslam_tpu_torch.config import SystemConfig
from coebslam_tpu_torch.geometry.se3 import SE3
from coebslam_tpu_torch.io import png, tum
from coebslam_tpu_torch.utils import replica, synthetic

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FILES = 3


def _run(args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m"] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("examples"))
    frames = example_frames(torch, synthetic, SE3, SystemConfig().camera,
                            "cpu")
    return write_example_sequences(png, frames, root)


@pytest.fixture(scope="module")
def replica_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("replica"))
    replica.write(root, **HOST_SCHEDULE, frames=range(N_FILES),
                  device="cpu")
    return root


def test_kitti_stereo_driver(sequences, tmp_path):
    kroot, _ = sequences
    out = tmp_path / "out"
    r = _run(["coebslam_tpu_torch.examples.run_stereo", "kitti", kroot,
              "--cpu", "--out", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout, r.stdout
    for name in ("CameraTrajectoryKITTI.txt", "CameraTrajectory.txt",
                 "KeyFrameTrajectory.txt"):
        assert (out / name).exists(), (name, r.stdout)
    rows = np.loadtxt(out / "CameraTrajectoryKITTI.txt")
    assert rows.reshape(-1, 12).shape[0] == N_EXAMPLE


def test_euroc_mono_driver(sequences, tmp_path):
    """Mono may not initialise in 6 low-parallax frames: the driver must
    run the loader, the pipeline and the export cleanly."""
    _, eroot = sequences
    out = tmp_path / "out"
    r = _run(["coebslam_tpu_torch.examples.run_mono", "euroc", eroot,
              "--cpu", "--out", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert (out / "CameraTrajectory.txt").exists()
    assert (out / "KeyFrameTrajectory.txt").exists()


@pytest.mark.parametrize("mode", ["host", "realtime"])
def test_tum_rgbd_driver(mode, replica_files, tmp_path):
    out = tmp_path / "out"
    args = ["coebslam_tpu_torch.examples.run_tum_rgbd", replica_files,
            "--cpu", "--boxes", os.path.join(replica_files, "boxes.txt"),
            "--out", str(out)]
    if mode == "realtime":
        args += ["--realtime", "--refine"]
    else:
        args += ["--viz"]
    r = _run(args)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ATE RMSE" in r.stdout, r.stdout
    rows = np.loadtxt(out / "CameraTrajectory.txt", ndmin=2)
    assert rows.shape == (N_FILES, 8) and np.isfinite(rows).all()
    assert (out / "KeyFrameTrajectory.txt").exists()
    if mode == "host":
        assert (out / "map.ply").exists()
        assert png.read(str(out / "map_topdown.png")).shape == (800, 800, 3)
    else:
        assert "refined ATE RMSE" in r.stdout, r.stdout


def test_tum_rgbd_hybrid_gba(tmp_path, capsys):
    """--realtime --hybrid-gba in process on 8 replica frames (a keyframe
    at most every 2 frames, so the refine step has keyframes to optimise):
    the refine step runs, then the segment-sharded global BA over a
    (1, 1) mesh prints the hybrid-mesh line, and its keyframe poses equal
    the refine step's global BA within 2e-3 (it starts from them, so the
    solve has converged)."""
    from coebslam_tpu_torch.examples import run_tum_rgbd
    root = str(tmp_path / "rep")
    replica.write(root, **HOST_SCHEDULE, frames=range(8), device="cpu")
    settings = tmp_path / "kf2.yaml"
    settings.write_text("tracking:\n  max_frames_between_kf: 2\n")
    out = run_tum_rgbd.run(run_tum_rgbd.parse_args(
        [root, "--cpu", "--boxes", os.path.join(root, "boxes.txt"),
         "--realtime", "--hybrid-gba", "--settings", str(settings),
         "--out", str(tmp_path / "out")]))
    printed = capsys.readouterr().out
    h, m = out["hybrid"], out["arena"]
    assert out["n_opt"] >= 3, printed
    line = [ln for ln in printed.splitlines()
            if ln.startswith("hybrid-mesh GBA:")]
    assert line == [f"hybrid-mesh GBA: {len(h['kfs'])} KFs / "
                    f"{sum(h['segment_counts'])} points over mesh (1, 1) "
                    f"(dcn,ici); segment point counts "
                    f"{h['segment_counts']}"], printed
    assert h["mesh"] == (1, 1) and h["n_ranks"] == 1
    np.testing.assert_allclose(h["kf_t"], m.kf_t[h["kfs"]], atol=2e-3)
    np.testing.assert_allclose(h["kf_R"], m.kf_R[h["kfs"]], atol=2e-3)
    assert (tmp_path / "out" / "KeyFrameTrajectory.txt").exists()


def test_make_tum_replica(tmp_path):
    """The tool writes what replica.write writes, byte for byte."""
    out = tmp_path / "rep"
    r = _run(["coebslam_tpu_torch.tools.make_tum_replica", str(out),
              "--frames", "2", "--cpu"])
    assert r.returncode == 0, r.stdout + r.stderr
    seq = tum.load_tum_sequence(str(out))
    assert len(seq) == 2 and seq.gt_poses.shape == (2, 7)
    ref = tmp_path / "ref"
    replica.write(str(ref), n_frames=2, device="cpu")
    for sub in ("rgb", "depth"):
        assert sorted(os.listdir(out / sub)) == sorted(os.listdir(ref / sub))
        for name in os.listdir(out / sub):
            assert (out / sub / name).read_bytes() \
                == (ref / sub / name).read_bytes()
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt", "boxes.txt"):
        assert (out / name).read_text() == (ref / name).read_text()


def test_package_imports_no_jax_pil_or_yaml():
    """Every module of the package, drivers and tools included."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import coebslam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'coebslam_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'coebslam_tpu', 'PIL', 'yaml'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split()[0])
    assert n >= 60, r.stdout          # examples and tools are walked too


def test_synthetic_driver(tmp_path):
    """The synthetic demo over its 15-frame orbit (fewer frames make
    wider steps around it): every frame tracked, ATE under 1 cm (the JAX
    driver's documented ~0.5 cm), the trajectory written."""
    r = _run(["coebslam_tpu_torch.examples.run_synthetic", "15", "--cpu",
              "--out", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    states = [ln.split()[2] for ln in r.stdout.splitlines()
              if ln.startswith("frame")]
    assert states == ["OK"] * 15, r.stdout
    ate_cm = float(r.stdout.split("ATE RMSE:")[1].split()[0])
    assert ate_cm < 1.0, r.stdout
    assert np.loadtxt(tmp_path / "CameraTrajectory.txt").shape == (15, 8)


@pytest.mark.slow
def test_synthetic_driver_matches_the_jax_driver(tmp_path):
    """Both packages' synthetic drivers on 15 frames: the same states, and
    ATEs within 0.3 cm of each other (the two renderers differ at a few
    pixels, so the poses are not bit-equal). The JAX driver writes its
    trajectory beside itself, so it runs from a copy in tmp_path."""
    jax_driver = tmp_path / "examples" / "run_synthetic.py"
    jax_driver.parent.mkdir()
    jax_driver.write_text(
        open(os.path.join(REPO, "examples", "run_synthetic.py")).read())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    outs = []
    for cmd in (["-m", "coebslam_tpu_torch.examples.run_synthetic",
                 "--out", str(tmp_path)], [str(jax_driver)]):
        r = subprocess.run([sys.executable] + cmd + ["15", "--cpu"],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=900, env=env)
        assert r.returncode == 0, r.stdout + r.stderr
        outs.append(r.stdout)
    assert (jax_driver.parent / "CameraTrajectory.txt").exists()
    states = [[ln.split()[2] for ln in o.splitlines()
               if ln.startswith("frame")] for o in outs]
    assert states[0] == states[1] == ["OK"] * 15
    ates = [float(o.split("ATE RMSE:")[1].split()[0]) for o in outs]
    assert abs(ates[0] - ates[1]) < 0.3, ates
