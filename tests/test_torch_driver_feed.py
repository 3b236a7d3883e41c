"""The offline drivers' feed and loaders, in process on the CPU: [13]'s
in-memory feed of ``chip_smoke.py`` against ``run_tum_rgbd``'s feed from
files (the same arrays, and the same System states and poses, exactly,
whether the boxes come padded to ``max_boxes`` or not), and the driver's
``--yolo``, ``--vocab``, ``--settings`` and ``--boxes`` loaders."""
import os

import numpy as np
import pytest
import torch

from chip_smoke import HOST_SCHEDULE, replica_host_frames
from coebslam_tpu_torch.config import SystemConfig
from coebslam_tpu_torch.examples import run_tum_rgbd
from coebslam_tpu_torch.io import tum
from coebslam_tpu_torch.slam.system import System
from coebslam_tpu_torch.utils import replica

torch.set_num_threads(1)
N_FILES = 3


@pytest.fixture(scope="module")
def replica_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("replica"))
    replica.write(root, **HOST_SCHEDULE, frames=range(N_FILES),
                  device="cpu")
    return root


def test_file_feed_equals_the_in_memory_feed(replica_files):
    """[13]'s frames from ``replica.generate`` against the driver's feed
    from the files (``load_frame`` and the boxes looked up as the driver
    does): equal arrays; and System.track_rgbd gives equal states and
    poses with the boxes padded to max_boxes (the driver's) or not."""
    mem, gt = replica_host_frames(replica, N_FILES, "cpu")
    seq = tum.load_tum_sequence(replica_files)
    cfg = SystemConfig()
    lookup = run_tum_rgbd.box_lookup(
        os.path.join(replica_files, "boxes.txt"), cfg.dynamic.max_boxes)
    files = []
    for i in range(N_FILES):
        stamp, g, d = seq.load_frame(i, cfg.camera.depth_map_factor)
        files.append((stamp, g, d, lookup(stamp)))
    np.testing.assert_array_equal(seq.gt_poses[:, :3], gt)
    for (s0, g0, d0, b0), (s1, g1, d1, b1) in zip(mem, files):
        assert s0 == s1
        np.testing.assert_array_equal(g0.astype(np.float32), g1)
        assert d0.dtype == d1.dtype == np.float32
        np.testing.assert_array_equal(d0, d1)
        assert (b0 is None) == (b1 is None)
        if b0 is not None:
            np.testing.assert_array_equal(b1[:len(b0)], b0)
            assert (b1[len(b0):] == -1).all()
    runs = []
    for feed in (mem, files):
        sysm = System(cfg, device="cpu")
        states = [sysm.track_rgbd(g, d, stamp=s, boxes=b)
                  for s, g, d, b in feed]
        runs.append((states, sysm.tracker.trajectory))
    assert runs[0][0] == runs[1][0]
    for (s0, R0, t0), (s1, R1, t1) in zip(runs[0][1], runs[1][1]):
        assert s0 == s1
        np.testing.assert_array_equal(R0, R1)
        np.testing.assert_array_equal(t0, t1)


def test_driver_loaders(replica_files, tmp_path):
    """--yolo (an ultralytics-layout state dict through
    yolov5.port_torch_weights), --vocab (.npz and ORBvoc text), --settings
    and the --boxes lookup (nearest stamp within 0.03 s), in process."""
    from coebslam_tpu_torch.models import yolov5
    from coebslam_tpu_torch.slam import vocabulary
    cfg = SystemConfig()
    model = yolov5.YoloV5s(cfg.detector.num_classes,
                           cfg.detector.width_multiple,
                           cfg.detector.depth_multiple)
    yolov5.init_random(model, torch.Generator().manual_seed(1))
    ours = {f"{name}.": f"model.{idx}." for name, idx in yolov5._LAYER_MAP}
    ultra = {}
    for key, val in model.state_dict().items():
        head = next(p for p in ours if key.startswith(p))
        ultra[ours[head] + key[len(head):]] = val.clone()
    ultra["model.24.anchors"] = torch.zeros(3, 3, 2)
    path = str(tmp_path / "yolov5s.pt")
    torch.save(ultra, path)
    det = run_tum_rgbd.load_yolo(path, cfg, torch.device("cpu"))
    for key, val in model.state_dict().items():
        torch.testing.assert_close(det.model.state_dict()[key], val,
                                   rtol=0, atol=0)
    assert run_tum_rgbd.load_yolo(None, cfg, "cpu") is None

    rng = np.random.RandomState(0)
    voc = vocabulary.train(rng.randint(0, 256, (400, 32), np.uint8),
                           branching=4, depth=2, seed=0)
    vocabulary.save(str(tmp_path / "v.npz"), voc)
    vocabulary.save_orbvoc_text(str(tmp_path / "v.txt"), voc)
    for name in ("v.npz", "v.txt"):
        got = run_tum_rgbd.load_vocabulary(str(tmp_path / name))
        for a, b in zip(got, voc):
            np.testing.assert_array_equal(a, b)

    (tmp_path / "s.yaml").write_text("%YAML:1.0\n---\nCamera.fx: 500.0\n")
    assert run_tum_rgbd.load_settings(str(tmp_path / "s.yaml")).camera.fx \
        == 500.0
    assert run_tum_rgbd.load_settings(None) == cfg

    lookup = run_tum_rgbd.box_lookup(os.path.join(replica_files,
                                                  "boxes.txt"), 8)
    first = lookup(0.0)
    assert first.shape == (8, 4) and first[0, 0] >= 0
    np.testing.assert_array_equal(lookup(0.012), first)
    assert lookup(-0.031) is None
    assert run_tum_rgbd.box_lookup(None, 8) is None
