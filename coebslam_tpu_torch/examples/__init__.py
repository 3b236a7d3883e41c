"""The offline drivers: the reference's example programs on recorded
sequences (``rgbd_tum``, ``stereo_kitti`` / ``stereo_euroc``,
``mono_tum`` / ``mono_kitti`` / ``mono_euroc``) and a synthetic demo.
Each runs as ``python3 -m coebslam_tpu_torch.examples.<name> ...`` and
exposes ``run(args) -> dict`` and ``main(argv)``."""
