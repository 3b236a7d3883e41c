"""Configuration of the ported paths.

The port keeps its own copy of the dataclasses this slice reads, with the
same field names and defaults as the JAX package's ``config.py``; there
is no YAML loader here. ``config_from_dict`` builds a ``SystemConfig``
from ``dataclasses.asdict`` of the JAX package's configuration, so both
packages can be started from one configuration. Sections and fields this
package does not read yet are ignored.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics, distortion and RGB-D parameters (TUM fr3)."""

    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    bf: float = 40.0                # stereo baseline times fx (m * px)
    th_depth: float = 50.0          # close-point threshold, baseline units
    depth_map_factor: float = 5000.0
    rgb_order: int = 1

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def depth_threshold(self) -> float:
        """Max reliable depth in metres (close-point threshold)."""
        return self.bf * self.th_depth / self.fx


@dataclass(frozen=True)
class OrbConfig:
    """ORB extraction parameters, including the COEB dual FAST thresholds."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold_init: int = 20
    fast_threshold_min: int = 7
    fast_threshold_init_masked: int = 30
    fast_threshold_min_masked: int = 10
    cell_size: int = 32
    patch_size: int = 31
    half_patch_size: int = 15
    edge_threshold: int = 19
    masked_budget_scale: float = 0.7
    max_keypoints: int = 2048


@dataclass(frozen=True)
class DynamicConfig:
    """COEB dynamic front-end constants."""

    epipolar_threshold: float = 1.0
    flow_diff_threshold: float = 2120.0
    flow_edge_margin: int = 5
    n_flow_points: int = 1000
    blur_threshold: float = 4.2
    box_density_scale: float = 10000.0
    masked_area_limit: float = 200000.0
    f_ransac_iters: int = 256
    f_ransac_threshold: float = 1.0
    dynamic_classes: Tuple[int, ...] = (0,)
    max_boxes: int = 16
    spawn_in_boxes: bool = False
    sticky_frames: int = 5
    motion_check: str = "feature"
    match_radius: float = 80.0
    detector_cadence: int = 5


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching constants."""

    th_high: int = 100
    th_low: int = 50
    histo_length: int = 30
    nn_ratio_tracking: float = 0.9
    nn_ratio_bow: float = 0.75
    nn_ratio_init: float = 0.9
    radius_motion_model: float = 15.0
    radius_local_map: float = 3.0
    radius_init: float = 100.0
    check_orientation: bool = True


@dataclass(frozen=True)
class OptimizerConfig:
    """Least-squares schedules of the pose solve and the local BA."""

    pose_rounds: int = 4
    pose_iters_per_round: int = 10
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    local_ba_iters_first: int = 5
    local_ba_iters_second: int = 10
    global_ba_iters: int = 10
    init_ba_iters: int = 20
    essential_graph_iters: int = 20
    essential_graph_lambda_init: float = 1e-16
    sim3_iters_first: int = 5
    sim3_iters_second: int = 10
    lm_lambda_init: float = 1e-4
    lm_lambda_factor: float = 2.0


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking policy constants (keyframe policy, adaptive budget, gates)."""

    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    kf_ref_ratio_many_close: float = 0.75
    kf_ref_ratio_stereo: float = 0.75
    kf_ref_ratio_mono: float = 0.9
    min_inliers_kf: int = 15
    max_local_keyframes: int = 80
    adaptive_budget: bool = True
    budget_step: int = 500
    budget_cap: int = 2000
    budget_floor: int = 1000
    weak_inlier_threshold: int = 100
    strong_inlier_threshold: int = 200
    decay_success_window: int = 30
    decay_strong_window: int = 10
    reloc_min_inliers: int = 50
    reset_if_lost_with_kfs_below: int = 6
    min_matches_motion_model: int = 20
    min_inliers_track: int = 10
    min_inliers_local_map: int = 30
    max_translation_per_frame: float = 0.35
    max_rotation_per_frame: float = 0.35


@dataclass(frozen=True)
class MappingConfig:
    """Local mapping constants (the host path's ``LocalMapper``)."""

    # MapPointCulling.
    min_found_ratio: float = 0.25
    min_observations: int = 3
    # Triangulation gates.
    triangulation_chi2_mono: float = 5.991
    triangulation_chi2_stereo: float = 7.8
    covisibility_weight_threshold: int = 15
    # KeyFrameCulling: >= 90 % of points seen >= 3x elsewhere.
    kf_cull_redundancy_ratio: float = 0.9
    kf_cull_min_obs: int = 3
    # Covisible neighbours paired for triangulation (RGB-D / mono).
    triangulation_neighbors_rgbd: int = 10
    triangulation_neighbors_mono: int = 20


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing constants (the maintenance program reads
    ``covisibility_consistency_threshold``, ``min_score_factor`` and
    ``min_sim3_inliers``)."""

    covisibility_consistency_threshold: int = 3
    # Scale on the covisibility min-score gate (1.0 = reference semantics).
    min_score_factor: float = 1.0
    min_bow_matches: int = 20
    sim3_ransac_prob: float = 0.99
    sim3_ransac_min_inliers: int = 20
    sim3_ransac_iters: int = 300
    min_sim3_inliers: int = 20
    min_total_matches: int = 40
    essential_graph_min_covis: int = 100


@dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity map-arena sizes (the host arena of the handoff)."""

    max_keyframes: int = 512
    max_points: int = 32768


@dataclass(frozen=True)
class RansacConfig:
    """Batched RANSAC settings (the monocular initialiser reads
    ``init_iterations`` and ``init_sigma``)."""

    pnp_iterations: int = 300
    pnp_min_inliers: int = 10
    pnp_chi2: float = 5.991
    sim3_iterations: int = 300
    init_iterations: int = 200
    init_sigma: float = 1.0
    homography_model_threshold: float = 0.40


@dataclass(frozen=True)
class DetectorConfig:
    """YOLOv5 detector settings (yolov5s compound scaling by default)."""

    conf_threshold: float = 0.3
    iou_threshold: float = 0.45
    max_detections: int = 16
    input_size: int = 640
    depth_multiple: float = 0.33
    width_multiple: float = 0.50
    num_classes: int = 80


@dataclass(frozen=True)
class SystemConfig:
    """The sections of the system configuration that this port reads."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    dynamic: DynamicConfig = field(default_factory=DynamicConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    map: MapConfig = field(default_factory=MapConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    sensor: str = "rgbd"
    use_dynamic_filtering: bool = True

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def _build(cls, data: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in data.items() if k in names}
    return cls(**kw)


_SECTIONS = {
    "camera": CameraConfig, "orb": OrbConfig, "dynamic": DynamicConfig,
    "matcher": MatcherConfig, "optimizer": OptimizerConfig,
    "tracking": TrackingConfig, "mapping": MappingConfig,
    "loop": LoopConfig, "map": MapConfig,
    "ransac": RansacConfig, "detector": DetectorConfig,
}


def config_from_dict(d: dict) -> SystemConfig:
    """Build a SystemConfig from a nested dict such as
    ``dataclasses.asdict`` of the JAX package's configuration."""
    kw = {k: _build(cls, d[k]) for k, cls in _SECTIONS.items() if k in d}
    for k in ("sensor", "use_dynamic_filtering"):
        if k in d:
            kw[k] = d[k]
    return SystemConfig(**kw)
