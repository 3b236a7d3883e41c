"""Configuration of the ported paths.

The port keeps its own copy of the dataclasses this slice reads, with the
same field names and defaults as the JAX package's ``config.py``.
``config_from_dict`` builds a ``SystemConfig`` from ``dataclasses.asdict``
of the JAX package's configuration, so both packages can be started from
one configuration. Sections and fields this package does not read are
ignored.

``load_config`` reads a settings file as the JAX package's does: the
reference's cv::FileStorage files (a ``%YAML`` header, flat ``Camera.fx``
keys, ``key:value`` with no space) or this package's nested schema. The
JAX package parses the nested schema with PyYAML; this package reads the
part of YAML that a ``SystemConfig`` can hold with a parser of its own
(``_parse_yaml``): block mappings two levels deep, block or flow
sequences and flow mappings, and scalars resolved as PyYAML's safe loader
resolves them (null, bool, decimal int and float, plain strings, quoted
strings with the basic escapes). Anything else raises with its line,
other number forms too (octal, hex, ``1e5``).
"""
from __future__ import annotations

import dataclasses
import re
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

    @property
    def scale_factors(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))


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
class VocabularyConfig:
    """BoW vocabulary shape and scoring (DBoW2's settings)."""

    branching_factor: int = 10
    depth: int = 6
    # Feature-vector grouping: nodes 4 levels up from the leaves.
    feature_level: int = 4
    weighting: str = "tf-idf"
    scoring: str = "l1"


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
    vocabulary: VocabularyConfig = field(default_factory=VocabularyConfig)
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
    "loop": LoopConfig, "map": MapConfig, "vocabulary": VocabularyConfig,
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


# --------------------------------------------------------------------- #
# Settings files

class ConfigError(ValueError):
    """A settings file this loader does not read, with its line."""


_BOOLS = {"yes": True, "true": True, "on": True,
          "no": False, "false": False, "off": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# What PyYAML reads as another number form (octal, hex, binary, base 60,
# '_' separators) or, like 1e5 and -.5, as a string: not read here.
_NUMBER_LIKE = re.compile(r"[-+]?\.?[0-9]")


def _plain(text: str, where: str):
    """A plain scalar: null, bool, decimal int or float, resolved as
    PyYAML's safe loader resolves them, or a string."""
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text.lower() in _BOOLS and text in (text.lower(), text.upper(),
                                           text.capitalize()):
        return _BOOLS[text.lower()]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        v = text.lower()
        if v.lstrip("+-") == ".inf":
            return float("-inf") if v[0] == "-" else float("inf")
        if v == ".nan":
            return float("nan")
        return float(v)
    if _NUMBER_LIKE.match(text):
        raise ConfigError(f"{where}: {text!r} is not a decimal int or float")
    if text[0] in "&*!|>@`%":
        raise ConfigError(f"{where}: {text!r} (anchors, aliases, tags and "
                          "block scalars are not read)")
    return text


def _quoted(s: str, pos: int, where: str):
    """The quoted scalar that starts at s[pos]; returns (value, end)."""
    q = s[pos]
    out = []
    i = pos + 1
    while i < len(s):
        ch = s[i]
        if q == "'" and ch == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = s[i + 1:i + 2]
            table = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/",
                     "0": "\0", " ": " "}
            if esc in table:
                out.append(table[esc])
                i += 2
                continue
            raise ConfigError(f"{where}: escape \\{esc} is not read")
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise ConfigError(f"{where}: unterminated quoted scalar")


def _flow(s: str, pos: int, where: str):
    """The flow node (collection or scalar) at s[pos]; returns (value,
    end)."""
    while pos < len(s) and s[pos] == " ":
        pos += 1
    if pos >= len(s):
        raise ConfigError(f"{where}: unexpected end of a flow collection")
    ch = s[pos]
    if ch in "[{":
        close = "]" if ch == "[" else "}"
        out = [] if ch == "[" else {}
        pos += 1
        while True:
            while pos < len(s) and s[pos] == " ":
                pos += 1
            if pos < len(s) and s[pos] == close:
                return out, pos + 1
            item, pos = _flow(s, pos, where)
            while pos < len(s) and s[pos] == " ":
                pos += 1
            if ch == "{":
                if pos >= len(s) or s[pos] != ":":
                    raise ConfigError(f"{where}: a flow mapping entry "
                                      "needs 'key: value'")
                value, pos = _flow(s, pos + 1, where)
                out[item] = value
                while pos < len(s) and s[pos] == " ":
                    pos += 1
            else:
                out.append(item)
            if pos < len(s) and s[pos] == ",":
                pos += 1
            elif pos < len(s) and s[pos] == close:
                return out, pos + 1
            else:
                raise ConfigError(f"{where}: expected ',' or {close!r} in "
                                  "a flow collection")
    if ch in "'\"":
        return _quoted(s, pos, where)
    end = pos
    while end < len(s):
        c = s[end]
        if c in ",[]{}" or (c == ":" and (end + 1 == len(s)
                                          or s[end + 1] in " ,[]{}")):
            break
        end += 1
    return _plain(s[pos:end].strip(), where), end


def _strip_comment(line: str) -> str:
    """The line without its comment (a '#' at its start or after a blank,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _quoted_all(text: str, where: str):
    """``text``, a quoted scalar and nothing after it."""
    value, end = _quoted(text, 0, where)
    if text[end:].strip():
        raise ConfigError(f"{where}: text after a quoted scalar")
    return value


def _split_key(content: str, where: str):
    """'key: value' or 'key:' -> (key, value text), or None when the line
    is not a mapping entry (a quoted scalar: quoted keys are not read)."""
    if content[0] in "'\"":
        return None
    m = re.match(r"(.*?):(?:\s+|$)(.*)$", content)
    if m is None:
        return None
    return _plain(m.group(1).strip(), where), m.group(2).strip()


def _parse_yaml(text: str, path: str = "<string>"):
    """The YAML subset of a nested settings file (see the module's
    docstring)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ConfigError(f"{path}:{n}: tab in indentation")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        if body.startswith("%") or body in ("---", "..."):
            if lines or body == "...":
                raise ConfigError(f"{path}:{n}: one document only")
            continue
        lines.append((n, len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None

    def flow_text(i, first):
        """The flow collection starting on line i with ``first``, joined
        over the lines it spans; returns (value, next line)."""
        parts = [first]
        j = i
        while True:
            where = f"{path}:{lines[i][0]}"
            try:
                value, end = _flow(" ".join(parts), 0, where)
            except ConfigError:
                if j + 1 >= len(lines):
                    raise
                j += 1
                parts.append(lines[j][2])
                continue
            if " ".join(parts)[end:].strip():
                raise ConfigError(f"{where}: text after a flow collection")
            return value, j + 1

    def node(i, indent):
        """The block node whose first line is lines[i] at ``indent``."""
        n, ind, content = lines[i]
        if content[0] in "[{":
            return flow_text(i, content)
        if content.startswith("- ") or content == "-":
            return sequence(i, ind)
        if _split_key(content, f"{path}:{n}") is not None:
            return mapping(i, ind)
        if content[0] in "'\"":
            return _quoted_all(content, f"{path}:{n}"), i + 1
        return _plain(content, f"{path}:{n}"), i + 1

    def sequence(i, indent):
        out = []
        while i < len(lines) and lines[i][1] == indent \
                and (lines[i][2].startswith("- ") or lines[i][2] == "-"):
            n, _, content = lines[i]
            item = content[1:].strip()
            where = f"{path}:{n}"
            if item and (item[0] in "-" or _split_key(item, where)):
                raise ConfigError(f"{where}: nested collections in a block "
                                  "sequence are not read")
            if item[:1] in "[{" and item:
                value, i = flow_text(i, item)
            elif item[:1] in "'\"" and item:
                value = _quoted_all(item, where)
                i += 1
            else:
                value = _plain(item, where)
                i += 1
            out.append(value)
        return out, i

    def mapping(i, indent):
        out = {}
        while i < len(lines) and lines[i][1] == indent:
            n, _, content = lines[i]
            where = f"{path}:{n}"
            kv = _split_key(content, where)
            if kv is None:
                raise ConfigError(f"{where}: expected 'key: value'")
            key, value = kv
            if key in out:
                raise ConfigError(f"{where}: duplicate key {key!r}")
            if value:
                if value[0] in "[{":
                    out[key], i = flow_text(i, value)
                elif value[0] in "'\"":
                    out[key] = _quoted_all(value, where)
                    i += 1
                else:
                    out[key] = _plain(value, where)
                    i += 1
                continue
            i += 1
            if i < len(lines) and (lines[i][1] > indent or (
                    lines[i][1] == indent and lines[i][2][:1] == "-")):
                out[key], i = node(i, lines[i][1])
            else:
                out[key] = None
        if i < len(lines) and lines[i][1] > indent:
            raise ConfigError(f"{path}:{lines[i][0]}: bad indentation")
        return out, i

    value, i = node(0, lines[0][1])
    if i < len(lines):
        raise ConfigError(f"{path}:{lines[i][0]}: bad indentation")
    return value


def load_config(path: str) -> SystemConfig:
    """Load a SystemConfig from a settings file.

    Accepts either the nested schema (sections named after the
    SystemConfig fields) or the reference's flat cv::FileStorage key style
    (``Camera.fx``, ``ORBextractor.nFeatures``, ...), so the reference's
    Examples/RGB-D/*.yaml settings can be read directly.
    """
    with open(path) as f:
        text = f.read()
    if text.startswith("%YAML"):
        # cv::FileStorage files begin with a %YAML directive, use "---"
        # documents, and tolerate "key:value" with no space after the
        # colon: parse flat key/value lines directly.
        data = {}
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or line == "---":
                continue
            if ":" not in line:
                continue
            key, _, value = line.partition(":")
            value = value.strip()
            try:
                data[key.strip()] = float(value) if "." in value \
                    or "e" in value else int(value)
            except ValueError:
                data[key.strip()] = value
    else:
        data = _parse_yaml(text, path) or {}
        if not isinstance(data, dict):
            raise ConfigError(f"{path}: the settings are not a mapping")

    if any("." in k for k in data):
        return _from_filestorage(data)

    kwargs = {}
    for key, cls in _SECTIONS.items():
        if key in data:
            kwargs[key] = _build(cls, data[key])
    for key in ("sensor", "use_dynamic_filtering"):
        if key in data:
            kwargs[key] = data[key]
    return SystemConfig(**kwargs)


def _from_filestorage(data: dict) -> SystemConfig:
    """Map reference-style flat keys onto SystemConfig."""
    cam_map = {
        "Camera.fx": "fx", "Camera.fy": "fy", "Camera.cx": "cx",
        "Camera.cy": "cy", "Camera.k1": "k1", "Camera.k2": "k2",
        "Camera.p1": "p1", "Camera.p2": "p2", "Camera.k3": "k3",
        "Camera.width": "width", "Camera.height": "height",
        "Camera.fps": "fps", "Camera.bf": "bf", "ThDepth": "th_depth",
        "DepthMapFactor": "depth_map_factor", "Camera.RGB": "rgb_order",
    }
    orb_map = {
        "ORBextractor.nFeatures": "n_features",
        "ORBextractor.scaleFactor": "scale_factor",
        "ORBextractor.nLevels": "n_levels",
        "ORBextractor.iniThFAST": "fast_threshold_init",
        "ORBextractor.minThFAST": "fast_threshold_min",
    }
    cam = {v: data[k] for k, v in cam_map.items() if k in data}
    orb = {v: data[k] for k, v in orb_map.items() if k in data}
    if "width" in cam:
        cam["width"] = int(cam["width"])
    if "height" in cam:
        cam["height"] = int(cam["height"])
    for int_key in ("n_features", "n_levels", "fast_threshold_init",
                    "fast_threshold_min"):
        if int_key in orb:
            orb[int_key] = int(orb[int_key])
    return SystemConfig(camera=_build(CameraConfig, cam),
                        orb=_build(OrbConfig, orb))


DEFAULT_CONFIG = SystemConfig()
