"""``config.load_config`` of the port against the JAX package's on the same
files: a cv::FileStorage settings file in the style of the reference's
Examples/RGB-D/tum_bag.yaml (``%YAML:1.0``, ``---``, ``key:value`` with
and without a space, comments), and nested settings that
``yaml.safe_dump`` writes in block, flow and mixed styles (PyYAML serves
only to write them and as the JAX package's parser). Every field the port
holds must be equal (exact comparison of ``dataclasses.asdict``)."""
import dataclasses
import math

import pytest
import yaml

from coebslam_tpu import config as jcfg
from coebslam_tpu_torch import config as tcfg

FILESTORAGE = """%YAML:1.0
---
# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 517.306408
Camera.fy:516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989

Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1:-0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314

Camera.width: 640
Camera.height: 480

# Camera frames per second
Camera.fps: 30.0

# IR projector baseline times fx (aprox.)
Camera.bf: 40.0

# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1

# Close/Far threshold. Baseline times.
ThDepth: 40.0

# Deptmap values factor
DepthMapFactor: 1.0

# ORB Extractor: Number of features per image
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

Viewer.KeyFrameSize: 0.05
Viewer.ViewpointF: 500
"""


def _lists(x):
    """asdict with lists for tuples (PyYAML's safe dumper writes no
    tuple)."""
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_lists(v) for v in x]
    return x


def _nested():
    """A non-default configuration of every section, as a nested dict."""
    d = _lists(dataclasses.asdict(jcfg.SystemConfig()))
    d["camera"].update(fx=525.0, width=320, height=240, bf=1e-3)
    d["orb"].update(n_features=1500, n_levels=4, scale_factor=1.25)
    d["dynamic"].update(dynamic_classes=[0, 2, 15], motion_check="flow",
                        spawn_in_boxes=True)
    d["optimizer"] = {k: (v * 2 if isinstance(v, (int, float))
                          and not isinstance(v, bool) else v)
                      for k, v in d["optimizer"].items()}
    d["loop"]["min_score_factor"] = 0.75
    d["vocabulary"].update(depth=5, weighting="idf", scoring="l2")
    d["detector"]["conf_threshold"] = 0.25
    d["sensor"] = "stereo"
    d["use_dynamic_filtering"] = False
    return d


def _assert_equal(t, j):
    """Every field of the port's configuration equals the JAX one's."""
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    for sec, tsec in td.items():
        if isinstance(tsec, dict):
            assert tsec == {k: jd[sec][k] for k in tsec}, sec
        else:
            assert tsec == jd[sec], sec


def test_filestorage_matches(tmp_path):
    path = tmp_path / "tum_bag.yaml"
    path.write_text(FILESTORAGE)
    t, j = tcfg.load_config(str(path)), jcfg.load_config(str(path))
    _assert_equal(t, j)
    assert t.camera.fy == 516.469215 and t.camera.p1 == -0.005358
    assert t.camera.depth_map_factor == 1.0 and t.orb.n_levels == 8


STYLES = {"block": dict(default_flow_style=False),
          "flow": dict(default_flow_style=True),
          "mixed": dict(default_flow_style=None),
          "flow-narrow": dict(default_flow_style=True, width=30)}


@pytest.mark.parametrize("style", sorted(STYLES))
def test_nested_schema_matches(style, tmp_path):
    d = _nested()
    path = tmp_path / "settings.yaml"
    path.write_text(yaml.safe_dump(d, **STYLES[style]))
    t, j = tcfg.load_config(str(path)), jcfg.load_config(str(path))
    _assert_equal(t, j)
    assert t.dynamic.dynamic_classes == (0, 2, 15)
    assert t.vocabulary.weighting == "idf" and t.sensor == "stereo"
    assert t.use_dynamic_filtering is False


def test_partial_file_with_comments_and_quotes(tmp_path):
    text = """# partial settings: other fields keep their defaults
camera:
  fx: 500.0   # focal length
  cx: '320.5'
orb: {n_features: 800, n_levels: 6}
dynamic:
  dynamic_classes: [0, 1]
  motion_check: "flow"
sensor: monocular
"""
    path = tmp_path / "partial.yaml"
    path.write_text(text)
    t, j = tcfg.load_config(str(path)), jcfg.load_config(str(path))
    _assert_equal(t, j)
    assert t.camera.cx == "320.5"          # a quoted number stays a string


@pytest.mark.parametrize("text", [
    "a: 1\nb: [x, y]\nc: {p: 1.5e-3, q: ~}\nd:\n- yes\n- Off\n- 7\n",
    "a: 'it''s'\nb: \"tab\\there\"\nc: 0\nd: 1.0e+5\ne: -.inf\nf: .5\n",
    "a:\n  b:\n  - 1\n  - two\n  c: null\n",
])
def test_scalar_resolution_follows_pyyaml(text):
    got = tcfg._parse_yaml(text)
    want = yaml.safe_load(text)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float) and math.isinf(want[k]):
            assert got[k] == want[k]
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("text,where", [
    ("a:\n  - b: 1\n", ":2"),               # mapping inside a sequence
    ("a: &x 1\n", ":1"),                     # anchors
    ("a: |\n  text\n", ":1"),                # block scalar
    ("a: [1, 2\n", ":1"),                    # unclosed flow
    ("a: 1\n  b: 2\n", ":2"),                # bad indentation
    ("a: 1\nb: 0x1f\n", ":2"),               # number forms other than
    ("a: [1, 017]\n", ":1"),                 # decimal int and float
    ("a: 1e5\nb: -.5\n", ":1"),
    ("a: \"\\x41\"\n", ":1"),                # escapes beyond the basic
    ("'a': 1\n", ":1"),                     # quoted keys
])
def test_unsupported_yaml_raises_with_the_line(text, where, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(tcfg.ConfigError, match=where):
        tcfg.load_config(str(path))


def test_vocabulary_section_defaults():
    assert dataclasses.asdict(tcfg.VocabularyConfig()) \
        == dataclasses.asdict(jcfg.VocabularyConfig())
