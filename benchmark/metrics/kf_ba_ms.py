"""Device ms per frame of the kernels launched inside ``_create_keyframe``
(keyframe insertion and the windowed BA)."""


def read(run):
    if not run.on_device:
        return None
    s = run.spans.get("kf_ba")
    return s["device_ms"] / run.frames if s and s["calls"] else None
