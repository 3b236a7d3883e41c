"""Device ms per frame of the kernels launched inside ``match_stereo``."""


def read(run):
    if not run.on_device:
        return None
    s = run.spans.get("stereo_match")
    return s["device_ms"] / run.frames if s and s["calls"] else None
