"""Device ms per frame of the kernels launched inside ``process_rgbd`` /
``process_stereo`` (the front end: pyramid, FAST, selection, BRIEF)."""


def read(run):
    if not run.on_device:
        return None
    s = run.spans.get("extract")
    return s["device_ms"] / run.frames if s and s["calls"] else None
