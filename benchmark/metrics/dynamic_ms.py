"""Device ms per frame of the kernels launched inside ``dynamic_step``."""


def read(run):
    if not run.on_device:
        return None
    s = run.spans.get("dynamic")
    return s["device_ms"] / run.frames if s and s["calls"] else None
