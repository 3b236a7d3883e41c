"""Device ms per frame of the kernels launched inside ``fused_step``
(tracking's four stages of match and pose solve)."""


def read(run):
    if not run.on_device:
        return None
    s = run.spans.get("track")
    return s["device_ms"] / run.frames if s and s["calls"] else None
