"""Device ms per ``detect_device`` call (resize, YOLOv5s, decode, NMS)."""


def read(run):
    if not run.on_device:
        return None
    s = run.spans.get("detect")
    return s["device_ms"] / s["calls"] if s and s["calls"] else None
