"""Host ms per frame spent inside ``fused_step``."""


def read(run):
    s = run.spans.get("track")
    return s["host_ms"] / run.frames if s and s["calls"] else None
