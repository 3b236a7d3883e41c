"""Host ms per frame in tracking's pose Gauss-Newton solves (the port's
``pose_gn`` spans, four a frame), in a run that carries the program's
spans (``slambench.program``)."""


def read(run):
    from slambench.program import span_ms
    ms = span_ms(run, "pose_gn")
    return ms / run.frames if ms is not None and run.frames else None
