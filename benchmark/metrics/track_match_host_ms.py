"""Host ms per frame in tracking's projection and Hamming matching (the
port's ``hamming`` spans, four a frame), in a run that carries the
program's spans (``slambench.program``)."""


def read(run):
    from slambench.program import span_ms
    ms = span_ms(run, "hamming")
    return ms / run.frames if ms is not None and run.frames else None
