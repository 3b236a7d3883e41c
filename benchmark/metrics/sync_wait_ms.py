"""Host ms per frame spent in the statements that read a device value to
the host (the port's ``read:<site>`` spans), in a run that carries the
program's spans (``slambench.program``)."""


def read(run):
    from slambench.program import span_ms
    ms = span_ms(run, lambda name: name.startswith("read:"))
    return ms / run.frames if ms is not None and run.frames else None
