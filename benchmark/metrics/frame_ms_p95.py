"""The 95th percentile, over every frame of every session in the window,
of the time from hand-over to ``track`` to the frame's completion event
(its step and the maintenance dispatch after it), queue included."""


def read(run):
    from slambench.stats import percentile
    return percentile(run.frame_ms, 95) if run.frame_ms else None
