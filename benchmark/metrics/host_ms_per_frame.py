"""Host milliseconds of one ``track``/``track_stereo`` call, averaged over
every frame of every session (the host loop, ``RealtimeSlam._step``)."""


def read(run):
    return sum(run.host_ms) / len(run.host_ms) if run.host_ms else None
