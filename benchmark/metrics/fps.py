"""Frames completed by all sessions in the window, over the window's
seconds (start signal to the end of the drain): what the fleet server
sustains."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
