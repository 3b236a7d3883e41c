"""The share of the window in which no device operation of any session
ran, in % (the union of all sessions' operations on one clock)."""


def read(run):
    if not run.on_device:
        return None
    if not run.traced or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
