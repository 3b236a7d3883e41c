"""The whole step's share of the chip's peak, in %: the least time of one
frame's counted work (``counts.frame_least_seconds``: YOLOv5s at the
fp32 peak, the Hamming products at the bf16 peak, FAST at its
roofline) times the frames completed, over the window's seconds on the
host's clock. Per-layer metrics are read in the traced run, whose window
completes fewer frames than an untraced one."""


def read(run):
    if not run.on_device:
        return None
    if not run.frames or run.window_s <= 0:
        return None
    return 100.0 * sum(run.least_s.values()) * run.frames / run.window_s
