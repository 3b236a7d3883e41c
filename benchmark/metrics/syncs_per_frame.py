"""Host synchronisations per frame in the traced window, counted with
``torch.cuda.set_sync_debug_mode("warn")``."""


def read(run):
    return run.syncs / run.frames if run.traced and run.frames else None
