"""The largest session's ``torch.cuda.max_memory_allocated`` over its
set-up and the window, in MiB: how many robots fit on one card."""


def read(run):
    return run.peak_bytes / 2 ** 20 if run.peak_bytes else None
