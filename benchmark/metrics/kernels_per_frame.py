"""Device operations (kernels, copies, fills) launched per frame."""


def read(run):
    if not run.on_device:
        return None
    return run.kernels / run.frames if run.traced and run.frames else None
