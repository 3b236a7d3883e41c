"""The 95th percentile of the host ms of one maintenance dispatch
(``Maintainer.step``) over the dispatches in the window."""


def read(run):
    from slambench.stats import percentile
    return percentile(run.maint_host_ms, 95) if run.maint_host_ms else None
