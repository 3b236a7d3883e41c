"""The FAST kernel's share of its roofline: launches times the bound of
one launch (``counts.fast_seconds``: bytes at 3.35 TB/s, operations at
67 TFLOP/s) over the kernel's traced device time, in %."""


def read(run):
    # The profiler names it "void (anonymous namespace)::fast_kernel<true>(
    # float const*, ...)": its signature, return type first.
    hits = [v for k, v in run.by_name.items() if "fast_kernel" in k]
    c, ns = sum(h[0] for h in hits), sum(h[1] for h in hits)
    return 100.0 * c * run.fast_bound_s / (ns / 1e9) if c and ns else None
