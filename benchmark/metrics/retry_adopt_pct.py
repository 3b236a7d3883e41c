"""The share of tracking's widened retry (stage 1, run every frame) whose
result was adopted, in %: frames with stage 0 under 30 inliers and stage 1
above it, over the frames tracked, from the port's device counters in a
run that carries the program's window (``slambench.program``)."""


def read(run):
    prog = getattr(run, "program", None)
    row = (prog or {}).get("device_counters", {}).get("tracking")
    if not row or not row["rows"]:
        return None
    return 100.0 * row["retry_adopted"] / row["rows"]
