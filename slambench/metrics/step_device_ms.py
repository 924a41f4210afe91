"""step_device_ms: device busy time in the traced window (the profiler's
operations, overlaps merged) over the dispatches completed in it."""


def read(run):
    if run.steps == 0 or run.trace.busy_s <= 0:
        return None
    return run.trace.busy_s * 1e3 / run.steps
