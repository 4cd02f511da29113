"""Device events (kernels, copies, fills) the profiler recorded in the
traced window per view extracted in it."""


def read(run):
    n = run.counts.get("images")
    if run.trace is None or not n or not run.trace.device:
        return None
    return len(run.trace.device) / n
