"""Device time (every kernel, copy and fill the profiler recorded in the
traced window) per view extracted in it."""


def read(run):
    n = run.counts.get("images")
    if run.trace is None or not n or not run.trace.device:
        return None
    return sum(e - s for _, s, e in run.trace.device) * 1e-6 / n
