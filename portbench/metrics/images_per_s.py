"""Views extracted by extract_stage over the window's wall time (host clock)."""


def read(run):
    n = run.counts.get("images")
    return n / run.window_s if n else None
