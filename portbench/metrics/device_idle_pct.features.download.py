"""Share of the traced window, in %, in which the device was idle while the
host was inside the program's features.download span (portbench/spans.py)."""

from portbench import spans


def read(run):
    s = spans.split(run)
    return None if s is None else s.idle_pct(lambda name: name == "features.download")
