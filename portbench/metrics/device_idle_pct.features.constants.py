"""Share of the traced window, in %, in which the device was idle while the
host was inside a span of constants built and uploaded on every call
(sift.pyramid.constants, sift.descriptors.constants; portbench/spans.py)."""

from portbench import spans


def read(run):
    s = spans.split(run)
    return None if s is None else s.idle_pct(lambda name: name.endswith(".constants"))
