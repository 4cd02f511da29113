"""Device time a view of the events inside the program's sift.orientation
spans: orientation assignment of each octave, with the second-orientation
duplicates (portbench/spans.py)."""

from portbench import spans


def read(run):
    s = spans.split(run)
    return None if s is None else s.device_ms_per_image("sift.orientation")
