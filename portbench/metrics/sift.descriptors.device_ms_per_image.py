"""Device time a view of the events inside the program's sift.descriptors
spans: each octave's descriptors, the upload of their tables (span
sift.descriptors.constants) included, and the octave's output
(portbench/spans.py)."""

from portbench import spans


def read(run):
    s = spans.split(run)
    return None if s is None else s.device_ms_per_image("sift.descriptors")
