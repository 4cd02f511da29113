"""Device time a view of the events inside the program's sift.detect spans:
K1's scores, candidate selection, refinement and compaction of each octave,
and the final cross-octave selection (portbench/spans.py)."""

from portbench import spans


def read(run):
    s = spans.split(run)
    return None if s is None else s.device_ms_per_image("sift.detect")
