"""Device time a view of the events inside the program's sift.pyramid spans:
the Gaussian pyramid's build, the upload of its blur stacks (span
sift.pyramid.constants) included, and each octave's gradients
(portbench/spans.py)."""

from portbench import spans


def read(run):
    s = spans.split(run)
    return None if s is None else s.device_ms_per_image("sift.pyramid")
