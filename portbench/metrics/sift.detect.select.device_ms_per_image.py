"""Device time a view of the events inside the program's sift.detect.select
spans: each octave's candidate selection, kernel K15's radix select over
the score maps and the sort of the k keys it selects a map
(portbench/spans.py). None for a program without the span."""

from portbench import spans

NAME = "sift.detect.select"


def read(run):
    s = spans.split(run)
    if s is None or not any(x.name == NAME for x in s.spans.values()):
        return None
    return s.device_ms_per_image(NAME)
