"""Bytes the feature stage uploaded a view, in MB (1e6): the h2d_bytes of
the program's spans in the traced window (features.upload,
sift.pyramid.constants, sift.descriptors.constants; portbench/spans.py)."""

from portbench import spans


def read(run):
    s = spans.split(run)
    return None if s is None else s.bytes_per_image("h2d_bytes") / 1e6
