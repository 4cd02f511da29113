"""Numpy interop with the JAX package, for tests that feed both packages the
same inputs at a stage boundary.

``from_numpy_*`` builds a port structure from any object carrying the same
field names with array values (a JAX-package structure, a dict, ...), each
field taken through ``np.asarray``; ``to_numpy`` turns a port structure or
tensor back into numpy (structures become dicts keyed by field name).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sfm_tpu_torch.ba.problem import BAProblem
from sfm_tpu_torch.ops.sift import Features
from sfm_tpu_torch.pipeline.stages import FeatureSet, MatchGraph
from sfm_tpu_torch.scene.state import Reconstruction
from sfm_tpu_torch.scene.tracks import TrackSet


def _fields(cls) -> list[str]:
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(cls._fields)


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _arrays(cls, src, names=None) -> dict:
    out = {}
    for name in names or _fields(cls):
        v = _get(src, name)
        out[name] = None if v is None else np.asarray(v)
    return out


def from_numpy_features(src, device="cpu") -> Features:
    """Device-side per-image features (the output of ops.sift.extract_features)."""
    return Features(**{k: torch.from_numpy(np.array(v)).to(device)
                       for k, v in _arrays(Features, src).items()})


def from_numpy_feature_set(src) -> FeatureSet:
    return FeatureSet(**_arrays(FeatureSet, src))


def from_numpy_graph(src) -> MatchGraph:
    return MatchGraph(**_arrays(MatchGraph, src))


def from_numpy_problem(src, device="cpu") -> BAProblem:
    """BAProblem on `device`; point_align is taken as an int."""
    names = [n for n in _fields(BAProblem) if n != "point_align"]
    arrays = {k: torch.from_numpy(np.array(v)).to(device)
              for k, v in _arrays(BAProblem, src, names).items()}
    return BAProblem(**arrays, point_align=int(_get(src, "point_align")))


def from_numpy_tracks(src) -> TrackSet:
    """TrackSet; num_tracks is taken as an int."""
    arrays = _arrays(TrackSet, src, ["obs_image", "obs_kp", "track_id"])
    return TrackSet(**arrays, num_tracks=int(_get(src, "num_tracks")))


def from_numpy_reconstruction(src) -> Reconstruction:
    names = [n for n in _fields(Reconstruction) if n not in ("image_names", "stage_seconds")]
    rec = Reconstruction(**_arrays(Reconstruction, src, names))
    rec.image_names = list(_get(src, "image_names") or [])
    return rec


def to_numpy(obj):
    """Tensor -> ndarray; port structure -> {field: ndarray}; else unchanged."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy(v) for k, v in zip(obj._fields, obj)}
    return obj
