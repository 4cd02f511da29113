"""Stage artifact store (copy of sfm_tpu/scene/artifacts.py; numpy only):
the checkpoint/resume contract.

Each stage's output is an npz keyed in a manifest by (config hash, input
hash); `pipeline.run` skips stages whose key matches. The npz keys, dtypes
and manifest are sfm_tpu's, and config.stage_config_hash is the same
function, so a store written by either package resumes in the other
(tests/test_torch_artifacts_export.py).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from sfm_tpu_torch.pipeline.stages import FeatureSet, MatchGraph
from sfm_tpu_torch.scene.state import Reconstruction


class ArtifactStore:
    """writable False: a reader of a store another process writes (the
    processes of a multi-device run other than local rank 0); save() only
    records the key in this process's manifest, so the stages it saved are
    complete for this process too."""

    def __init__(self, root: str, writable: bool = True):
        self.root = root
        self.writable = writable
        os.makedirs(root, exist_ok=True)
        self.manifest_path = os.path.join(root, "manifest.json")
        self.manifest = {}
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                self.manifest = json.load(f)

    def _flush(self):
        if not self.writable:
            return
        with open(self.manifest_path, "w") as f:
            json.dump(self.manifest, f, indent=2)

    def is_complete(self, stage: str, key: str) -> bool:
        return self.manifest.get(stage) == key and os.path.exists(self._path(stage))

    def _path(self, stage: str) -> str:
        return os.path.join(self.root, f"{stage}.npz")

    def save(self, stage: str, key: str, arrays: dict) -> None:
        if self.writable:
            np.savez_compressed(self._path(stage), **arrays)
        self.manifest[stage] = key
        self._flush()

    def load(self, stage: str) -> dict:
        with np.load(self._path(stage), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    # Typed helpers -------------------------------------------------------
    def save_features(self, key: str, f: FeatureSet):
        self.save("features", key, dict(xy=f.xy, sigma=f.sigma, angle=f.angle,
                                        response=f.response, desc=f.desc, valid=f.valid))

    def load_features(self) -> FeatureSet:
        return FeatureSet(**self.load("features"))

    def save_graph(self, key: str, g: MatchGraph):
        d = dict(pairs=g.pairs, idx_i=g.idx_i, idx_j=g.idx_j,
                 inlier=g.inlier, num_inliers=g.num_inliers,
                 num_h_inliers=g.num_h_inliers, rvec=g.rvec,
                 tvec=g.tvec, ok=g.ok)
        if g.pose_ok is not None:
            d["pose_ok"] = g.pose_ok
        self.save("matches", key, d)

    def load_graph(self) -> MatchGraph:
        return MatchGraph(**self.load("matches"))

    def save_reconstruction(self, key: str, rec: Reconstruction, stage: str = "reconstruction"):
        self.save(stage, key, dict(
            intrinsics=rec.intrinsics, rvecs=rec.rvecs, tvecs=rec.tvecs,
            registered=rec.registered, points=rec.points,
            point_errors=rec.point_errors, point_valid=rec.point_valid,
            obs_point=rec.obs_point, obs_image=rec.obs_image,
            obs_kp=rec.obs_kp, obs_uv=rec.obs_uv,
        ))

    def load_reconstruction(self, stage: str = "reconstruction") -> Reconstruction:
        return Reconstruction(**self.load(stage))


def path_hash(paths: list) -> str:
    """Input hash for the streaming path: names + file sizes + mtimes."""
    h = hashlib.sha256()
    for p in paths:
        st = os.stat(p)
        h.update(f"{p}:{st.st_size}:{int(st.st_mtime)}".encode())
    return h.hexdigest()[:16]


def input_hash(canvases: np.ndarray, names: list) -> str:
    h = hashlib.sha256()
    h.update(str(list(names)).encode())
    h.update(np.ascontiguousarray(canvases[:, ::16, ::16]).tobytes())  # subsampled content digest
    h.update(str(canvases.shape).encode())
    return h.hexdigest()[:16]
