"""Track building: union-find over verified matches (port of
sfm_tpu/scene/tracks.py, numpy only).

Host-side: the graph is small (O(total keypoints)), the work is irregular
pointer-chasing, and it runs once per reconstruction. Tracks touching one
image twice are rejected. ``build_tracks`` runs the native C++ builder
(sfm_tpu_torch/native); ``build_tracks_python`` is its plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from sfm_tpu_torch.pipeline.stages import MatchGraph


@dataclass
class TrackSet:
    """Track t spans observations rows [track_start[t], track_start[t+1])."""

    # Per-observation, sorted by track id.
    obs_image: np.ndarray   # [O] int32
    obs_kp: np.ndarray      # [O] int32
    track_id: np.ndarray    # [O] int32
    num_tracks: int

    def lengths(self) -> np.ndarray:
        return np.bincount(self.track_id, minlength=self.num_tracks)


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, i: int) -> int:
        root = i
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[i] != root:  # path compression
            self.parent[i], i = root, self.parent[i]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(graph: MatchGraph, num_images: int, max_kp: int, min_length: int = 2) -> TrackSet:
    """Union-find over inlier correspondences of verified edges, by the
    native C++ builder (a failed build raises)."""
    from sfm_tpu_torch.native import get_lib

    lib = get_lib()
    pairs = np.ascontiguousarray(graph.pairs, dtype=np.int32)
    ok = np.ascontiguousarray(graph.ok, dtype=np.uint8)
    idx_i = np.ascontiguousarray(graph.idx_i, dtype=np.int32)
    idx_j = np.ascontiguousarray(graph.idx_j, dtype=np.int32)
    inlier = np.ascontiguousarray(graph.inlier, dtype=np.uint8)
    E, M = idx_i.shape if idx_i.ndim == 2 else (0, 0)

    # The C++ side indexes touched[img * max_kp + kp] without bounds checks;
    # an out-of-range id from a malformed graph would corrupt the heap
    # silently. Validate the batch here in vectorized numpy.
    live = ok.astype(bool)[:, None] & inlier.astype(bool)
    if live.any():
        ki, kj = idx_i[live], idx_j[live]
        pi = pairs[live.any(axis=1)]
        if (ki.min() < 0 or kj.min() < 0
                or ki.max() >= max_kp or kj.max() >= max_kp
                or pi.min() < 0 or pi.max() >= num_images):
            raise ValueError(
                "build_tracks: graph indices out of range "
                f"(kp in [{min(ki.min(), kj.min())}, {max(ki.max(), kj.max())}] "
                f"vs max_kp={max_kp}; img in [{pi.min()}, {pi.max()}] "
                f"vs num_images={num_images})"
            )

    cap = int(inlier.sum()) * 2 + 16
    obs_image = np.empty(cap, np.int32)
    obs_kp = np.empty(cap, np.int32)
    track_id = np.empty(cap, np.int32)
    n_tracks = ctypes.c_int64(0)
    rows = lib.sfm_build_tracks(
        pairs.ctypes.data, ok.ctypes.data,
        idx_i.ctypes.data, idx_j.ctypes.data, inlier.ctypes.data,
        E, M, num_images, max_kp, min_length,
        obs_image.ctypes.data, obs_kp.ctypes.data, track_id.ctypes.data,
        cap, ctypes.byref(n_tracks),
    )
    if rows < 0:
        raise RuntimeError("native track builder: output capacity underestimated")
    return TrackSet(obs_image=obs_image[:rows].copy(), obs_kp=obs_kp[:rows].copy(),
                    track_id=track_id[:rows].copy(), num_tracks=int(n_tracks.value))


def build_tracks_python(graph: MatchGraph, num_images: int, max_kp: int, min_length: int = 2) -> TrackSet:
    """Plain pure-Python version of build_tracks (tests only)."""
    uf = _UnionFind(num_images * max_kp)

    def node(img, kp):
        return img * max_kp + kp

    touched = set()
    for e in range(len(graph.pairs)):
        if not graph.ok[e]:
            continue
        i, j = graph.pairs[e]
        inl = graph.inlier[e]
        for ki, kj in zip(graph.idx_i[e][inl], graph.idx_j[e][inl]):
            uf.union(node(i, int(ki)), node(j, int(kj)))
            touched.add(node(i, int(ki)))
            touched.add(node(j, int(kj)))

    comp: dict[int, list[int]] = {}
    for n in touched:
        comp.setdefault(uf.find(n), []).append(n)

    obs_image, obs_kp, track_id = [], [], []
    tid = 0
    for nodes in comp.values():
        if len(nodes) < min_length:
            continue
        imgs = [n // max_kp for n in nodes]
        if len(set(imgs)) != len(imgs):
            continue  # track visits an image twice -> inconsistent, drop
        for n in sorted(nodes):
            obs_image.append(n // max_kp)
            obs_kp.append(n % max_kp)
            track_id.append(tid)
        tid += 1

    return TrackSet(obs_image=np.asarray(obs_image, dtype=np.int32),
                    obs_kp=np.asarray(obs_kp, dtype=np.int32),
                    track_id=np.asarray(track_id, dtype=np.int32), num_tracks=tid)
