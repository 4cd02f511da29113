"""pipeline/merge.py of sfm_tpu_torch against sfm_tpu's (numpy on the host).

Every case builds its inputs twice from a seed (the functions mutate their
reconstruction), runs sfm_tpu's function on one copy and the port's on the
other, and compares what they return and what they left in the
reconstruction. Tolerances: integer and boolean arrays (index sets, ids,
masks) equal; floats to 1e-5 of the array's max |value| (the three rotation
helpers run in torch here and in JAX there; everything else is the same
numpy).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.pipeline import merge as jmerge
from sfm_tpu.pipeline.stages import MatchGraph as JMatchGraph
from sfm_tpu.scene.state import Reconstruction as JReconstruction
from sfm_tpu.utils.synthetic import _np_rodrigues, make_orbit_scene
from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.pipeline import merge
from sfm_tpu_torch.scene.state import Reconstruction
from sfm_tpu_torch.utils.interop import from_numpy_graph, from_numpy_reconstruction
from tests.unit.test_ba import scene_to_reconstruction
from tests.unit.test_merge import _mock_graph

torch.set_num_threads(2)


def to_port(x):
    """sfm_tpu's host structures as the port's; anything else unchanged."""
    if isinstance(x, JReconstruction):
        return from_numpy_reconstruction(x)
    if isinstance(x, JMatchGraph):
        return from_numpy_graph(x)
    if isinstance(x, JPipelineConfig):
        return PipelineConfig()
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    return x


def assert_same(a, b, what="", tol=1e-5):
    """a (sfm_tpu's) and b (the port's): same structure, equal index arrays,
    floats within tol of the array's max."""
    if isinstance(a, (JReconstruction, Reconstruction)):
        for f in dataclasses.fields(JReconstruction):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}", tol)
        return
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if dataclasses.is_dataclass(a) or isinstance(a, (types.SimpleNamespace, set)):
        return      # graphs, features and configs: inputs that no function writes
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]", tol)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    if a.dtype.kind in "biuUSO":
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        fin = np.isfinite(a)
        np.testing.assert_array_equal(fin, np.isfinite(b), err_msg=what)
        scale = max(float(np.abs(a[fin]).max()) if fin.any() else 0.0, 1e-12)
        np.testing.assert_allclose(b[fin] / scale, a[fin] / scale, atol=tol, err_msg=what)


def run_both(name, build, jmod=jmerge, tmod=merge, tol=1e-5, **tkw):
    """Call jmod.name on build()'s arguments and tmod.name on a second
    build()'s (converted, plus the port-only keywords), compare results and
    the arguments afterwards; returns the port's result."""
    jargs, jkw = build()
    targs, tkw0 = build()
    targs, tkw0 = to_port(targs), {k: to_port(v) for k, v in tkw0.items()}
    jout = getattr(jmod, name)(*jargs, **jkw)
    tout = getattr(tmod, name)(*targs, **tkw0, **tkw)
    assert_same(jout, tout, f"{name} ->", tol)
    assert_same(list(jargs), list(targs), f"{name} args", tol)
    return tout


def restricted(scene, cams, point_noise=0.0, seed=0):
    rec = scene_to_reconstruction(scene, point_noise=point_noise, seed=seed)
    keep_cam = np.zeros(scene.num_cameras, bool)
    keep_cam[np.asarray(cams) % scene.num_cameras] = True
    rec.registered = keep_cam
    sel = keep_cam[rec.obs_image]
    for f in ("obs_point", "obs_image", "obs_kp", "obs_uv"):
        setattr(rec, f, getattr(rec, f)[sel])
    rec.point_valid = np.bincount(rec.obs_point, minlength=len(rec.points)) >= 2
    return rec


def arc_clusters(point_noise=0.0):
    """Four overlapping arcs of a 24-camera orbit, each in its own gauge and
    with its own error in the points (so that alignment residuals are real
    numbers, not rounding)."""
    scene = make_orbit_scene(num_cameras=24, num_points=120, noise_px=0.0, seed=33)
    rng = np.random.default_rng(5)
    recs = []
    for k, arc in enumerate((range(0, 9), range(6, 15), range(12, 21), range(18, 27))):
        s, R, t = float(rng.uniform(0.5, 2.0)), _np_rodrigues(rng.normal(0, 0.3, 3)), rng.normal(0, 2.0, 3)
        recs.append(jmerge.apply_sim3_to_reconstruction(
            restricted(scene, list(arc), point_noise, seed=k), s, R, t))
    return recs


def test_apply_sim3_matches_jax():
    scene = make_orbit_scene(num_cameras=4, num_points=40, seed=30)
    s, R, t = 2.5, _np_rodrigues(np.array([0.2, -0.3, 0.1])), np.array([1.0, -2.0, 0.5])
    out = run_both("apply_sim3_to_reconstruction", lambda: ((scene_to_reconstruction(scene), s, R, t), {}))
    assert isinstance(out, Reconstruction)


@pytest.mark.parametrize("name,kw", [
    ("relative_sim3", {}),
    ("merge_two", {}),
    ("merge_two", {"align": False}),
])
def test_pairwise_merge_matches_jax(name, kw):
    out = run_both(name, lambda: (tuple(arc_clusters(0.01)[:2]), dict(kw)))
    assert out is not None


def test_merge_two_without_anything_shared_raises():
    scene = make_orbit_scene(num_cameras=8, num_points=40, seed=32)
    a, b = (from_numpy_reconstruction(scene_to_reconstruction(scene)) for _ in range(2))
    a.registered = np.arange(8) < 4
    b.registered = np.arange(8) >= 6
    b.obs_kp = b.obs_kp + 100_000
    with pytest.raises(ValueError):
        merge.merge_two(a, b)


def test_synchronize_sim3_matches_jax():
    out = run_both("synchronize_sim3", lambda: ((sorted(arc_clusters(0.01), key=lambda r: -r.num_registered),), {}))
    assert all(tr is not None for tr in out)


def test_merge_reconstructions_matches_jax():
    merged = run_both("merge_reconstructions", lambda: ((arc_clusters(), JPipelineConfig()), {}))
    assert merged.num_registered == 24 and merged.mean_reprojection_error() < 0.1


def test_sync_audit_matches_jax():
    I, z = np.eye(3), np.zeros(3)
    edges = [(0, 1, 100.0, I, z, 10.0), (1, 2, 1.0, I, z, 10.0), (1, 3, 1.0, I, z, 10.0),
             (2, 3, 1.0, I, z, 10.0), (0, 3, 1.0, I, z, 10.0), (0, 2, 1.0, I, z, 10.0)]
    pruned = run_both("_audit_edges", lambda: ((4, list(edges)), {"anchor": 0}))
    assert len(pruned) == 5
    run_both("_sync_solve", lambda: ((4, pruned, 0), {}))


def fragmented(seed=7, cams=8):
    """A clean orbit model whose points seen everywhere are split into copies
    (cameras >= cams/2 see a copy 0.01 away), plus a track that glues two
    distinct points and one gross 2D outlier: work for every consolidation
    function. Returns (rec, scene, the split point ids)."""
    scene = make_orbit_scene(num_cameras=cams, num_points=40, noise_px=0.0, seed=seed)
    rec = scene_to_reconstruction(scene)
    M = scene.num_points
    split = np.where(scene.visible.all(0))[0][:8]
    obs_point = rec.obs_point.copy()
    for k, p in enumerate(split):
        obs_point[(rec.obs_point == p) & (rec.obs_image >= cams // 2)] = M + k
    rec.obs_point = obs_point
    rec.points = np.concatenate([rec.points, scene.points[split] + [0.01, 0, 0]]).astype(np.float32)
    rec.point_valid = np.concatenate([rec.point_valid, np.ones(len(split), bool)])
    rec.point_errors = np.zeros(len(rec.points), np.float32)
    return rec, scene, split


def vote_graph(split, cams=8):
    """Edges across the split that vote for every split point but the last
    twice, and one transitive chain through a keypoint no point observes."""
    half = cams // 2
    return _mock_graph([
        (half - 1, half, [(int(p), int(p)) for p in split]),
        (half - 2, half + 1, [(int(p), int(p)) for p in split[:-1]]),
        (1, 2, [(int(split[-1]), 999)]),
        (2, half + 1, [(999, int(split[-1]))]),
    ], W=1024)


@pytest.mark.parametrize("min_votes,dist_frac", [(2, 0.15), (1, 0.05)])
def test_merge_tracks_by_correspondence_matches_jax(min_votes, dist_frac):
    def build():
        rec, _, split = fragmented()
        return (rec, vote_graph(split)), dict(min_votes=min_votes, dist_frac=dist_frac)

    n = run_both("merge_tracks_by_correspondence", build)
    assert n == (7 if min_votes == 2 else 8)


def test_merge_tracks_by_proximity_matches_jax():
    def build():
        return (fragmented()[0],), dict(max_px=6.0)

    assert run_both("merge_tracks_by_proximity", build) == 8


def test_track_id_merge_matches_jax():
    """conflict_tolerant_track_ids, then merge_tracks_by_track_id with that
    map, with and without an exclusion."""
    rec, scene, split = fragmented()
    K = 1024
    xy = np.random.default_rng(0).uniform(0, 500, (scene.num_cameras, K, 2)).astype(np.float32)
    xy[2, 900] = xy[2, int(split[0])] + 0.5      # a duplicate detection 0.5 px away

    def feats_graph():
        graph = _mock_graph([(1, 2, [(int(p), int(p)) for p in split]),
                             (2, 5, [(900, int(split[0]))] + [(int(p), int(p)) for p in split[1:]])], W=K)
        return types.SimpleNamespace(xy=xy.copy()), graph

    gm = run_both("conflict_tolerant_track_ids", lambda: (feats_graph()[::-1], {}))
    assert gm.shape == (scene.num_cameras, K)
    assert gm[1, split[0]] == gm[5, split[0]] == gm[2, 900]

    p, q = int(split[1]), scene.num_points + 1
    excl = {(np.int64(min(p, q)) << 32) | np.int64(max(p, q))}
    for exclude, expected in ((None, 8), (excl, 7)):
        def build():
            rec, _, _ = fragmented()
            return ((rec, feats_graph()[1], scene.num_cameras, K),
                    dict(gid_map=gm.copy(), exclude=exclude))

        assert run_both("merge_tracks_by_track_id", build) == expected


def test_split_tracks_by_consensus_matches_jax():
    def build():
        rec, scene, _ = fragmented(seed=41, cams=10)
        rec.obs_point = rec.obs_point.copy()
        rec.obs_point[rec.obs_point == 7] = 3          # glue point 7's rows onto point 3
        rec.point_valid[7] = False
        rec.obs_uv = rec.obs_uv.copy()
        rec.obs_uv[int(np.where(rec.obs_point == 5)[0][0])] += 50.0
        return (rec,), dict(max_px=3.0, split_log=[])

    assert run_both("split_tracks_by_consensus", build) >= 3


def test_union_reproj_gate_and_apply_point_merges_match_jax():
    rec, scene, split = fragmented()
    M = scene.num_points
    pa = np.concatenate([split, split[:2]]).astype(np.int64)
    pb = np.concatenate([M + np.arange(len(split)), split[2:4]]).astype(np.int64)   # copies, then distinct points

    def gate():
        return (fragmented()[0], pa, pb), dict(rel_factor=2.0, floor_px=1.0, max_px=6.0, gate_obs_cap=64)

    passed, _ = run_both("_union_reproj_gate", gate)
    np.testing.assert_array_equal(passed, np.arange(len(split)))
    assert run_both("_apply_point_merges", lambda: ((fragmented()[0], pa[:8], pb[:8]), {})) == 8
