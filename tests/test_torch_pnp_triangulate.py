"""Tracks, triangulation, PnP, the all-candidate pose decompositions and the
Sim(3) alignment of sfm_tpu_torch against sfm_tpu (CPU).

Tolerances:
- tracks: the native builder, its plain Python version and sfm_tpu's
  builder are equal exactly (the same union-find; the plain version's track
  order differs, so it is compared as a set of tracks);
- triangulate_tracks: points to 1e-4 relative to the scene extent, valid
  flags equal (the same masked DLT; eigh of another LAPACK build);
- epnp, and pnp_ransac fed sfm_tpu's own draws: pose to 1e-4, inlier sets
  equal (closed-form vs jacfwd Gauss-Newton Jacobian, fp32);
- decompose_*_all: rotations and translations to 1e-5 (the same closed
  forms);
- umeyama: scale, rotation and translation to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.geometry import similarity as jsim
from sfm_tpu.geometry.cameras import pixel_to_camera as jpixel_to_camera
from sfm_tpu.geometry.rotations import so3_exp as jso3_exp, so3_hat as jso3_hat
from sfm_tpu.ops import pnp as jpnp
from sfm_tpu.ops import solvers as jsolvers
from sfm_tpu.ops.ransac import irls_refit as jirls_refit, sample_minimal_sets
from sfm_tpu.ops.triangulate import triangulate_tracks as jtriangulate
from sfm_tpu.scene.tracks import build_tracks as jbuild_tracks
from sfm_tpu.utils.synthetic import add_outliers, make_orbit_scene
from sfm_tpu_torch.geometry.similarity import apply_sim3, umeyama, umeyama_np
from sfm_tpu_torch.ops import pnp, solvers
from sfm_tpu_torch.ops.ransac import irls_refit
from sfm_tpu_torch.ops.triangulate import triangulate_tracks
from sfm_tpu_torch.scene.tracks import build_tracks, build_tracks_python
from sfm_tpu_torch.utils.interop import from_numpy_graph
from tests.integration.test_incremental import scene_to_features_and_graph

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


# ---- tracks -----------------------------------------------------------------


@pytest.fixture(scope="module")
def ring_graph():
    scene = make_orbit_scene(num_cameras=12, num_points=150, noise_px=0.0, seed=10, arc_fraction=1.0)
    feats, graph = scene_to_features_and_graph(scene, noise=0.3, seed=11)
    # Break a few tracks: an image seeing one point twice is rejected.
    graph.inlier[3, :5] = False
    graph.idx_j[7, 0] = graph.idx_j[7, 1]
    return feats, graph


def _canonical(ts):
    tracks = {}
    for img, kp, tid in zip(ts.obs_image, ts.obs_kp, ts.track_id):
        tracks.setdefault(int(tid), set()).add((int(img), int(kp)))
    return set(frozenset(v) for v in tracks.values())


def test_tracks_native_equal_sfm_tpu(ring_graph):
    feats, graph = ring_graph
    B, N = feats.valid.shape
    ref = jbuild_tracks(graph, B, N)
    got = build_tracks(from_numpy_graph(graph), B, N)
    assert got.num_tracks == ref.num_tracks > 100
    for name in ("obs_image", "obs_kp", "track_id"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


def test_tracks_plain_equal_native(ring_graph):
    feats, graph = ring_graph
    B, N = feats.valid.shape
    native = build_tracks(from_numpy_graph(graph), B, N)
    plain = build_tracks_python(from_numpy_graph(graph), B, N)
    assert plain.num_tracks == native.num_tracks
    assert _canonical(plain) == _canonical(native)


def test_native_library_is_keyed_by_host_cpu(monkeypatch):
    """A build directory that reaches another CPU must not load a binary
    compiled with -march=native for this one."""
    from sfm_tpu_torch import native

    here = native.library_path()
    assert here.parent == native.BUILD_DIR and native.host_cpu_id()
    monkeypatch.setattr(native, "host_cpu_id", lambda: "another CPU")
    assert native.library_path() != here


def test_tracks_reject_out_of_range_ids(ring_graph):
    feats, graph = ring_graph
    B, N = feats.valid.shape
    with pytest.raises(ValueError, match="out of range"):
        build_tracks(from_numpy_graph(graph), B, N // 2)


# ---- triangulation ----------------------------------------------------------


def test_triangulate_tracks_matches_jax():
    scene = make_orbit_scene(num_cameras=8, num_points=60, noise_px=0.5, seed=5)
    rng = np.random.default_rng(0)
    T, V = scene.num_points, scene.num_cameras
    rvecs = np.tile(scene.rvecs[None], (T, 1, 1))
    tvecs = np.tile(scene.tvecs[None], (T, 1, 1))
    xy = np.asarray(jpixel_to_camera(jnp.asarray(scene.pixels.transpose(1, 0, 2)),
                                     jnp.asarray(scene.intrinsics[0])))
    mask = scene.visible.T & (rng.random((T, V)) < 0.6)
    mask[:, :2] = scene.visible.T[:, :2]
    mask[:4, 2:] = False                                       # two-view tracks
    mask[4:6] = False                                          # empty tracks
    ref = jtriangulate(jnp.asarray(rvecs), jnp.asarray(tvecs), jnp.asarray(xy), jnp.asarray(mask),
                       min_angle_deg=1.5, max_error_norm=4.0 / 600.0)
    got = triangulate_tracks(t(rvecs), t(tvecs), t(xy), t(mask), min_angle_deg=1.5,
                             max_error_norm=4.0 / 600.0)
    valid = np.asarray(ref.valid)
    assert 0.5 < valid.mean() < 1.0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.points.numpy()[valid], np.asarray(ref.points)[valid], atol=1e-4)
    np.testing.assert_allclose(got.max_angle_deg.numpy()[valid], np.asarray(ref.max_angle_deg)[valid],
                               atol=1e-3)


# ---- PnP --------------------------------------------------------------------


def _pnp_data(noise: float, seed: int, outliers: float = 0.0):
    scene = make_orbit_scene(num_cameras=1, num_points=200, noise_px=noise, seed=seed)
    pix = scene.pixels
    if outliers:
        pix, _ = add_outliers(scene.pixels, scene.visible, fraction=outliers,
                              image_size=scene.image_size, seed=seed + 1)
    vis = scene.visible[0]
    X = scene.points[vis]
    uv = np.asarray(jpixel_to_camera(jnp.asarray(pix[0][vis]), jnp.asarray(scene.intrinsics[0])))
    return scene, X.astype(np.float32), uv.astype(np.float32)


def test_epnp_matches_jax():
    _, X, uv = _pnp_data(noise=0.5, seed=2)
    w = (np.random.default_rng(1).random(len(X)) > 0.2).astype(np.float32)
    for weights in (None, w):
        ref = np.asarray(jpnp.epnp(jnp.asarray(X), jnp.asarray(uv),
                                   None if weights is None else jnp.asarray(weights)))
        got = pnp.epnp(t(X), t(uv), None if weights is None else t(weights)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_epnp_batched_matches_vmapped_jax():
    """The RANSAC solver path: minimal 8-point sets, batched."""
    _, X, uv = _pnp_data(noise=0.5, seed=4)
    idx = np.random.default_rng(2).choice(len(X), (16, 8), replace=True)
    ref = np.asarray(jax.vmap(jpnp.epnp)(jnp.asarray(X[idx]), jnp.asarray(uv[idx])))
    got = pnp.epnp(t(X[idx]), t(uv[idx])).numpy()
    # Compare as reprojection errors over all points: a minimal set's pose
    # is as well conditioned as its 8 points, so compare what RANSAC scores.
    e_ref = np.asarray(jax.vmap(lambda p: jpnp.pnp_reprojection_error(p, jnp.asarray(X), jnp.asarray(uv)))(jnp.asarray(ref)))
    e_got = pnp.pnp_reprojection_error(t(got), t(X)[None], t(uv)[None]).numpy()
    good = np.median(e_ref, axis=1) < 1e-4
    assert good.sum() >= 12
    np.testing.assert_allclose(got[good], ref[good], atol=1e-3)
    np.testing.assert_allclose(e_got[good], e_ref[good], atol=1e-6)


def test_pnp_ransac_shared_draws_match_jax():
    scene, X, uv = _pnp_data(noise=0.5, seed=3, outliers=0.3)
    M = 256
    Xp = np.zeros((M, 3), np.float32)
    uvp = np.zeros((M, 2), np.float32)
    mask = np.zeros(M, bool)
    Xp[:len(X)], uvp[:len(X)], mask[:len(X)] = X, uv, True
    key = jax.random.PRNGKey(7)
    thr = (4.0 / 600.0) ** 2
    pose_j, inl_j, n_j, ok_j = jpnp.pnp_ransac(key, jnp.asarray(Xp), jnp.asarray(uvp), jnp.asarray(mask),
                                               256, thr, 12)
    idx = t(np.asarray(sample_minimal_sets(key, jnp.asarray(mask), 256, 8))).long()
    pose, inl, n, ok = pnp.pnp_ransac(idx, t(Xp), t(uvp), t(mask), threshold_sq=thr, min_inliers=12)
    assert bool(ok) and bool(ok_j)
    assert pose.shape == (6,)
    np.testing.assert_allclose(pose.numpy(), np.asarray(pose_j), atol=1e-4)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    assert int(n) == int(n_j)


def test_irls_refit_keeps_a_pose_shaped_model():
    """A [6] pose model comes back [6] (the better-mask broadcasts over the
    model's own trailing shape, not a [3, 3] one)."""
    _, X, uv = _pnp_data(noise=0.5, seed=5)
    mask = torch.ones(len(X), dtype=torch.bool)
    start = pnp.epnp(t(X[:8]), t(uv[:8]))
    ref, ref_inl = jirls_refit(jnp.asarray(start.numpy()), jnp.asarray(X), jnp.asarray(uv),
                               jnp.ones(len(X), bool), fit_fn=jpnp.epnp,
                               error_fn=jpnp.pnp_reprojection_error, threshold_sq=(4.0 / 600) ** 2,
                               iters=3)
    model, inl = irls_refit(start, t(X), t(uv), mask, fit_fn=pnp.epnp,
                            error_fn=pnp.pnp_reprojection_error, threshold_sq=(4.0 / 600) ** 2,
                            iters=3)
    assert model.shape == (6,) and inl.shape == (len(X),)
    np.testing.assert_allclose(model.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(ref_inl))


def test_irls_refit_keeps_matrix_models():
    """The batched [P, 3, 3] essential-matrix models of verification."""
    scene = make_orbit_scene(num_cameras=3, num_points=80, noise_px=0.3, seed=8)
    x = np.asarray(jpixel_to_camera(jnp.asarray(scene.pixels), jnp.asarray(scene.intrinsics[0])))
    x1 = np.stack([x[0], x[0]]).astype(np.float32)
    x2 = np.stack([x[1], x[2]]).astype(np.float32)
    mask = np.stack([scene.visible[0] & scene.visible[1], scene.visible[0] & scene.visible[2]])
    E0 = solvers.essential_minimal(t(x1[:, :12]), t(x2[:, :12]))
    model, inl = irls_refit(E0, t(x1), t(x2), t(mask), fit_fn=solvers.essential_minimal,
                            error_fn=solvers.sampson_error, threshold_sq=(2.0 / 600) ** 2, iters=3)
    assert model.shape == (2, 3, 3) and inl.shape == mask.shape
    assert (inl.numpy() <= mask).all() and inl.numpy().sum(1).min() > 0.8 * mask.sum(1).min()


# ---- all-candidate decompositions ---------------------------------------------


def test_decompose_essential_all_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(4):
        rv = rng.normal(0, 0.3, 3).astype(np.float32)
        tv = rng.normal(0, 1.0, 3).astype(np.float32)
        E = np.asarray(jso3_hat(jnp.asarray(tv / np.linalg.norm(tv))) @ jso3_exp(jnp.asarray(rv)))
        Rj, tj = jsolvers.decompose_essential_all(jnp.asarray(E))
        Rt, tt = solvers.decompose_essential_all(t(E))
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    # Batched over a leading axis, as the pose search would batch edges.
    Rb, tb = solvers.decompose_essential_all(t(np.stack([E, E])))
    assert Rb.shape == (2, 4, 3, 3) and tb.shape == (2, 4, 3)


def test_decompose_homography_all_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(4):
        R = np.asarray(jso3_exp(jnp.asarray(rng.normal(0, 0.2, 3).astype(np.float32))))
        tv = rng.normal(0, 0.5, 3)
        n = rng.normal(0, 1.0, 3)
        n = n / np.linalg.norm(n)
        H = (R + np.outer(tv, n) / 3.0).astype(np.float32)
        Rj, tj = jsolvers.decompose_homography_all(jnp.asarray(H))
        Rt, tt = solvers.decompose_homography_all(t(H))
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


# ---- Sim(3) -----------------------------------------------------------------


def test_umeyama_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.normal(size=(30, 3)).astype(np.float32)
    R = np.asarray(jso3_exp(jnp.asarray(np.array([0.3, -0.5, 1.1], np.float32))))
    dst = (2.5 * src @ R.T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = rng.random(30).astype(np.float32)
    for weights in (None, w):
        sj, Rj, tj = jsim.umeyama(jnp.asarray(src), jnp.asarray(dst),
                                  None if weights is None else jnp.asarray(weights))
        st, Rt, tt = umeyama(t(src), t(dst), None if weights is None else t(weights))
        assert float(st) == pytest.approx(float(sj), rel=1e-5)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
        np.testing.assert_allclose(apply_sim3(st, Rt, tt, t(src)).numpy(),
                                   np.asarray(jsim.apply_sim3(sj, Rj, tj, jnp.asarray(src))), atol=1e-4)
    s64, R64, t64 = umeyama_np(src, dst)
    sj64, Rj64, tj64 = jsim.umeyama_np(src, dst)
    assert s64 == pytest.approx(sj64, rel=1e-12)
    np.testing.assert_allclose(R64, Rj64, atol=1e-12)
    np.testing.assert_allclose(t64, tj64, atol=1e-12)
