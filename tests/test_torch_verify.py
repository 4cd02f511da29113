"""Two-view solvers, RANSAC and verification against sfm_tpu.

Tolerances:
- solvers: rtol 1e-4 (atol 1e-5), up to sign and scale where the model is
  projective (E, H): both sides run the same closed-form fp32 algebra, but
  LAPACK-class steps (Cholesky, triangular solves, 4x4 eigh) round
  differently.
- verify_pair fed the minimal sets sfm_tpu draws (ransac.sample_minimal_sets
  under the per-pair keys of stages.py and verify.py): identical inlier
  sets, except matches whose error is within 1e-3 (relative) of the
  threshold; the same pose to 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import RansacConfig as JRansacConfig
from sfm_tpu.ops import solvers as js
from sfm_tpu.ops.ransac import sample_minimal_sets
from sfm_tpu.ops.verify import verify_pair as jverify_pair
from sfm_tpu.utils.synthetic import add_outliers, make_orbit_scene
from sfm_tpu_torch.config import RansacConfig
from sfm_tpu_torch.ops import solvers as ts
from sfm_tpu_torch.ops.ransac import draw_minimal_sets
from sfm_tpu_torch.ops.verify import verify_pair

torch.set_num_threads(2)


def _normalize(M):
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M, axis=(-2, -1), keepdims=True)
    flat = M.reshape(*M.shape[:-2], 9)
    sign = np.sign(np.take_along_axis(flat, np.abs(flat).argmax(-1)[..., None], -1))
    return M * sign[..., None]


def _two_view(n=60, noise=0.0, seed=0):
    scene = make_orbit_scene(num_cameras=2, num_points=n, noise_px=noise, seed=seed, arc_fraction=0.05)
    vis = scene.visible.all(0)
    K = scene.intrinsics[0]
    x = [((scene.pixels[i][vis] - K[2:4]) / K[:2]).astype(np.float32) for i in range(2)]
    return scene, vis, x


def _t(a):
    return torch.from_numpy(np.array(a))


def test_essential_and_homography_solvers():
    _, _, (x1, x2) = _two_view(seed=1)
    E_j = np.asarray(jax.vmap(js.essential_8pt)(jnp.asarray(x1[None, :30]), jnp.asarray(x2[None, :30])))
    E_t = ts.essential_8pt(_t(x1[None, :30]), _t(x2[None, :30])).numpy()
    np.testing.assert_allclose(_normalize(E_t), _normalize(E_j), rtol=1e-4, atol=1e-5)
    # Batched on-manifold GN essential (as the LO refits call it; exactly
    # minimal 8-point sets are too ill-conditioned to compare at 1e-4).
    idx = np.stack([np.random.default_rng(s).permutation(len(x1))[:20] for s in range(16)])
    E_j = np.asarray(jax.vmap(lambda a, b: js.essential_minimal(a, b, gn_iters=4))(
        jnp.asarray(x1[idx]), jnp.asarray(x2[idx])))
    E_t = ts.essential_minimal(_t(x1[idx]), _t(x2[idx]), gn_iters=4).numpy()
    np.testing.assert_allclose(_normalize(E_t), _normalize(E_j), rtol=1e-4, atol=1e-4)
    H_j = np.asarray(js.homography_4pt(jnp.asarray(x1[:20]), jnp.asarray(x2[:20])))
    H_t = ts.homography_4pt(_t(x1[:20]), _t(x2[:20])).numpy()
    np.testing.assert_allclose(_normalize(H_t), _normalize(H_j), rtol=1e-4, atol=1e-5)
    err_j = np.asarray(js.sampson_error(jnp.asarray(E_j[0]), jnp.asarray(x1), jnp.asarray(x2)))
    err_t = ts.sampson_error(_t(E_j[0]), _t(x1), _t(x2)).numpy()
    np.testing.assert_allclose(err_t, err_j, rtol=1e-4, atol=1e-12)


def test_svd_decompositions_and_triangulation():
    scene, vis, (x1, x2) = _two_view(seed=2)
    E = np.asarray(js.essential_8pt(jnp.asarray(x1), jnp.asarray(x2)))
    for a, b in zip(js.svd3_twoview(jnp.asarray(E)), ts.svd3_twoview(_t(E))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)
    mask = np.ones(len(x1), bool)
    Rj, tj, nj = js.decompose_essential(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
    Rt, tt, nt = ts.decompose_essential(_t(E), _t(x1), _t(x2), _t(mask))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    assert int(nt) == int(nj)
    Xj = np.asarray(js.triangulate_linear(jnp.eye(3), jnp.zeros(3), Rj, tj, jnp.asarray(x1), jnp.asarray(x2)))
    Xt = ts.triangulate_linear(torch.eye(3), torch.zeros(3), Rt, tt, _t(x1), _t(x2)).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-4)
    H = np.asarray(js.homography_4pt(jnp.asarray(x1), jnp.asarray(x2)))
    out_j = js.decompose_homography(jnp.asarray(H), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
    out_t = ts.decompose_homography(_t(H), _t(x1), _t(x2), _t(mask))
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)


def test_draw_minimal_sets_contract():
    mask = torch.zeros(64, dtype=torch.bool)
    mask[:40] = True
    a = draw_minimal_sets(3, 7, mask, 128, 8, "e")
    assert torch.equal(a, draw_minimal_sets(3, 7, mask, 128, 8, "e"))
    assert not torch.equal(a, draw_minimal_sets(3, 8, mask, 128, 8, "e"))
    assert not torch.equal(a, draw_minimal_sets(3, 7, mask, 128, 8, "h"))
    assert (a < 40).all() and all(len(set(r.tolist())) == 8 for r in a)


@pytest.fixture(scope="module")
def matched_pair():
    """Noisy correspondences with 25% outliers in a 256-slot match budget."""
    scene = make_orbit_scene(num_cameras=2, num_points=240, noise_px=0.4, seed=5, arc_fraction=0.05)
    pix, _ = add_outliers(scene.pixels, scene.visible, 0.25, scene.image_size, seed=6)
    vis = scene.visible.all(0)
    M = 256
    uv = np.zeros((2, M, 2), np.float32)
    n = int(vis.sum())
    uv[:, :n] = pix[:, vis]
    mask = np.arange(M) < n
    return uv, mask, scene.intrinsics


def test_verify_pair_with_shared_draws(matched_pair):
    uv, mask, intr = matched_pair
    cfg = JRansacConfig(num_hypotheses=256, error_threshold_px=2.0, min_inliers=10)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)          # stages.py: pair index 0
    k_e, k_h = jax.random.split(key)                              # verify.py
    idx_e = np.asarray(sample_minimal_sets(k_e, jnp.asarray(mask), cfg.num_hypotheses, 8))
    idx_h = np.asarray(sample_minimal_sets(k_h, jnp.asarray(mask), cfg.num_hypotheses // 2, 4))
    J = [jnp.asarray(a) for a in (uv[0], uv[1], mask, intr[0], intr[1])]
    rv_j, t_j, inl_j, n_j, nh_j, ok_j, pose_ok_j, E_j = (np.asarray(a) for a in jverify_pair(key, *J, cfg))
    geom = verify_pair(_t(idx_e)[None], _t(idx_h)[None], _t(uv[0])[None], _t(uv[1])[None], _t(mask)[None],
                       _t(intr[0])[None], _t(intr[1])[None], RansacConfig(**vars(cfg)))
    assert bool(geom.ok[0]) == bool(ok_j) and bool(geom.pose_ok[0]) == bool(pose_ok_j) and bool(ok_j)

    # Inlier sets: identical except within 1e-3 of the threshold.
    K = intr[0]
    x1 = (uv[0] - K[2:4]) / K[:2]
    x2 = (uv[1] - K[2:4]) / K[:2]
    thr = (cfg.error_threshold_px / K[0]) ** 2
    err = np.asarray(js.sampson_error(jnp.asarray(E_j), jnp.asarray(x1), jnp.asarray(x2)))
    near = np.abs(err / thr - 1.0) < 1e-3
    diff = geom.inliers[0].numpy() != inl_j
    assert not (diff & ~near).any(), np.where(diff)[0]
    np.testing.assert_allclose(geom.rvec[0].numpy(), rv_j, atol=1e-3)
    np.testing.assert_allclose(geom.tvec[0].numpy(), t_j, atol=1e-3)
    assert abs(int(geom.num_h_inliers[0]) - int(nh_j)) <= int(near.sum()) + 1
