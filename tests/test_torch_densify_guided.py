"""Densify, guided matching, F-RANSAC and first-octave upsampling against
sfm_tpu.

Tolerances:
- densify_candidate_pairs and append_match_graph: exact (the same host
  numpy and scipy.sparse code);
- guided_match_pair under the same E with use_bf16_matmul=False: the same
  indices and validity (exact), one pair and a block taken in slices;
- fundamental_8pt: 1e-4 of the largest entry (F is scaled to |F[2, 2]| = 1
  by both), on noise-free correspondences as tests/test_torch_verify.py's
  solver checks, and both within 1e-4 of the port's own float64 solution:
  the fp32 Cholesky of the inverse iteration and the undoing of the Hartley
  normalization move entries by up to ~4e-5 of the largest in either
  package (1e-5 is not met); project_essential: 1e-5 of the largest entry,
  up to the overall sign;
- the F branch of verify_pair fed sfm_tpu's draws: the same inlier set,
  the pose to 1e-4;
- build_pyramid with upsample_first_octave: 1e-5 (F.interpolate against
  jax.image.resize, borders included, then the same blur products);
  extract_features: the same valid slots and keypoints to 1e-3 px (found
  2.3e-4 at most), sigma and descriptors to 1e-3: the pyramid's products
  sum in another order, and the subpixel refinement magnifies those ulps
  (tests/test_torch_sift.py holds 0.01 px).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import MatchConfig as JMatchConfig
from sfm_tpu.config import RansacConfig as JRansacConfig
from sfm_tpu.config import SiftConfig as JSiftConfig
from sfm_tpu.ops import match as jmatch
from sfm_tpu.ops import solvers as js
from sfm_tpu.ops.pyramid import build_pyramid as jbuild_pyramid
from sfm_tpu.ops.ransac import sample_minimal_sets
from sfm_tpu.ops.sift import extract_features as jextract
from sfm_tpu.ops.verify import verify_pair as jverify_pair
from sfm_tpu.pipeline import stages as jstages
from sfm_tpu.utils.synthetic import add_outliers, make_orbit_scene, render_blob_scene
from sfm_tpu_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
from sfm_tpu_torch.ops import match, solvers
from sfm_tpu_torch.ops.pyramid import build_pyramid
from sfm_tpu_torch.ops.sift import extract_features
from sfm_tpu_torch.ops.verify import verify_pair
from sfm_tpu_torch.pipeline import ingest, stages

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ring_band_pairs(n: int, band: int) -> np.ndarray:
    out = [(min(i, (i + d) % n), max(i, (i + d) % n)) for i in range(n) for d in range(1, band + 1)]
    return np.unique(np.asarray(out, np.int64), axis=0)


@pytest.mark.parametrize("n,band,scales,per_node", [(64, 1, 5, 2), (50, 3, 8, 1), (200, 2, 8, 2), (16, 2, 0, 2)])
def test_densify_candidates_equal_sfm_tpu(n, band, scales, per_node):
    pairs = _ring_band_pairs(n, band)
    rng = np.random.default_rng(n)
    pairs = pairs[rng.uniform(size=len(pairs)) > 0.1]              # a few edges missing
    ours = stages.densify_candidate_pairs(pairs, n, max_scale=scales, per_node=per_node)
    ref = jstages.densify_candidate_pairs(pairs, n, max_scale=scales, per_node=per_node)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype


def _graph(mod, pairs, M, ok, seed):
    rng = np.random.default_rng(seed)
    E = len(pairs)
    return mod.MatchGraph(
        pairs=pairs.astype(np.int32), idx_i=rng.integers(0, 99, (E, M)).astype(np.int32),
        idx_j=rng.integers(0, 99, (E, M)).astype(np.int32), inlier=rng.uniform(size=(E, M)) > 0.5,
        num_inliers=rng.integers(0, M, E).astype(np.int32), num_h_inliers=rng.integers(0, M, E).astype(np.int32),
        rvec=rng.normal(size=(E, 3)).astype(np.float32), tvec=rng.normal(size=(E, 3)).astype(np.float32),
        ok=ok, pose_ok=ok & (rng.uniform(size=E) > 0.3))


@pytest.mark.parametrize("M_new", [4, 8, 16])
def test_append_match_graph_equal_sfm_tpu(M_new):
    ok_old = np.array([True, True, False])
    ok_new = np.array([True, False, True, True])
    pairs_old, pairs_new = np.array([[0, 1], [1, 2], [2, 3]]), np.array([[0, 2], [0, 3], [1, 3], [2, 4]])
    ours, n_ours = stages.append_match_graph(_graph(stages, pairs_old, 8, ok_old, 0),
                                             _graph(stages, pairs_new, M_new, ok_new, 1))
    ref, n_ref = jstages.append_match_graph(_graph(jstages, pairs_old, 8, ok_old, 0),
                                            _graph(jstages, pairs_new, M_new, ok_new, 1))
    assert n_ours == n_ref == 3
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name), err_msg=f.name)
    same, n0 = stages.append_match_graph(ours, _graph(stages, pairs_new, 8, np.zeros(4, bool), 2))
    assert same is ours and n0 == 0


@pytest.fixture(scope="module")
def guided_pair():
    """Two views of an orbit scene: keypoints at the projections (0.5 px
    noise), descriptors shared by the two views of a point (plus noise), a
    few distractor keypoints, the ground-truth E."""
    scene = make_orbit_scene(num_cameras=2, num_points=300, noise_px=0.5, seed=4, arc_fraction=0.05)
    rng = np.random.default_rng(4)
    N = 320
    base = rng.normal(size=(300, 128)).astype(np.float32)
    xy, desc, valid = np.zeros((2, N, 2), np.float32), np.zeros((2, N, 128), np.float32), np.zeros((2, N), bool)
    for v in range(2):
        vis = np.where(scene.visible[v])[0]
        perm = rng.permutation(len(vis))
        xy[v, :len(vis)] = scene.pixels[v, vis[perm]]
        d = base[vis[perm]] + 0.35 * rng.normal(size=(len(vis), 128)).astype(np.float32)
        desc[v, :len(vis)] = d
        valid[v, :len(vis)] = True
        xy[v, len(vis):] = rng.uniform(0, 480, (N - len(vis), 2))
        desc[v, len(vis):] = rng.normal(size=(N - len(vis), 128))
        valid[v, len(vis):] = rng.uniform(size=N - len(vis)) > 0.5
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    from sfm_tpu.geometry.projection import relative_pose
    from sfm_tpu.geometry.rotations import so3_exp, so3_hat

    rv, t = relative_pose(*(jnp.asarray(a, jnp.float32) for a in (scene.rvecs[0], scene.tvecs[0],
                                                                  scene.rvecs[1], scene.tvecs[1])))
    E = np.asarray(so3_hat(t / jnp.linalg.norm(t)) @ so3_exp(rv), np.float32)
    return xy, desc, valid, E, scene.intrinsics.astype(np.float32)


def test_guided_match_pair_equal_sfm_tpu(guided_pair, monkeypatch):
    xy, desc, valid, E, intr = guided_pair
    jcfg = JMatchConfig(max_matches=256, use_bf16_matmul=False)
    ref = [np.asarray(a) for a in jmatch.guided_match_pair(
        jnp.asarray(desc[0]), jnp.asarray(valid[0]), jnp.asarray(xy[0]), jnp.asarray(desc[1]),
        jnp.asarray(valid[1]), jnp.asarray(xy[1]), jnp.asarray(E), jnp.asarray(intr[0]), jnp.asarray(intr[1]), jcfg)]
    assert ref[2].sum() > 150
    cfg = MatchConfig(max_matches=256, use_bf16_matmul=False)
    ours = match.guided_match_pair(*(_t(a)[None] for a in (desc[0], valid[0], xy[0], desc[1], valid[1], xy[1],
                                                            E, intr[0], intr[1])), cfg)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a[0].numpy(), b)
    # A block of three pairs taken one pair at a time gives each its own result.
    monkeypatch.setattr(match, "_GUIDED_SLICE_BYTES", 1)
    E3 = np.stack([E, E * 0.5, np.eye(3, dtype=np.float32)])
    block = match.guided_match_block(*(_t(np.stack([a] * 3)) for a in (desc[0], valid[0], xy[0], desc[1],
                                                                        valid[1], xy[1])),
                                     _t(E3), _t(np.stack([intr[0]] * 3)), _t(np.stack([intr[1]] * 3)), cfg)
    for p in range(3):
        one = match.guided_match_pair(*(_t(a)[None] for a in (desc[0], valid[0], xy[0], desc[1], valid[1], xy[1],
                                                               E3[p], intr[0], intr[1])), cfg)
        for a, b in zip(block, one):
            np.testing.assert_array_equal(a[p].numpy(), b[0].numpy())
    np.testing.assert_array_equal(block.idx_i[0].numpy(), ref[0])


def _norm_sign(M):
    M = np.asarray(M, np.float64)
    flat = M.reshape(*M.shape[:-2], 9)
    return M * np.sign(np.take_along_axis(flat, np.abs(flat).argmax(-1)[..., None], -1))[..., None]


def test_fundamental_8pt_and_project_essential():
    scene = make_orbit_scene(num_cameras=2, num_points=120, noise_px=0.0, seed=9, arc_fraction=0.05)
    vis = scene.visible.all(0)
    uv1, uv2 = (scene.pixels[i][vis].astype(np.float32) for i in range(2))
    idx = np.stack([np.random.default_rng(s).permutation(len(uv1))[:12] for s in range(8)])
    w = (np.random.default_rng(1).uniform(size=len(uv1)) > 0.2).astype(np.float32)
    F_j = np.concatenate([np.asarray(jax.jit(jax.vmap(js.fundamental_8pt))(jnp.asarray(uv1[idx]), jnp.asarray(uv2[idx]))),
                          np.asarray(jax.jit(js.fundamental_8pt)(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(w)))[None]])
    F_t = np.concatenate([solvers.fundamental_8pt(_t(uv1[idx]), _t(uv2[idx])).numpy(),
                          solvers.fundamental_8pt(_t(uv1), _t(uv2), _t(w)).numpy()[None]])
    F_64 = np.concatenate([solvers.fundamental_8pt(_t(uv1[idx]).double(), _t(uv2[idx]).double()).numpy(),
                           solvers.fundamental_8pt(_t(uv1).double(), _t(uv2).double(), _t(w).double()).numpy()[None]])
    scale = np.abs(F_j).max(axis=(1, 2), keepdims=True)
    assert (np.abs(F_t - F_j) <= 1e-4 * scale).all(), np.abs(F_t - F_j).max()
    assert (np.abs(F_t - F_64) <= 1e-4 * scale).all() and (np.abs(F_j - F_64) <= 1e-4 * scale).all()
    K = np.asarray([[scene.intrinsics[0, 0], 0, scene.intrinsics[0, 2]],
                    [0, scene.intrinsics[0, 1], scene.intrinsics[0, 3]], [0, 0, 1]], np.float32)
    M = K.T @ F_j @ K
    E_j = np.asarray(jax.jit(jax.vmap(js.project_essential))(jnp.asarray(M)))
    E_t = solvers.project_essential(_t(M)).numpy()
    np.testing.assert_allclose(_norm_sign(E_t), _norm_sign(E_j), rtol=0,
                               atol=1e-5 * np.abs(E_j).max())


def test_verify_fundamental_with_shared_draws():
    """tests/test_torch_verify.py's shared-draw check on the F path."""
    scene = make_orbit_scene(num_cameras=2, num_points=240, noise_px=0.4, seed=5, arc_fraction=0.05)
    pix, _ = add_outliers(scene.pixels, scene.visible, 0.25, scene.image_size, seed=6)
    vis = scene.visible.all(0)
    M = 256
    uv = np.zeros((2, M, 2), np.float32)
    n = int(vis.sum())
    uv[:, :n] = pix[:, vis]
    mask = np.arange(M) < n
    intr = scene.intrinsics.astype(np.float32)
    cfg = JRansacConfig(num_hypotheses=256, error_threshold_px=2.0, min_inliers=10, model="fundamental")
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    k_e, k_h = jax.random.split(key)
    idx_e = np.asarray(sample_minimal_sets(k_e, jnp.asarray(mask), cfg.num_hypotheses, 8))
    idx_h = np.asarray(sample_minimal_sets(k_h, jnp.asarray(mask), cfg.num_hypotheses // 2, 4))
    ref = [np.asarray(a) for a in jax.jit(jverify_pair, static_argnames="cfg")(
        key, *(jnp.asarray(a) for a in (uv[0], uv[1], mask, intr[0], intr[1])), cfg=cfg)]
    rv_j, t_j, inl_j, n_j, nh_j, ok_j, pose_ok_j, E_j = ref
    geom = verify_pair(_t(idx_e)[None], _t(idx_h)[None], _t(uv[0])[None], _t(uv[1])[None], _t(mask)[None],
                       _t(intr[0])[None], _t(intr[1])[None], RansacConfig(**vars(cfg)))
    assert bool(ok_j) and bool(geom.ok[0]) and bool(geom.pose_ok[0]) == bool(pose_ok_j)
    np.testing.assert_array_equal(geom.inliers[0].numpy(), inl_j)
    assert int(geom.num_inliers[0]) == int(n_j) > 120
    np.testing.assert_allclose(geom.rvec[0].numpy(), rv_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(geom.tvec[0].numpy(), t_j, rtol=0, atol=1e-4)


def test_guided_stage_adds_inliers():
    """tests/integration/test_guided_matching.py through the port's stage."""
    imgs, _ = render_blob_scene(image_size=(256, 256), num_images=2, arc_fraction=0.04)
    base = PipelineConfig(
        sift=SiftConfig(max_keypoints=512, max_candidates=2048, num_octaves=3, image_max_dim=256),
        match=MatchConfig(max_matches=256, min_matches=8, ratio_threshold=0.7),
        ransac=RansacConfig(num_hypotheses=512, min_inliers=10, error_threshold_px=2.0),
        verbose=False,
    )
    cpu = torch.device("cpu")
    batch = ingest.load_images(list(imgs), base.sift)
    feats = stages.extract_stage(batch, base, cpu)
    pairs = stages.exhaustive_pairs(2)
    g0 = stages.match_and_verify_stage(feats, pairs, batch.intrinsics, base, cpu, seed=0)
    guided = dataclasses.replace(base, match=dataclasses.replace(base.match, guided=True))
    g1 = stages.match_and_verify_stage(feats, pairs, batch.intrinsics, guided, cpu, seed=0)
    assert g0.ok[0] and g1.ok[0]
    assert g1.num_inliers[0] > g0.num_inliers[0], (g0.num_inliers[0], g1.num_inliers[0])
    inl = g1.inlier[0]
    assert inl.sum() == g1.num_inliers[0]
    assert len(np.unique(g1.idx_i[0][inl])) == inl.sum()
    assert len(np.unique(g1.idx_j[0][inl])) == inl.sum()


@pytest.fixture(scope="module")
def upsampled():
    imgs, _ = render_blob_scene(image_size=(128, 128), num_images=2, arc_fraction=0.04)
    kw = dict(num_octaves=2, image_max_dim=128, max_keypoints=256, max_candidates=1024, desc_per_octave=128,
              upsample_first_octave=True)
    return np.asarray(imgs, np.float32), JSiftConfig(**kw), SiftConfig(**kw)


def test_pyramid_upsampled_first_octave(upsampled):
    imgs, jcfg, cfg = upsampled
    ref = jbuild_pyramid(jnp.asarray(imgs), jcfg)
    ours = build_pyramid(torch.from_numpy(imgs), cfg)
    assert ours[0].shape == (2, 6, 256, 256) and ours[1].shape == (2, 6, 128, 128)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_extract_features_upsampled_first_octave(upsampled):
    imgs, jcfg, cfg = upsampled
    hw = np.asarray([[128, 128], [128, 128]], np.int32)
    ref = jextract(jnp.asarray(imgs), jcfg, jnp.asarray(hw))
    ours = extract_features(torch.from_numpy(imgs), cfg, torch.from_numpy(hw))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(ours.valid.numpy(), v)
    assert v.sum() > 100
    np.testing.assert_allclose(ours.xy.numpy()[v], np.asarray(ref.xy)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ours.sigma.numpy()[v], np.asarray(ref.sigma)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ours.desc.numpy()[v], np.asarray(ref.desc)[v], rtol=0, atol=1e-3)
    # Octave 0 keypoints sit at half-pixel scale: sub-unit sigma appears.
    assert (ours.sigma.numpy()[v] < 1.6).any()
