"""ops/relpose.py of sfm_tpu_torch against sfm_tpu's (CPU).

The same batches, made with numpy from a seed, through both
refine_relative_poses: refined rotation within 1e-3 degrees and unit
translation within 1e-4 of sfm_tpu's, rms within 1e-6 absolute (ten fp32
Gauss-Newton steps in two frameworks; the result is the same optimum).
gather_edge_correspondences is host numpy: arrays equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ops import relpose as jrelpose
from sfm_tpu.utils.synthetic import make_orbit_scene
from sfm_tpu_torch.ops import relpose
from sfm_tpu_torch.utils.interop import from_numpy_graph
from tests.integration.test_incremental import scene_to_features_and_graph
from tests.unit.test_relpose import _make_pair, _rot_err_deg

torch.set_num_threads(2)


def _batch(noise, starve=False, seed=0, E=6, K=64):
    """E edges of K correspondences with perturbed initial poses; the last
    edge keeps only 4 live slots when `starve` (it must pass through)."""
    rng = np.random.default_rng(seed)
    x1 = np.zeros((E, K, 2), np.float32)
    x2 = np.zeros((E, K, 2), np.float32)
    mask = np.ones((E, K), bool)
    r0 = np.zeros((E, 3), np.float32)
    t0 = np.zeros((E, 3), np.float32)
    truth = []
    for e in range(E):
        a, b, rvec, t = _make_pair(rng, n=K, rot_deg=3.0 + e, noise=noise)
        x1[e], x2[e] = a, b
        r0[e] = rvec + rng.normal(0, np.radians(1.0), 3)
        t0[e] = 2.5 * (t + rng.normal(0, 0.05, 3))          # any scale
        mask[e, K - 3 * e:] = False                          # ragged padding
        truth.append((rvec, t))
    if starve:
        mask[-1, 4:] = False
    return x1, x2, mask, r0, t0, truth


@pytest.mark.parametrize("noise,starve", [(0.0, False), (0.002, False), (0.002, True)])
def test_refine_relative_poses_matches_jax(noise, starve):
    x1, x2, mask, r0, t0, truth = _batch(noise, starve)
    rv_j, tv_j, rms_j = (np.asarray(a) for a in jrelpose.refine_relative_poses(
        *(jnp.asarray(a) for a in (x1, x2, mask, r0, t0)), huber=0.008, iters=10))
    rv_t, tv_t, rms_t = (a.numpy() for a in relpose.refine_relative_poses(
        *(torch.from_numpy(a) for a in (x1, x2, mask, r0, t0)), huber=0.008, iters=10))
    for e in range(len(mask)):
        assert _rot_err_deg(rv_t[e], rv_j[e]) < 1e-3
    np.testing.assert_allclose(tv_t, tv_j, atol=1e-4)
    np.testing.assert_allclose(rms_t, rms_j, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tv_t, axis=1), 1.0, atol=1e-5)
    if noise == 0.0:
        for e, (rvec, _) in enumerate(truth):
            assert _rot_err_deg(rv_t[e], rvec) < 0.05
    if starve:       # fewer than 5 live slots: the edge is returned as it came
        np.testing.assert_allclose(tv_t[-1], t0[-1] / np.linalg.norm(t0[-1]), atol=1e-6)
        assert _rot_err_deg(rv_t[-1], r0[-1]) < 1e-3


def test_gather_edge_correspondences_matches_jax():
    scene = make_orbit_scene(num_cameras=8, num_points=150, noise_px=0.0, seed=3, arc_fraction=1.0)
    feats, graph = scene_to_features_and_graph(scene, noise=0.3, seed=4)
    intr = scene.intrinsics.copy()
    intr[:, 4] = 0.05            # k1 present: the fixed-point undistortion runs
    edges = np.where(graph.ok)[0][:9]
    ref = jrelpose.gather_edge_correspondences(graph, feats.xy, intr, edges, capacity=32)
    got = relpose.gather_edge_correspondences(from_numpy_graph(graph), feats.xy, intr, edges, capacity=32)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[2].sum(1).max() == 32     # strided subsample past the capacity
