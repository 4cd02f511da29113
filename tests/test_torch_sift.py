"""Feature stage: kernel K1's plain version and extract_features against
sfm_tpu.

Tolerances:
- K1 plain version vs sfm_tpu extrema_score_map and vs the Pallas kernel in
  interpret mode, on the same 128x128 octave stack: exact (same fp32
  subtraction and compares; the border mask removes every padded voxel).
- extract_features at 256x256: >= 98% of sfm_tpu's valid keypoints have a
  port keypoint within 0.01 px and 1e-4 rad; matched descriptors agree to
  1e-3 (the pyramid matmuls and descriptor contraction sum in another
  order, which moves values by ulps; a rare candidate can flip at a tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import SiftConfig as JSiftConfig
from sfm_tpu.kernels.dog_extrema import dog_extrema_scores_batch
from sfm_tpu.ops.detect import extrema_score_map
from sfm_tpu.ops.pyramid import build_pyramid as jbuild_pyramid
from sfm_tpu.ops.sift import extract_features as jextract
from sfm_tpu.utils.synthetic import render_blob_scene
from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels import dog_extrema as k1
from sfm_tpu_torch.ops.detect import pre_threshold
from sfm_tpu_torch.ops.pyramid import build_pyramid
from sfm_tpu_torch.ops.sift import extract_features

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def octave_stack():
    cfg = JSiftConfig(num_octaves=1, image_max_dim=128)
    img = np.random.default_rng(0).uniform(0, 1, (1, 128, 128)).astype(np.float32)
    return np.array(jbuild_pyramid(jnp.asarray(img), cfg)[0][0]), cfg, img


def test_dog_plain_equals_jax_reference_and_kernel(octave_stack):
    stack, cfg, _ = octave_stack
    pre = 0.8 * cfg.contrast_threshold / cfg.scales_per_octave
    ref = np.asarray(jax.vmap(lambda s: extrema_score_map(s[1:] - s[:-1], cfg))(jnp.asarray(stack[None])))
    pallas = np.asarray(dog_extrema_scores_batch(jnp.asarray(stack[None]), pre, interpret=True))
    ours = k1.dog_extrema_scores(torch.from_numpy(stack[None]), pre).numpy()   # CPU -> plain
    assert (ref > 0).sum() > 0
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, pallas)
    assert pre_threshold(SiftConfig()) == pre


def test_pyramid_matches(octave_stack):
    stack, _, img = octave_stack
    ours = build_pyramid(torch.from_numpy(img), SiftConfig(num_octaves=1, image_max_dim=128))[0][0]
    np.testing.assert_allclose(ours.numpy(), stack, rtol=1e-5, atol=1e-6)


def test_dog_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        k1.dog_extrema_scores(torch.zeros((1, 6, 8, 8), device="meta"), 0.01)


@pytest.fixture(scope="module")
def features_both():
    imgs, _ = render_blob_scene(image_size=(256, 256), num_images=2)
    kw = dict(max_keypoints=512, max_candidates=2048, num_octaves=3, image_max_dim=256)
    hw = np.array([[256, 256], [200, 240]], np.int32)   # second canvas partly padding
    fj = jextract(jnp.asarray(imgs), JSiftConfig(**kw), jnp.asarray(hw))
    ft = extract_features(torch.from_numpy(imgs), SiftConfig(**kw), torch.from_numpy(hw))
    return [np.asarray(a) for a in fj], [a.numpy() for a in ft]


def test_extract_features_matches_jax(features_both):
    fj, ft = features_both
    xy_j, _, ang_j, _, desc_j, val_j = fj
    xy_t, _, ang_t, _, desc_t, val_t = ft
    for b in range(2):
        vj, vt = val_j[b], val_t[b]
        assert vj.sum() > 50 and abs(int(vj.sum()) - int(vt.sum())) <= 0.02 * vj.sum()
        d = np.linalg.norm(xy_j[b][vj][:, None] - xy_t[b][vt][None], axis=-1)
        da = np.abs(ang_j[b][vj][:, None] - ang_t[b][vt][None])
        close = (d < 0.01) & (np.minimum(da, 2 * np.pi - da) < 1e-4)
        hit = close.any(1)
        assert hit.mean() >= 0.98, hit.mean()
        nn = close.argmax(1)
        np.testing.assert_allclose(desc_t[b][vt][nn[hit]], desc_j[b][vj][hit], atol=1e-3)


def test_padding_contract(features_both):
    _, ft = features_both
    xy, _, _, _, desc, valid = ft
    assert xy.shape == (2, 512, 2) and desc.shape == (2, 512, 128) and valid.shape == (2, 512)
    assert (xy[1][valid[1]][:, 0] < 239).all() and (xy[1][valid[1]][:, 1] < 199).all()
    np.testing.assert_allclose(np.linalg.norm(desc[valid], axis=-1), 1.0, atol=1e-5)


def test_features_interop_into_matching(features_both):
    """sfm_tpu's features, converted with from_numpy_features, match in the
    port exactly as the port's own (slot-identical) features do."""
    from sfm_tpu_torch.config import MatchConfig
    from sfm_tpu_torch.ops.match import match_block
    from sfm_tpu_torch.utils.interop import from_numpy_features

    fj, ft = features_both
    names = ("xy", "sigma", "angle", "response", "desc", "valid")
    fj_t = from_numpy_features(dict(zip(names, fj)))
    cfg = MatchConfig(max_matches=256)
    ours = match_block(torch.from_numpy(ft[4][:1]), torch.from_numpy(ft[5][:1]),
                       torch.from_numpy(ft[4][1:]), torch.from_numpy(ft[5][1:]), cfg)
    theirs = match_block(fj_t.desc[:1], fj_t.valid[:1], fj_t.desc[1:], fj_t.valid[1:], cfg)
    assert int(ours.valid.sum()) > 10
    got = set(zip(ours.idx_i[ours.valid].tolist(), ours.idx_j[ours.valid].tolist()))
    ref = set(zip(theirs.idx_i[theirs.valid].tolist(), theirs.idx_j[theirs.valid].tolist()))
    assert len(got ^ ref) <= 0.02 * len(ref)
