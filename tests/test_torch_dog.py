"""K1's plain version (what a CPU tensor takes through the wrapper) against
sfm_tpu's Pallas kernel in interpret mode and its jnp reference
(sfm_tpu/ops/detect.extrema_score_map), on the shapes the CUDA kernel's
tiles make interesting; and the arguments the wrapper hands the kernel.

Tolerance: exact everywhere (the same fp32 subtraction, and max / min of
finite values do not depend on their order). The Pallas kernel needs
H % 128 == 0 and square canvases come from the pyramid, so the ragged and
8 x 8 stacks are smoothed noise held against the jnp reference only.
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
from sfm_tpu_torch.kernels import _SIGNATURES
from sfm_tpu_torch.kernels import dog_extrema as k1

torch.set_num_threads(2)


def _jnp_scores(stack: np.ndarray, cfg: JSiftConfig) -> np.ndarray:
    return np.asarray(jax.vmap(lambda s: extrema_score_map(s[1:] - s[:-1], cfg))(jnp.asarray(stack)))


def _pre(cfg: JSiftConfig) -> float:
    return 0.8 * cfg.contrast_threshold / cfg.scales_per_octave


def _plain(stack: np.ndarray, pre: float) -> np.ndarray:
    return k1.dog_extrema_scores(torch.from_numpy(stack), pre).numpy()   # CPU -> plain


def _smooth_stack(shape, seed: int) -> np.ndarray:
    """Levels that drift apart like a Gaussian stack's, dense in extrema."""
    rng = np.random.default_rng(seed)
    g = 0.1 * np.cumsum(rng.uniform(0, 1, shape), axis=1) + 0.05 * rng.normal(size=shape)
    return g.astype(np.float32)


@pytest.fixture(scope="module")
def noise_octaves():
    """The first two octaves ([3, 6, 256, 256] and [3, 6, 128, 128]) of
    three 256^2 uniform-noise images."""
    cfg = JSiftConfig(num_octaves=2, image_max_dim=256)
    img = np.random.default_rng(3).uniform(0, 1, (3, 256, 256)).astype(np.float32)
    return [np.array(o) for o in jbuild_pyramid(jnp.asarray(img), cfg)], cfg


@pytest.mark.parametrize("octave", [0, 1])
def test_dog_plain_equals_pallas_and_jnp_on_noise_octaves(noise_octaves, octave):
    octaves, cfg = noise_octaves
    stack = octaves[octave]
    assert stack.shape == (3, 6, 256 >> octave, 256 >> octave)
    ref = _jnp_scores(stack, cfg)
    pallas = np.asarray(dog_extrema_scores_batch(jnp.asarray(stack), _pre(cfg), interpret=True))
    ours = _plain(stack, _pre(cfg))
    assert (ref > 0).sum() > 10
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, pallas)


def test_dog_plain_equals_jnp_on_a_ragged_stack():
    """[2, 6, 136, 200]: partial tiles along both axes."""
    cfg = JSiftConfig()
    stack = _smooth_stack((2, 6, 136, 200), seed=4)
    ref = _jnp_scores(stack, cfg)
    assert (ref > 0).sum() > 1000
    np.testing.assert_array_equal(_plain(stack, _pre(cfg)), ref)


def test_dog_plain_equals_pallas_and_jnp_with_one_scored_level():
    """L = 4 (one scale per octave): Ld = 3, only DoG level 1 is scored."""
    cfg = JSiftConfig(num_octaves=1, scales_per_octave=1, image_max_dim=128)
    img = np.random.default_rng(5).uniform(0, 1, (2, 128, 128)).astype(np.float32)
    stack = np.array(jbuild_pyramid(jnp.asarray(img), cfg)[0])
    assert stack.shape == (2, 4, 128, 128)
    ref = _jnp_scores(stack, cfg)
    pallas = np.asarray(dog_extrema_scores_batch(jnp.asarray(stack), _pre(cfg), interpret=True))
    ours = _plain(stack, _pre(cfg))
    assert (ref[:, 1] > 0).sum() > 0 and not ref[:, [0, 2]].any()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, pallas)


def test_dog_plain_scores_nothing_on_an_8x8_image():
    """No pixel is 5 px from every border: every score is 0."""
    cfg = JSiftConfig()
    stack = _smooth_stack((2, 6, 8, 8), seed=6)
    ours = _plain(stack, _pre(cfg))
    assert ours.shape == (2, 5, 8, 8) and not ours.any()
    np.testing.assert_array_equal(ours, _jnp_scores(stack, cfg))


@pytest.mark.parametrize("shape, offset, vec", [
    ((8, 6, 512, 512), 0, True),
    ((8, 6, 128, 128), 0, True),
    ((2, 6, 136, 203), 0, False),    # W % 4 != 0: the 4-byte route
    ((2, 6, 136, 200), 1, False),    # an offset view: not 16-byte aligned
])
def test_dog_wrapper_passes_the_plan(monkeypatch, shape, offset, vec):
    """The wrapper hands the C entry the stack, a fresh output, the shape,
    the threshold, the plan's tile and the route (sfm_dog_extrema's
    arguments, plus the stream)."""
    passed = []
    monkeypatch.setattr(k1, "on_cuda", lambda t: True)
    monkeypatch.setattr(k1, "launch", lambda entry, name, *a: passed.append((entry, name, a)))
    n = int(np.prod(shape))
    gauss = torch.zeros(n + offset)[offset:].view(shape)
    out = k1.dog_extrema_scores(gauss, 0.01)
    (entry, name, args), = passed
    assert (entry, name) == ("sfm_dog_extrema", "dog_extrema_scores")
    assert len(_SIGNATURES[entry]) == len(args) + 1
    B, L, H, W = shape
    assert out.shape == (B, L - 1, H, W)
    assert args[0] == gauss.data_ptr() and args[1] == out.data_ptr()
    assert args[2:7] == (B, L, H, W, 0.01)
    assert args[7:9] == k1.dog_launch_plan(B, H, W) and args[9] == int(vec)


def test_dog_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(k1, "on_cuda", lambda t: True)
    monkeypatch.setattr(k1, "launch", lambda *a: None)
    with pytest.raises(ValueError):
        k1.dog_extrema_scores(torch.zeros((1, 1, 8, 8)), 0.01)           # L < 2
    with pytest.raises(ValueError):
        k1.dog_extrema_scores(torch.zeros((1, 6, 8, 8), dtype=torch.float64), 0.01)
    with pytest.raises(ValueError):
        k1.dog_extrema_scores(torch.zeros((1, 6, 8, 16))[..., ::2], 0.01)   # not contiguous
