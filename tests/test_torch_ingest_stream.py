"""Image decoding without OpenCV and the streamed feature stage.

Tolerances:
- the binary PGM decoder: byte-equal to cv2.imread(IMREAD_GRAYSCALE) on
  the same files (comments, odd sizes, maxval < 255, one-byte header ends);
- iter_image_chunks: the same canvases, names and intrinsics as one
  load_images call, in chunks of 8 and a shorter last one (not padded);
- extract_stage_streaming on 40 PGM files: equal to the port's eager
  extract_stage, bit for bit; against sfm_tpu's extract_stage_streaming on
  the same files the same valid slots, names and intrinsics, and the values
  to 1e-4 (keypoints px, sigma, angle rad, descriptors) and 1e-6 (response):
  the pyramid's matmuls sum in another order, which moves values by ulps
  (tests/test_torch_sift.py).
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from sfm_tpu.config import PipelineConfig, SiftConfig, config_to_dict
from sfm_tpu.pipeline import stages as jstages
from sfm_tpu.utils.synthetic import render_blob_scene
from sfm_tpu_torch import config as tconfig
from sfm_tpu_torch.pipeline import ingest, stages

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)


def _write_pgm(path, img: np.ndarray, header: bytes | None = None):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(header if header is not None else b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.astype(np.uint8).tobytes())


@pytest.mark.parametrize("header,shape,maxval", [
    (b"P5\n%(w)d %(h)d\n255\n", (17, 23), 255),
    (b"P5\n# made by a test\n%(w)d %(h)d\n# another comment\n255\n", (32, 8), 255),
    (b"P5 %(w)d %(h)d 100\n", (5, 9), 100),
    (b"P5\t%(w)d\r\n%(h)d  255\r", (64, 64), 255),
])
def test_pgm_decoder_byte_equal_to_cv2(tmp_path, header, shape, maxval):
    h, w = shape
    img = np.random.default_rng(h * w).integers(0, maxval + 1, (h, w)).astype(np.uint8)
    p = str(tmp_path / "x.pgm")
    _write_pgm(p, img, header % {b"w": w, b"h": h})
    ref = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    ours = ingest._load_file(p)
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape == ref.shape
    assert ours.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(ours, img)


def test_decode_without_opencv(tmp_path, monkeypatch):
    img = np.arange(48, dtype=np.uint8).reshape(6, 8)
    pgm, png = str(tmp_path / "a.pgm"), str(tmp_path / "b.png")
    _write_pgm(pgm, img)
    cv2.imwrite(png, img)
    monkeypatch.setitem(sys.modules, "cv2", None)          # import cv2 now fails
    np.testing.assert_array_equal(ingest._load_file(pgm), img)
    with pytest.raises(ImportError) as err:
        ingest._load_file(png)
    assert png in str(err.value) and "P5" in str(err.value)
    _write_pgm(str(tmp_path / "t.pgm"), img[:3], header=b"P5\n8 6\n255\n")
    with pytest.raises(ValueError, match="truncated"):
        ingest._load_file(str(tmp_path / "t.pgm"))


@pytest.fixture(scope="module")
def pgm_dir(tmp_path_factory):
    """40 noisy 128 x 128 PGM views of two rendered scenes (past the
    33-image streaming threshold), as tests/integration/test_streaming.py."""
    d = tmp_path_factory.mktemp("pgm40")
    imgs, _ = render_blob_scene(image_size=(128, 128), num_images=2, arc_fraction=0.04)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(40):
        img = imgs[i % 2] + rng.normal(0, 0.01, imgs[0].shape).astype(np.float32)
        p = str(d / f"im_{i:03d}.pgm")
        _write_pgm(p, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        paths.append(p)
    return str(d), paths


def _cfg():
    cfg = PipelineConfig(
        sift=SiftConfig(max_keypoints=128, max_candidates=512, num_octaves=2, image_max_dim=128,
                        desc_per_octave=128),
        verbose=False,
    )
    return cfg, tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(cfg))


def _decode_threads():
    return [t for t in threading.enumerate() if t.name == "sfm-decode"]


def test_iter_image_chunks_equals_load_images(pgm_dir):
    d, paths = pgm_dir
    assert ingest.resolve_paths(d) == paths
    _, tcfg = _cfg()
    whole = ingest.load_images(paths, tcfg.sift)
    chunks = list(ingest.iter_image_chunks(paths, tcfg.sift, 8))
    assert [len(c.names) for c in chunks] == [8, 8, 8, 8, 8]
    chunks7 = list(ingest.iter_image_chunks(paths, tcfg.sift, 7))
    assert [len(c.names) for c in chunks7] == [7, 7, 7, 7, 7, 5]
    for cs in (chunks, chunks7):
        np.testing.assert_array_equal(np.concatenate([c.canvases for c in cs]), whole.canvases)
        np.testing.assert_array_equal(np.concatenate([c.intrinsics for c in cs]), whole.intrinsics)
        np.testing.assert_array_equal(np.concatenate([c.valid_hw for c in cs]), whole.valid_hw)
        assert sum((c.names for c in cs), []) == whole.names
    assert not _decode_threads()


def test_iter_image_chunks_surfaces_decode_errors(pgm_dir, tmp_path):
    _, paths = pgm_dir
    _, tcfg = _cfg()
    bad = str(tmp_path / "broken.pgm")
    with open(bad, "wb") as f:
        f.write(b"P5\n128 128\n255\n" + bytes(100))          # truncated raster
    it = ingest.iter_image_chunks(paths[:8] + [bad] + paths[8:16], tcfg.sift, 8)
    assert len(next(it).names) == 8
    with pytest.raises(ValueError, match="broken.pgm"):
        next(it)
    assert not _decode_threads()
    # A consumer that stops early stops and joins the decode thread.
    it = ingest.iter_image_chunks(paths, tcfg.sift, 4, prefetch=1)
    next(it)
    it.close()
    assert not _decode_threads()


def test_streaming_features_equal_eager_and_sfm_tpu(pgm_dir):
    _, paths = pgm_dir
    cfg, tcfg = _cfg()
    cpu = torch.device("cpu")
    feats_s, intr_s, hw_s, names_s = stages.extract_stage_streaming(paths, tcfg, cpu)
    batch = ingest.load_images(paths, tcfg.sift)
    feats_e = stages.extract_stage(batch, tcfg, cpu)
    for k in ("xy", "sigma", "angle", "response", "desc", "valid"):
        np.testing.assert_array_equal(getattr(feats_s, k), getattr(feats_e, k), err_msg=k)
    np.testing.assert_array_equal(intr_s, batch.intrinsics)
    np.testing.assert_array_equal(hw_s, batch.valid_hw)
    assert names_s == batch.names == [os.path.basename(p) for p in paths]

    feats_j, intr_j, hw_j, names_j = jstages.extract_stage_streaming(paths, cfg)
    assert names_s == names_j
    np.testing.assert_array_equal(intr_s, intr_j)
    np.testing.assert_array_equal(hw_s, hw_j)
    np.testing.assert_array_equal(feats_s.valid, feats_j.valid)
    assert feats_s.valid.sum() > 40 * 20
    v = feats_s.valid
    for k, tol in (("xy", 1e-4), ("sigma", 1e-4), ("angle", 1e-4), ("desc", 1e-4), ("response", 1e-6)):
        np.testing.assert_allclose(getattr(feats_s, k)[v], getattr(feats_j, k)[v], rtol=0, atol=tol, err_msg=k)
