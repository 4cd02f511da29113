"""Stage artifacts, resume and the COLMAP / PLY writers against sfm_tpu.

Tolerances:
- writers: byte-equal to sfm_tpu's on the same Reconstruction when both are
  given the same two derived fp32 values, each image's quaternion (from its
  angle-axis) and each observation's reprojection error; computed by each
  package itself those two differ in the last bits (XLA's and PyTorch's
  fp32 sin, cos and projection round differently), so there the files agree
  in every other byte-for-byte field, the quaternions to 2.5e-7 and the
  per-point errors to 1e-4 px;
- read_colmap_bin: the same cameras, images and points as the writer's
  input (exact, fp32 values read back as float64);
- input_hash / path_hash: equal strings;
- resume: a store written by sfm_tpu loads in the port with the same arrays
  (exact), and the port's own resume after a fault between stages gives the
  same points, poses and observations as the uninterrupted run (exact);
- partition checkpoints: the 'clusters' and 'merged_prepolish' slots round
  trip exactly, and sfm_tpu's 'clusters' artifact loads in the port.
"""

import json
import os

import numpy as np
import pytest
import torch

import sfm_tpu
from sfm_tpu.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig, config_to_dict
from sfm_tpu.pipeline import partition as jpartition
from sfm_tpu.scene import artifacts as jartifacts
from sfm_tpu.scene import export as jexport
from sfm_tpu.scene.state import Reconstruction as JReconstruction
from sfm_tpu.utils.synthetic import make_orbit_scene, render_blob_scene
from sfm_tpu_torch import config as tconfig
from sfm_tpu_torch.pipeline import partition, stages
from sfm_tpu_torch.scene import artifacts, export
from sfm_tpu_torch.scene.state import Reconstruction

torch.set_num_threads(2)

FILES = ("cameras.txt", "images.txt", "points3D.txt", "cameras.bin", "images.bin", "points3D.bin")


def _rec_arrays(seed: int = 0, num_cameras: int = 8, num_points: int = 300) -> dict:
    """A model of an orbit scene: 0.5 px noisy observations, one camera not
    registered, some points invalid, four COLMAP camera models."""
    scene = make_orbit_scene(num_cameras=num_cameras, num_points=num_points, noise_px=0.5, seed=seed)
    cam, pt = np.nonzero(scene.visible)
    intr = scene.intrinsics.astype(np.float32)
    intr[1, 4] = 0.02                      # SIMPLE_RADIAL
    intr[2, 4:6] = (0.01, -0.003)          # RADIAL
    intr[3, 1] += 2.0
    intr[3, 4] = 0.01                      # OPENCV
    rng = np.random.default_rng(seed)
    registered = np.ones(num_cameras, bool)
    registered[-1] = False
    return dict(
        intrinsics=intr, rvecs=scene.rvecs.astype(np.float32), tvecs=scene.tvecs.astype(np.float32),
        registered=registered, points=scene.points.astype(np.float32),
        point_errors=np.zeros(num_points, np.float32), point_valid=rng.uniform(size=num_points) > 0.1,
        obs_point=pt.astype(np.int32), obs_image=cam.astype(np.int32),
        obs_kp=rng.integers(0, 4096, len(pt)).astype(np.int32),
        obs_uv=scene.pixels[cam, pt].astype(np.float32),
        image_names=[f"view_{i:03d}.pgm" for i in range(num_cameras)],
        image_sizes=np.tile(np.asarray([640, 480], np.int32), (num_cameras, 1)),
    )


def _write_all(mod, rec, out):
    mod.write_colmap_text(rec, os.path.join(out, "sparse"))
    mod.write_colmap_bin(rec, os.path.join(out, "sparse"))
    mod.write_ply(rec, os.path.join(out, "cloud.ply"))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_writers_byte_equal_given_the_same_derived_values(tmp_path, monkeypatch):
    import jax.numpy as jnp
    from sfm_tpu.geometry.rotations import aa_to_quat

    d = _rec_arrays()
    jrec, trec = JReconstruction(**d), Reconstruction(**d)
    # The port's writers are given sfm_tpu's quaternions and errors.
    quats = {rv.tobytes(): np.asarray(aa_to_quat(jnp.asarray(rv))) for rv in d["rvecs"]}
    monkeypatch.setattr(export, "_quat", lambda rv: quats[np.asarray(rv, np.float32).tobytes()])
    monkeypatch.setattr(Reconstruction, "reprojection_errors", lambda self: jrec.reprojection_errors())
    _write_all(jexport, jrec, str(tmp_path / "j"))
    _write_all(export, trec, str(tmp_path / "t"))
    for name in FILES:
        assert _read(tmp_path / "j" / "sparse" / name) == _read(tmp_path / "t" / "sparse" / name), name
    assert _read(tmp_path / "j" / "cloud.ply") == _read(tmp_path / "t" / "cloud.ply")


def test_writers_against_sfm_tpu_and_read_back(tmp_path):
    d = _rec_arrays(seed=1)
    jrec, trec = JReconstruction(**d), Reconstruction(**d)
    _write_all(jexport, jrec, str(tmp_path / "j"))
    _write_all(export, trec, str(tmp_path / "t"))
    for name in ("cameras.txt", "cameras.bin"):
        assert _read(tmp_path / "j" / "sparse" / name) == _read(tmp_path / "t" / "sparse" / name), name
    assert _read(tmp_path / "j" / "cloud.ply") == _read(tmp_path / "t" / "cloud.ply")

    # Text: every token equal but the quaternions (.8f) and point errors (.4f).
    for name, loose in (("images.txt", {1: 2.5e-7, 2: 2.5e-7, 3: 2.5e-7, 4: 2.5e-7}), ("points3D.txt", {7: 1e-4})):
        lj = _read(tmp_path / "j" / "sparse" / name).decode().splitlines()
        lt = _read(tmp_path / "t" / "sparse" / name).decode().splitlines()
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            ta, tb = a.split(), b.split()
            assert len(ta) == len(tb)
            header = name == "images.txt" and len(ta) == 10 and not a.startswith("#")
            for k, (x, y) in enumerate(zip(ta, tb)):
                tol = loose.get(k) if (header or name == "points3D.txt") and not a.startswith("#") else None
                if tol is None:
                    assert x == y, (name, a, b)
                else:
                    assert abs(float(x) - float(y)) <= tol + 1e-12, (name, k, x, y)

    # Binary: read back by both readers, compare with the input and sfm_tpu.
    cj, ij, pj = jexport.read_colmap_bin(str(tmp_path / "j" / "sparse"))
    ct, it, pt = export.read_colmap_bin(str(tmp_path / "t" / "sparse"))
    assert cj == ct and ij.keys() == it.keys() and pj.keys() == pt.keys()
    reg = np.where(d["registered"])[0]
    assert sorted(it) == list(reg + 1)
    for i in reg:
        a, b = ij[i + 1], it[i + 1]
        assert a["name"] == b["name"] == d["image_names"][i] and a["camera_id"] == b["camera_id"] == i + 1
        np.testing.assert_array_equal(b["tvec"], d["tvecs"][i].astype(np.float64))
        np.testing.assert_allclose(b["qvec"], a["qvec"], rtol=0, atol=2.5e-7)
        np.testing.assert_array_equal(b["xys"], a["xys"])
        np.testing.assert_array_equal(b["point3D_ids"], a["point3D_ids"])
        rows = d["obs_image"] == i
        np.testing.assert_array_equal(b["xys"], d["obs_uv"][rows].astype(np.float64))
        np.testing.assert_array_equal(b["point3D_ids"], d["obs_point"][rows] + 1)
    valid = np.where(d["point_valid"])[0]
    assert sorted(pt) == list(valid + 1)
    for p in valid:
        a, b = pj[p + 1], pt[p + 1]
        np.testing.assert_array_equal(b["xyz"], d["points"][p].astype(np.float64))
        np.testing.assert_array_equal(b["image_ids"], a["image_ids"])
        np.testing.assert_array_equal(b["point2D_idxs"], a["point2D_idxs"])
        assert abs(a["error"] - b["error"]) <= 1e-4
    for i in range(len(d["intrinsics"])):
        assert ct[i + 1]["width"] == 640 and ct[i + 1]["height"] == 480
    assert [ct[i + 1]["model_id"] for i in range(4)] == [1, 2, 3, 4]


def test_input_and_path_hashes_equal_sfm_tpu(tmp_path):
    canv = np.random.default_rng(0).uniform(size=(3, 64, 64)).astype(np.float32)
    names = ["a.png", "b.png", "c.png"]
    assert artifacts.input_hash(canv, names) == jartifacts.input_hash(canv, names)
    paths = []
    for n in names:
        p = tmp_path / n
        p.write_bytes(os.urandom(100 + len(paths)))
        paths.append(str(p))
    assert artifacts.path_hash(paths) == jartifacts.path_hash(paths)


def _cfg(art_dir):
    """tests/integration/test_resume.py's config, in both packages."""
    cfg = PipelineConfig(
        sift=SiftConfig(max_keypoints=512, max_candidates=2048, num_octaves=3, image_max_dim=256),
        match=MatchConfig(max_matches=256, min_matches=8),
        ransac=RansacConfig(num_hypotheses=512, min_inliers=10, error_threshold_px=2.0),
        artifact_dir=str(art_dir),
        verbose=False,
    )
    return cfg, tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(cfg))


@pytest.fixture(scope="module")
def two_views():
    imgs, _ = render_blob_scene(image_size=(256, 256), num_images=2, arc_fraction=0.04)
    return list(imgs)


def _boom(*a, **k):
    raise KeyboardInterrupt("injected fault between stages")


def _same_rec(a, b):
    for f in ("rvecs", "tvecs", "registered", "points", "point_valid", "obs_point", "obs_image", "obs_uv"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_store_written_by_sfm_tpu_resumes_in_the_port(tmp_path, two_views, monkeypatch):
    """sfm_tpu's feature stage writes 'features' under sfm_tpu's key; the
    port loads it (its own feature stage must not run), matches and
    reconstructs, and sfm_tpu then loads the port's 'matches' and
    'reconstruction' without running a stage."""
    import sfm_tpu_torch
    from sfm_tpu.config import stage_config_hash
    from sfm_tpu.pipeline import ingest as jingest, stages as jstages
    from sfm_tpu_torch.pipeline import two_view

    cfg, tcfg = _cfg(tmp_path / "run")
    batch = jingest.load_images(two_views, cfg.sift)
    ikey = jartifacts.input_hash(batch.canvases, batch.names)
    jfeats = jstages.extract_stage(batch, cfg)
    jartifacts.ArtifactStore(cfg.artifact_dir).save_features(
        stage_config_hash(cfg, "features") + "-" + ikey, jfeats)

    monkeypatch.setattr(stages, "extract_stage", _boom)
    handed = []
    real_bootstrap = two_view.bootstrap_two_view
    monkeypatch.setattr(two_view, "bootstrap_two_view",
                        lambda feats, graph, *a: handed.append((feats, graph)) or real_bootstrap(feats, graph, *a))
    rec = sfm_tpu_torch.reconstruct(two_views, tcfg, device="cpu")
    assert rec.num_registered == 2 and rec.mean_reprojection_error() < 1.0
    (feats, graph), = handed
    for k in ("xy", "sigma", "angle", "response", "desc", "valid"):
        np.testing.assert_array_equal(getattr(feats, k), getattr(jfeats, k), err_msg=k)
    with open(tmp_path / "run" / "stage_timings.json") as f:
        assert "match+verify" in json.load(f)

    monkeypatch.setattr(jstages, "extract_stage", _boom)
    monkeypatch.setattr(jstages, "match_and_verify_stage", _boom)
    jrec = sfm_tpu.reconstruct(two_views, cfg)       # loads every stage
    _same_rec(jrec, rec)


def test_resume_after_fault_is_bit_identical(tmp_path, two_views, monkeypatch):
    """tests/integration/test_resume.py through the port."""
    import sfm_tpu_torch

    _, tcfg = _cfg(tmp_path / "clean")
    clean = sfm_tpu_torch.reconstruct(two_views, tcfg, device="cpu")

    _, tcfg = _cfg(tmp_path / "run")
    real_match = stages.match_and_verify_stage
    monkeypatch.setattr(stages, "match_and_verify_stage", _boom)
    with pytest.raises(KeyboardInterrupt):
        sfm_tpu_torch.reconstruct(two_views, tcfg, device="cpu")
    assert (tmp_path / "run" / "features.npz").exists()
    assert not (tmp_path / "run" / "matches.npz").exists()

    monkeypatch.setattr(stages, "match_and_verify_stage", real_match)

    def no_extract(*a, **k):
        raise AssertionError("feature stage re-ran despite completed artifact")

    monkeypatch.setattr(stages, "extract_stage", no_extract)
    rec1 = sfm_tpu_torch.reconstruct(two_views, tcfg, device="cpu")
    assert rec1.num_registered == 2
    _same_rec(rec1, clean)

    monkeypatch.setattr(stages, "match_and_verify_stage", _boom)
    rec2 = sfm_tpu_torch.reconstruct(two_views, tcfg, device="cpu")
    _same_rec(rec2, rec1)

    from sfm_tpu_torch.config import apply_overrides

    with pytest.raises(AssertionError, match="feature stage re-ran"):
        sfm_tpu_torch.reconstruct(two_views, apply_overrides(tcfg, {"sift.max_keypoints": 256}),
                                  device="cpu")


def test_streamed_run_saves_and_resumes_features(tmp_path, monkeypatch):
    """33 or more path inputs stream through the feature stage and save
    'features' and 'meta' under the path hash; a rerun loads both."""
    import sfm_tpu_torch

    imgs, _ = render_blob_scene(image_size=(64, 64), num_images=2, arc_fraction=0.04)
    for i in range(34):
        img = (np.clip(imgs[i % 2], 0, 1) * 255).astype(np.uint8)
        (tmp_path / f"v_{i:02d}.pgm").write_bytes(b"P5\n64 64\n255\n" + img.tobytes())
    cfg = PipelineConfig(sift=SiftConfig(max_keypoints=64, max_candidates=256, num_octaves=2,
                                         image_max_dim=64, desc_per_octave=64),
                         artifact_dir=str(tmp_path / "art"), verbose=False)
    tcfg = tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(cfg))
    monkeypatch.setattr(stages, "extract_stage", _boom)          # eager extraction must not run
    monkeypatch.setattr(stages, "match_and_verify_stage", _boom)
    with pytest.raises(KeyboardInterrupt):
        sfm_tpu_torch.reconstruct(str(tmp_path), tcfg, device="cpu")
    store = artifacts.ArtifactStore(str(tmp_path / "art"))
    assert store.manifest["features"] == store.manifest["meta"]
    feats, meta = store.load_features(), store.load("meta")
    assert feats.valid.shape == (34, 64) and [str(n) for n in meta["names"]][:2] == ["v_00.pgm", "v_01.pgm"]

    seen = []

    def no_stream(*a, **k):
        raise AssertionError("streamed feature stage re-ran despite completed artifact")

    monkeypatch.setattr(stages, "extract_stage_streaming", no_stream)
    monkeypatch.setattr(stages, "match_and_verify_stage", lambda f, *a, **k: seen.append(f) or _boom())
    with pytest.raises(KeyboardInterrupt):
        sfm_tpu_torch.reconstruct(str(tmp_path), tcfg, device="cpu")
    np.testing.assert_array_equal(seen[0].desc, feats.desc)


def _small_recs():
    return [Reconstruction(**{k: v for k, v in _rec_arrays(seed=s, num_cameras=5, num_points=40).items()
                              if k not in ("image_names", "image_sizes")}) for s in (2, 3)]


def _fields_equal(a, b):
    for f in partition._REC_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_partition_checkpoint_slots_round_trip(tmp_path, monkeypatch):
    recs = _small_recs()
    store = artifacts.ArtifactStore(str(tmp_path))
    partition._save_cluster_recs(store, "k1", recs)
    for a, b in zip(partition._load_cluster_recs(store), recs):
        _fields_equal(a, b)
    # sfm_tpu's artifact of the same slot loads in the port.
    jstore = jartifacts.ArtifactStore(str(tmp_path / "j"))
    jpartition._save_cluster_recs(jstore, "k2", [JReconstruction(**{f: getattr(r, f) for f in partition._REC_FIELDS})
                                                 for r in recs])
    for a, b in zip(partition._load_cluster_recs(artifacts.ArtifactStore(str(tmp_path / "j"))), recs):
        _fields_equal(a, b)

    # partitioned_reconstruct with a complete 'clusters' slot merges the
    # saved clusters without reconstructing any.
    from sfm_tpu_torch.pipeline import engine, merge

    monkeypatch.setattr(engine, "incremental_reconstruct", _boom)
    handed = []

    def stop_merge(rs, cfg):
        handed.extend(rs)
        raise KeyboardInterrupt("stop after the merge input")

    monkeypatch.setattr(merge, "merge_reconstructions", stop_merge)
    feats = stages.FeatureSet(*(np.zeros((5, 4) + s, t) for s, t in
                                (((2,), np.float32), ((), np.float32), ((), np.float32),
                                 ((), np.float32), ((128,), np.float32), ((), bool))))
    graph = stages.MatchGraph(pairs=np.array([[0, 1]], np.int32), idx_i=np.zeros((1, 4), np.int32),
                              idx_j=np.zeros((1, 4), np.int32), inlier=np.zeros((1, 4), bool),
                              num_inliers=np.zeros(1, np.int32), num_h_inliers=np.zeros(1, np.int32),
                              rvec=np.zeros((1, 3), np.float32), tvec=np.zeros((1, 3), np.float32),
                              ok=np.ones(1, bool), pose_ok=np.ones(1, bool))
    tcfg = tconfig.PipelineConfig()
    with pytest.raises(KeyboardInterrupt, match="merge input"):
        partition.partitioned_reconstruct(feats, graph, recs[0].intrinsics, tcfg, "cpu", store=store, key="k1")
    for a, b in zip(handed, recs):
        _fields_equal(a, b)

    # A complete 'merged_prepolish' slot goes straight to the polish.
    store.save_reconstruction("k1", recs[1], stage="merged_prepolish")
    polished = []
    monkeypatch.setattr(partition, "partition_images", _boom)
    monkeypatch.setattr(partition, "_polish_phase", lambda m, *a: polished.append(m))
    out = partition.partitioned_reconstruct(feats, graph, recs[0].intrinsics, tcfg, "cpu", store=store, key="k1")
    assert polished == [out] and "partition.polish" in out.stage_seconds
    _fields_equal(out, recs[1])
