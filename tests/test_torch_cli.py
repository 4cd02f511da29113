"""The port's command line (python -m sfm_tpu_torch.cli) with --device cpu on
a directory of two rendered PGM views (tests/integration/test_resume.py's
scene and config sizes).

Bars: reconstruct registers both views under 1 px and writes the COLMAP
text and binary models and the PLY, which read back to the printed summary
(exact counts); a second reconstruct resumes every stage from the artifacts
and writes the same bytes; export --binary --ply and info work from the
artifact directory alone; match reports the verified edge; --device cuda
without a GPU raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sfm_tpu.utils.synthetic import render_blob_scene
from sfm_tpu_torch import cli
from sfm_tpu_torch.pipeline import stages
from sfm_tpu_torch.scene.export import read_colmap_bin

torch.set_num_threads(2)

OVERRIDES = ["sift.max_keypoints=512", "sift.max_candidates=2048", "sift.num_octaves=3",
             "sift.image_max_dim=256", "match.max_matches=256", "match.min_matches=8",
             "ransac.num_hypotheses=512", "ransac.min_inliers=10", "ransac.error_threshold_px=2.0",
             "verbose=false"]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("views")
    imgs, _ = render_blob_scene(image_size=(256, 256), num_images=2, arc_fraction=0.04)
    for i, img in enumerate(imgs):
        (d / f"view_{i}.pgm").write_bytes(b"P5\n256 256\n255\n" + (np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes())
    return str(d)


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                out[os.path.relpath(os.path.join(root, n), d)] = f.read()
    return out


def test_reconstruct_export_info(image_dir, tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "out")
    assert cli.main(["reconstruct", image_dir, "--out", out, "--device", "cpu", *OVERRIDES]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["num_registered"] == 2 and summary["mean_reproj_error_px"] < 1.0
    for f in ("features.npz", "matches.npz", "reconstruction.npz", "manifest.json", "stage_timings.json",
              "cloud.ply", "sparse/cameras.txt", "sparse/images.txt", "sparse/points3D.txt",
              "sparse/cameras.bin", "sparse/images.bin", "sparse/points3D.bin"):
        assert os.path.exists(os.path.join(out, f)), f
    cams, images, points = read_colmap_bin(os.path.join(out, "sparse"))
    assert len(cams) == 2 and len(images) == 2 and len(points) == summary["num_points"]
    assert sorted(im["name"] for im in images.values()) == ["view_0.pgm", "view_1.pgm"]
    with open(os.path.join(out, "cloud.ply")) as f:
        assert f"element vertex {summary['num_points']}\n" in f.read()

    # A rerun resumes every stage and writes the same bytes.
    first = {k: v for k, v in _files(out).items() if k.startswith("sparse") or k == "cloud.ply"}
    for name in ("extract_stage", "match_and_verify_stage"):
        monkeypatch.setattr(stages, name, lambda *a, **k: pytest.fail("a stage re-ran"))
    assert cli.main(["reconstruct", image_dir, "--out", out, "--device", "cpu", *OVERRIDES]) == 0
    capsys.readouterr()
    again = _files(out)
    assert all(again[k] == v for k, v in first.items())

    exp = str(tmp_path / "exported")
    assert cli.main(["export", out, "--out", exp, "--binary", "--ply"]) == 0
    cams2, images2, points2 = read_colmap_bin(os.path.join(exp, "sparse"))
    assert images2.keys() == images.keys() and points2.keys() == points.keys()
    for k in points:
        np.testing.assert_array_equal(points2[k]["xyz"], points[k]["xyz"])
    assert os.path.exists(os.path.join(exp, "sparse", "points3D.txt"))
    assert os.path.exists(os.path.join(exp, "cloud.ply"))
    capsys.readouterr()
    assert cli.main(["info", out]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["num_registered"] == 2 and info["num_points"] == summary["num_points"]


def test_match_subcommand_and_device_check(image_dir, tmp_path, capsys):
    assert cli.main(["match", image_dir, "--out", str(tmp_path / "m"), "--device", "cpu", *OVERRIDES]) == 0
    assert "verified edges: 1/1" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["reconstruct", image_dir, "--out", str(tmp_path / "c"), *OVERRIDES])
    with pytest.raises(SystemExit):
        cli.main(["reconstruct", image_dir, "--out", str(tmp_path / "c"), "--device", "cpu", "not-an-override"])


@pytest.mark.parametrize("argv", [
    ["reconstruct", "D", "--out", "O", 'pair_mode="vocab_tree"', "sift.max_keypoints=8"],
    ["reconstruct", "D", 'pair_mode="vocab_tree"', "--out", "O", "sift.max_keypoints=8"],
    ["reconstruct", "D", "--out", "O", "--device", "cpu", 'pair_mode="vocab_tree"', "sift.max_keypoints=8"],
    ["reconstruct", "D", "--out", "O", 'pair_mode="vocab_tree"', "--device", "cpu", "sift.max_keypoints=8"],
])
def test_overrides_before_or_after_the_options(argv):
    args, ov = cli.parse_args(argv)
    assert (args.images, args.out) == ("D", "O")
    assert ov == {"pair_mode": "vocab_tree", "sift.max_keypoints": 8}
    assert args.device == ("cpu" if "cpu" in argv else "cuda")


def test_module_entry_point_prints_help():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "sfm_tpu_torch.cli", "--help"], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "reconstruct" in r.stdout
