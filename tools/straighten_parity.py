#!/usr/bin/env python3
"""Pose-graph straightening of sfm_tpu and of sfm_tpu_torch on one merged
model, on the CPU.

    python3 tools/torch_perf.py partition --variants default --dump DIR   # on the GPU
    JAX_PLATFORMS=cpu python3 tools/straighten_parity.py DIR

The first command writes the merged model of chip_smoke.py's
divide-and-conquer slice as it stood before the straightening, with the
match graph, the keypoints and the rendered ground truth
(straighten_inputs.npz), and the GPU run's result (straighten_out.npz). This
script feeds the same inputs to `straighten_reconstruction` of both packages
(like the tests, it imports both) and prints the camera-centre RMSE after
Sim(3) alignment, as a share of the orbit radius, before and after each, and
each result's distance from the GPU run's.
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

_REC = ("intrinsics", "rvecs", "tvecs", "registered", "points", "point_errors", "point_valid",
        "obs_point", "obs_image", "obs_kp", "obs_uv")
_GRAPH = ("pairs", "idx_i", "idx_j", "inlier", "num_inliers", "num_h_inliers", "rvec", "tvec", "ok",
          "pose_ok")


def run(package: str, d, gpu, scene, radius: float) -> None:
    if package == "sfm_tpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sfm_tpu.config import PipelineConfig
        from sfm_tpu.pipeline import global_pose
        from sfm_tpu.pipeline.stages import FeatureSet, MatchGraph
        from sfm_tpu.scene.state import Reconstruction
        kw = {}
    else:
        from sfm_tpu_torch.config import PipelineConfig
        from sfm_tpu_torch.pipeline import global_pose
        from sfm_tpu_torch.pipeline.stages import FeatureSet, MatchGraph
        from sfm_tpu_torch.scene.state import Reconstruction
        kw = {"device": "cpu"}
    rec = Reconstruction(**{f: d["rec_" + f].copy() for f in _REC})
    graph = MatchGraph(**{f: d["g_" + f] for f in _GRAPH})
    none = np.zeros(1)
    feats = FeatureSet(xy=d["xy"], sigma=none, angle=none, response=none, desc=none, valid=none)
    before = cs.camera_rmse(rec, scene) / radius
    global_pose.straighten_reconstruction(rec, graph, cfg=PipelineConfig(verbose=False), verbose=False,
                                          feats=feats, **kw)
    print(f"[straighten] {package} on the CPU: camera RMSE {100 * before:.4f}% -> "
          f"{100 * cs.camera_rmse(rec, scene) / radius:.4f}% of the radius; against the GPU run: "
          f"max |rvec| diff {np.abs(rec.rvecs - gpu['rvecs']).max():.2e}, "
          f"max |tvec| diff {np.abs(rec.tvecs - gpu['tvecs']).max():.2e}, "
          f"point_valid equal on {(rec.point_valid == gpu['point_valid']).mean():.4f}", flush=True)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    folder = sys.argv[1]
    d = np.load(os.path.join(folder, "straighten_inputs.npz"))
    gpu = np.load(os.path.join(folder, "straighten_out.npz"))
    scene = types.SimpleNamespace(rvecs=d["gt_rvecs"], tvecs=d["gt_tvecs"])
    gpu_rec = types.SimpleNamespace(rvecs=gpu["rvecs"], tvecs=gpu["tvecs"], registered=d["rec_registered"])
    radius = float(d["radius"])
    print(f"[straighten] sfm_tpu_torch on the GPU: camera RMSE -> "
          f"{100 * cs.camera_rmse(gpu_rec, scene) / radius:.4f}% of the radius", flush=True)
    for package in ("sfm_tpu_torch", "sfm_tpu"):
        run(package, d, gpu, scene, radius)
    return 0


if __name__ == "__main__":
    sys.exit(main())
