#!/usr/bin/env python3
"""Intrinsics refinement through both packages' incremental engines on the
CPU, on the same synthetic features.

    JAX_PLATFORMS=cpu python3 tools/refine_parity.py [--cameras 20] [--points 300]
        [--offset 0.04] [--no-refine] [--package both|jax|port]

The scene is chip_smoke.py phase 11's geometry with synthetic features: an
orbit arc of 0.23 at radius 7 around points in a +-1.2 box, 1024^2 views
rendered at (1 + offset) x 1228.8, observed with 0.5 px of noise
(tests/integration/test_incremental.py's feature and graph synthesis); the
engines get the prior 1228.8 and, unless --no-refine, refine focal and k1
in their global BAs. One JSON line per package: registered views, mean
reprojection error, camera-centre RMSE after Sim(3) alignment (% of the
radius), mean refined focal against the rendered one, the largest |k1|,
seconds. sfm_tpu is the reference: the port should agree with it to fp32
rounding.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PRIOR = 1228.8
RADIUS = 7.0


def run(package: str, cameras: int, points: int, offset: float, refine: bool) -> dict:
    import torch

    from sfm_tpu.config import BAConfig, PipelineConfig, config_to_dict
    from sfm_tpu.pipeline import engine as jengine
    from sfm_tpu.utils.synthetic import make_orbit_scene
    from sfm_tpu_torch import config as tconfig
    from sfm_tpu_torch.geometry.rotations import so3_exp
    from sfm_tpu_torch.geometry.similarity import umeyama_np
    from sfm_tpu_torch.pipeline import engine
    from sfm_tpu_torch.utils.interop import from_numpy_feature_set, from_numpy_graph
    from tests.integration.test_incremental import scene_to_features_and_graph

    scene = make_orbit_scene(num_cameras=cameras, num_points=points, radius=RADIUS, point_extent=1.2,
                             image_size=(1024, 1024), focal=PRIOR * (1 + offset), seed=1, arc_fraction=0.23)
    feats, graph = scene_to_features_and_graph(scene, max_kp=1024, max_matches=1024, noise=0.5, seed=2)
    intr = scene.intrinsics.copy()
    intr[:, :2] = PRIOR
    cfg = PipelineConfig(ba=BAConfig(refine_focal=refine, refine_distortion=refine), verbose=False)
    t0 = time.perf_counter()
    if package == "jax":
        rec = jengine.incremental_reconstruct(feats, graph, intr, cfg)
    else:
        rec = engine.incremental_reconstruct(
            from_numpy_feature_set(feats), from_numpy_graph(graph), intr,
            tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(cfg)), "cpu")
    seconds = time.perf_counter() - t0
    reg = np.where(rec.registered)[0]

    def centres(rv, tv):
        R = so3_exp(torch.from_numpy(np.asarray(rv[reg], np.float32))).numpy()
        return -np.einsum("kji,kj->ki", R, np.asarray(tv[reg], np.float64))

    est, gt = centres(rec.rvecs, rec.tvecs), centres(scene.rvecs, scene.tvecs)
    s, R, t = umeyama_np(est, gt)
    rmse = float(np.sqrt((((s * est @ R.T + t) - gt) ** 2).sum(-1).mean()))
    return dict(package=package, refine=refine, offset=offset, cameras=cameras, registered=len(reg),
                mean_reproj_px=float(rec.mean_reprojection_error()), camera_rmse_pct_radius=100 * rmse / RADIUS,
                focal_mean=float(rec.intrinsics[reg, 0].mean()), rendered_focal=PRIOR * (1 + offset),
                k1_worst=float(np.abs(rec.intrinsics[reg, 4]).max()), seconds=seconds)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cameras", type=int, default=20)
    parser.add_argument("--points", type=int, default=300)
    parser.add_argument("--offset", type=float, default=0.04)
    parser.add_argument("--no-refine", action="store_true")
    parser.add_argument("--package", choices=("both", "jax", "port"), default="both")
    args = parser.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    for package in (("jax", "port") if args.package == "both" else (args.package,)):
        print(json.dumps(run(package, args.cameras, args.points, args.offset, not args.no_refine)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
