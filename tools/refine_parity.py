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

    JAX_PLATFORMS=cpu python3 tools/refine_parity.py --features F.npz [...] [--no-refine]

runs both packages' incremental engines on features of rendered views
instead: the files tools/torch_perf.py ringfeatures writes (chip_smoke.py
phase 11's 46-view ring at a focal offset, extracted and matched once by
the port on the card), the same keypoints and verified graph for both. Each
line adds every bundle adjustment's width and LM iterations (how many
stopped at the iteration cap).

    JAX_PLATFORMS=cpu python3 tools/refine_parity.py --merged [--cameras 4224] [--points 6600]

runs both packages' refined global BA (the engine's build_problem with
refine_intrinsics, then bundle_adjust at the default BA config, focal and
k1 refined) on chip_smoke.py phase 13's geometry cut in camera count: its
merged ring model (chip_smoke.arc_ring_reconstruction, tracks of 40-150
views, 1% gross outliers) with every focal at 0.96x the rendered 400; at
the defaults ~150 observations a camera, as on the card's 10,240 cameras,
and past 4,096 cameras, so the port takes its 8-wide large-camera route.
One JSON line per package: the focal error of the non-gauge cameras
against the rendered focal (median, worst), the largest |k1|, the mean
reprojection error of the non-outlier observations, the camera-centre
RMSE after Sim(3) alignment, the cost, LM iterations and seconds.
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


class _BALog:
    """Every bundle_adjust of a package's engine: (width, cameras, LM
    iterations), by wrapping the package's BA entry for the duration."""

    def __init__(self, module):
        self.module, self.rows = module, []

    def __enter__(self):
        inner = self.inner = self.module.bundle_adjust

        def wrapped(prob, cfg):
            out, stats = inner(prob, cfg)
            self.rows.append((int(prob.cam_params.shape[-1]), int(prob.cam_params.shape[0]),
                              int(stats.iterations)))
            return out, stats

        self.module.bundle_adjust = wrapped
        return self

    def __exit__(self, *exc):
        self.module.bundle_adjust = self.inner

    def summary(self, cap: int) -> dict:
        its = [r[2] for r in self.rows]
        return dict(bas=len(self.rows), bas_8_wide=sum(r[0] == 8 for r in self.rows), lm_iterations=sum(its),
                    bas_at_cap=sum(i >= cap for i in its), global_ba_iterations=[r[2] for r in self.rows if r[0] == 8])


def run_features(package: str, path: str, refine: bool) -> dict:
    import numpy as np
    import torch

    import sfm_tpu.ba as jba
    from sfm_tpu.config import BAConfig, PipelineConfig, config_to_dict
    from sfm_tpu.pipeline import engine as jengine
    from sfm_tpu.pipeline.stages import FeatureSet as JFeatureSet, MatchGraph as JMatchGraph
    import sfm_tpu_torch.ba as tba
    from sfm_tpu_torch import config as tconfig
    from sfm_tpu_torch.geometry.rotations import so3_exp
    from sfm_tpu_torch.geometry.similarity import umeyama_np
    from sfm_tpu_torch.pipeline import engine
    from sfm_tpu_torch.utils.interop import from_numpy_feature_set, from_numpy_graph

    z = np.load(path)
    B, N = z["valid"].shape
    feats = JFeatureSet(xy=z["xy"], sigma=np.zeros((B, N), np.float32), angle=np.zeros((B, N), np.float32),
                        response=np.zeros((B, N), np.float32), desc=np.zeros((B, N, 128), np.float32),
                        valid=z["valid"])
    graph = JMatchGraph(**{k[len("graph_"):]: z[k] for k in z.files if k.startswith("graph_")})
    cfg = PipelineConfig(ba=BAConfig(refine_focal=refine, refine_distortion=refine), verbose=False)
    t0 = time.perf_counter()
    with _BALog(jba if package == "jax" else tba) as log:
        if package == "jax":
            rec = jengine.incremental_reconstruct(feats, graph, z["intrinsics"], cfg)
        else:
            rec = engine.incremental_reconstruct(
                from_numpy_feature_set(feats), from_numpy_graph(graph), z["intrinsics"],
                tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(cfg)), "cpu")
    seconds = time.perf_counter() - t0
    reg = np.where(rec.registered)[0]

    def centres(rv, tv):
        R = so3_exp(torch.from_numpy(np.asarray(rv[reg], np.float32))).numpy()
        return -np.einsum("kji,kj->ki", R, np.asarray(tv[reg], np.float64))

    est, gt = centres(rec.rvecs, rec.tvecs), centres(z["true_rvecs"], z["true_tvecs"])
    s, R, t = umeyama_np(est, gt)
    rmse = float(np.sqrt((((s * est @ R.T + t) - gt) ** 2).sum(-1).mean()))
    rendered = float(z["rendered_focal"])
    return dict(package=package, features=os.path.basename(path), refine=refine, rendered_focal=rendered,
                prior_focal=float(z["intrinsics"][0, 0]), registered=len(reg), views=B,
                mean_reproj_px=float(rec.mean_reprojection_error()),
                camera_rmse_pct_radius=100 * rmse / float(z["radius"]),
                focal_mean=float(rec.intrinsics[reg, 0].mean()),
                focal_rel=float(rec.intrinsics[reg, 0].mean()) / rendered - 1.0,
                k1_worst=float(np.abs(rec.intrinsics[reg, 4]).max()), seconds=seconds,
                **log.summary(cfg.ba.max_iterations))


def run_merged(package: str, cameras: int, points: int) -> dict:
    import numpy as np

    import chip_smoke as cs
    from sfm_tpu.ba import build_problem as jbuild_problem
    from sfm_tpu.ba import core as jcore
    from sfm_tpu.ba import writeback as jwriteback
    from sfm_tpu.config import BAConfig, config_to_dict
    from sfm_tpu.scene.state import Reconstruction as JReconstruction
    from sfm_tpu_torch import config as tconfig
    from sfm_tpu_torch.ba import build_problem, core, writeback

    rec, truth = cs.arc_ring_reconstruction(cameras, points, cs.POLISH_TRACKS, seed=3,
                                            centre_noise=cs.POLISH_CENTRE_NOISE)
    focal = float(rec.intrinsics[0, 0])
    rec.intrinsics[:, :2] *= cs.REFINED_BA_FOCAL
    cfg = BAConfig(refine_focal=True, refine_distortion=True)
    t0 = time.perf_counter()
    if package == "jax":
        fields = ("intrinsics", "rvecs", "tvecs", "registered", "points", "point_errors", "point_valid",
                  "obs_point", "obs_image", "obs_kp", "obs_uv")
        jrec = JReconstruction(**{f: np.copy(getattr(rec, f)) for f in fields})
        prob, cams, pids = jbuild_problem(jrec, refine_intrinsics=True)
        out, stats = jcore.bundle_adjust(prob, cfg)
        jwriteback(jrec, out, cams, pids)
        for f in ("intrinsics", "rvecs", "tvecs", "points"):
            setattr(rec, f, np.asarray(getattr(jrec, f)))
    else:
        prob, cams, pids = build_problem(rec, refine_intrinsics=True, device="cpu")
        out, stats = core.bundle_adjust(prob, tconfig.config_from_dict(tconfig.BAConfig, config_to_dict(cfg)))
        writeback(rec, out, cams, pids)
    seconds = time.perf_counter() - t0
    rel = np.abs(rec.intrinsics[cams[1:], 0] / focal - 1.0)
    return dict(package=package, cameras=cameras, padded_cameras=int(prob.num_cameras),
                observations=int(np.asarray(prob.obs_w).sum()), rendered_focal=focal,
                prior_focal=cs.REFINED_BA_FOCAL * focal, focal_median_rel=float(np.median(rel)),
                focal_worst_rel=float(rel.max()), k1_worst=float(np.abs(rec.intrinsics[cams, 4]).max()),
                inlier_px=cs.inlier_reprojection_px(rec, truth),
                camera_rmse_pct_radius=100 * cs.camera_rmse(rec, truth) / truth.radius,
                initial_cost=float(stats.initial_cost), final_cost=float(stats.final_cost),
                lm_iterations=int(stats.iterations), seconds=seconds)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cameras", type=int, help="default 20, with --merged 4224")
    parser.add_argument("--points", type=int, help="default 300, with --merged 6600")
    parser.add_argument("--offset", type=float, default=0.04)
    parser.add_argument("--no-refine", action="store_true")
    parser.add_argument("--package", choices=("both", "jax", "port"), default="both")
    parser.add_argument("--features", nargs="+", metavar="NPZ",
                        help="run the engines on these files of tools/torch_perf.py ringfeatures")
    parser.add_argument("--merged", action="store_true", help="phase 13's refined global BA, cut in cameras")
    args = parser.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    for package in (("jax", "port") if args.package == "both" else (args.package,)):
        if args.merged:
            print(json.dumps(run_merged(package, args.cameras or 4224, args.points or 6600)), flush=True)
        elif args.features:
            for path in args.features:
                print(json.dumps(run_features(package, path, not args.no_refine)), flush=True)
        else:
            print(json.dumps(run(package, args.cameras or 20, args.points or 300, args.offset,
                                 not args.no_refine)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
