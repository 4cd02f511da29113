#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (sfm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):
  1. device: the card's name and power limit; TF32 must be off;
  2. build: compile the kernels in sfm_tpu_torch/csrc with nvcc (sm_90a);
  3. kernels: each kernel of the two-view path against its plain PyTorch
     version on the card, at the path's shapes, with the tolerance stated,
     and the median time of both (CUDA events, 20+ runs);
  4. slice: sfm_tpu_torch.reconstruct on two rendered 1024x1024 images with
     the default config; 2 images registered, >= 100 points, mean
     reprojection error < 1 px, and every kernel launched by that run.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# Kernel name -> (source, the TPU kernel it replaces: file:line of pallas_call).
KERNELS = {
    "dog_extrema_scores": ("sfm_tpu_torch/csrc/dog_extrema.cu", "sfm_tpu/kernels/dog_extrema.py:111"),
    "match_topk2": ("sfm_tpu_torch/csrc/match_topk.cu", "sfm_tpu/kernels/match_topk.py:74"),
    "fused_ne_payloads": ("sfm_tpu_torch/csrc/ba_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:366"),
    "fused_cost_sums": ("sfm_tpu_torch/csrc/ba_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:524"),
    "cam_segment_sum": ("sfm_tpu_torch/csrc/ba_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:752"),
}
SLICE_IMAGE = 1024
SLICE_FOCAL = 1200.0
SLICE_BLOBS = 1500
SLICE_ARC = 0.015   # 5.4 degrees between the views: wide enough to triangulate,
                    # narrow enough for the blob descriptors to pass the ratio test


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, device, runs: int = 21) -> float:
    """Median milliseconds of fn() over `runs` timed calls (after a warm-up)."""
    import torch

    fn()
    if device.type != "cuda":
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_rel(a, b) -> tuple[float, float]:
    """(max |a - b|, that divided by max(|b|.max(), 1))."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1.0)


# ---- phase 3: kernels against their plain versions -------------------------


def check_dog(device, size: int):
    """K1 on the [1, 6, size, size] first octave of a uniform-noise image
    (dense in extrema): bit-exact."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.kernels import dog_extrema as k1
    from sfm_tpu_torch.ops.detect import pre_threshold
    from sfm_tpu_torch.ops.pyramid import build_pyramid

    cfg = SiftConfig(num_octaves=1, image_max_dim=size)
    img = np.random.default_rng(0).uniform(0, 1, (1, size, size)).astype(np.float32)
    gauss = build_pyramid(torch.from_numpy(img).to(device), cfg)[0].contiguous()
    pre = pre_threshold(cfg)
    out = k1.dog_extrema_scores(gauss, pre)
    ref = k1.dog_extrema_scores_plain(gauss, pre)
    n_ext = int((ref > 0).sum())
    if not torch.equal(out, ref) or n_ext == 0:
        raise AssertionError(f"dog_extrema_scores: not bit-exact ({int((out != ref).sum())} "
                             f"voxels differ, {n_ext} extrema)")
    return dict(max_abs_err=float((out - ref).abs().max()),
                ms=time_ms(lambda: k1.dog_extrema_scores(gauss, pre), device),
                plain_ms=time_ms(lambda: k1.dog_extrema_scores_plain(gauss, pre), device),
                note=f"exact, {n_ext} extrema")


def _planted_descriptors(device, n1: int, n2: int, seed: int):
    """da [1, n1, 128] noisy copies of rows of db [1, n2, 128]; the last
    n2 // 16 rows of db are invalid and hold NaN (padding must not leak)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    db = rng.normal(size=(1, n2, 128)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    src = rng.integers(0, n2, n1)
    da = db[:, src] + 0.05 * rng.normal(size=(1, n1, 128)).astype(np.float32)
    da /= np.linalg.norm(da, axis=-1, keepdims=True)
    vb = np.arange(n2)[None] < n2 - n2 // 16
    db[~vb] = np.nan
    return tuple(torch.from_numpy(a).to(device) for a in (da, db, vb))


def _compare_topk2(out, ref, what: str):
    import torch

    (d1, d2, idx), (r1, r2, ridx) = out, ref
    clear = (r2 - r1) > 1e-3
    if not torch.equal(idx[clear], ridx[clear]):
        raise AssertionError(f"match_topk2 {what}: {int((idx != ridx)[clear].sum())} argmin mismatches")
    for name, a, b in (("d1", d1, r1), ("d2", d2, r2)):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"match_topk2 {what} {name}: max err {float((a - b).abs().max())}")
    return int(clear.sum()), max(float((d1 - r1).abs().max()), float((d2 - r2).abs().max()))


def check_match(device, n: int):
    """K2 on n x n descriptors with planted correspondences (and once on
    ragged 1000 x 999 shapes): idx equal except near-ties (second distance
    within 1e-3 of the first), d1/d2 to rtol 1e-5 + atol 1e-5 (the kernel
    and the plain version sum the bf16 products in different orders)."""
    from sfm_tpu_torch.kernels import match_topk as k2

    ragged = _planted_descriptors(device, 1000, 999, seed=1)
    _compare_topk2(k2.match_topk2(*ragged), k2.match_topk2_plain(*ragged), "ragged")
    da, db, vb = _planted_descriptors(device, n, n, seed=0)
    n_clear, err = _compare_topk2(k2.match_topk2(da, db, vb), k2.match_topk2_plain(da, db, vb), f"{n}^2")
    return dict(max_abs_err=err,
                ms=time_ms(lambda: k2.match_topk2(da, db, vb), device),
                plain_ms=time_ms(lambda: k2.match_topk2_plain(da, db, vb), device),
                note=f"{n_clear}/{n} rows clear of near-ties; ragged 1000x999 also checked")


def slice_ba_problem(device, num_points: int):
    """The slice's BA shape: 2 cameras (C = 8 after padding), O = 4096 at
    num_points = 2000, perturbed so residuals and the robust loss matter."""
    import numpy as np

    from sfm_tpu_torch.ba.problem import build_problem
    from sfm_tpu_torch.scene.state import Reconstruction
    from sfm_tpu_torch.utils.synthetic import make_orbit_scene

    scene = make_orbit_scene(num_cameras=2, num_points=num_points, image_size=(SLICE_IMAGE,) * 2,
                             focal=SLICE_FOCAL, noise_px=0.5, seed=3, arc_fraction=SLICE_ARC)
    rng = np.random.default_rng(4)
    obs = np.argwhere(scene.visible)
    uv = scene.pixels[obs[:, 0], obs[:, 1]].copy()
    uv[rng.random(len(uv)) < 0.05] += rng.normal(0, 20, (1, 2)).astype(np.float32)  # outliers
    rec = Reconstruction(
        intrinsics=scene.intrinsics.copy(),
        rvecs=scene.rvecs + rng.normal(0, 0.01, (2, 3)).astype(np.float32),
        tvecs=scene.tvecs + rng.normal(0, 0.01, (2, 3)).astype(np.float32),
        registered=np.ones(2, bool),
        points=scene.points + rng.normal(0, 0.02, scene.points.shape).astype(np.float32),
        point_errors=np.zeros(num_points, np.float32), point_valid=np.ones(num_points, bool),
        obs_point=obs[:, 1].astype(np.int32), obs_image=obs[:, 0].astype(np.int32),
        obs_kp=obs[:, 1].astype(np.int32), obs_uv=uv.astype(np.float32),
    )
    prob, _, _ = build_problem(rec, device=device)
    return prob


def check_ba(device, num_points: int):
    """K3, K5 and K9 on the slice BA problem against their plain versions.
    Tolerances: K3 payloads 1e-4 of each block's max (closed-form vs
    matmul-composed Jacobians, fp32); K5 rtol 1e-5 (sum order); K9 2e-6 of
    the output's max against its plain version evaluated in float64 on the
    same values (the fp32 plain version on a GPU adds with atomics in an
    order that changes from run to run), which leaves the kernel's own fp32
    tree sum over ~2000 terms (bound log2(n) * eps of the summed magnitudes,
    ~7e-7). K9 must also give identical bits on a rerun."""
    import torch

    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.config import BAConfig
    from sfm_tpu_torch.kernels import ba_kernels as kb

    prob = slice_ba_problem(device, num_points)
    cfg = BAConfig()
    z = kb.projection(prob.cam_params[prob.obs_cam.long()], prob.intrinsics[prob.obs_cam.long()],
                      prob.points[prob.obs_point.long()], prob.obs_uv)["xc2"]
    zs = z[prob.obs_w > 0].sort().values
    z_floor = zs[len(zs) // 10].reshape(())                      # gates the nearest tenth
    inv = core.solve_invariants(prob, z_floor)
    args = (prob.obs_cam, core._pts_t(prob, prob.points), inv.static_t, prob.cam_params.contiguous(),
            prob.intrinsics, z_floor, cfg.robust_loss, cfg.robust_scale_px)
    O, C = prob.obs_w.shape[0], prob.num_cameras
    results = {}

    out = kb.fused_ne_payloads(*args)
    ne_ref = kb.fused_ne_payloads_plain(*args)
    errs = [max_rel(a, b) for a, b in zip(out, ne_ref)]
    if max(e[1] for e in errs) > 1e-4:
        raise AssertionError(f"fused_ne_payloads: relative errors {errs}")
    results["fused_ne_payloads"] = dict(
        max_abs_err=max(e[0] for e in errs),
        ms=time_ms(lambda: kb.fused_ne_payloads(*args), device),
        plain_ms=time_ms(lambda: kb.fused_ne_payloads_plain(*args), device),
        note=f"O={O} C={C}, rel err {max(e[1] for e in errs):.2e}")

    out = kb.fused_cost_sums(*args)
    ref = kb.fused_cost_sums_plain(*args)
    if not torch.allclose(out, ref, rtol=1e-5, atol=0.0):
        raise AssertionError(f"fused_cost_sums: {out.tolist()} vs {ref.tolist()}")
    if not float(out[1]) < float(prob.obs_w.sum()):
        raise AssertionError("fused_cost_sums: the near-plane gate removed nothing")
    results["fused_cost_sums"] = dict(
        max_abs_err=float((out - ref).abs().max()),
        ms=time_ms(lambda: kb.fused_cost_sums(*args), device),
        plain_ms=time_ms(lambda: kb.fused_cost_sums_plain(*args), device),
        note=f"O={O}, sums {out.tolist()}")

    cam_t = ne_ref[2]
    out = kb.cam_segment_sum(cam_t, inv.cam_perm, inv.cam_bounds)
    ref = kb.cam_segment_sum_plain(cam_t.double(), inv.cam_perm, inv.cam_bounds)
    err, rel = max_rel(out, ref)
    if rel > 2e-6:
        raise AssertionError(f"cam_segment_sum: relative error {rel}")
    again = kb.cam_segment_sum(cam_t, inv.cam_perm, inv.cam_bounds)
    if not torch.equal(out, again):
        raise AssertionError("cam_segment_sum: two runs differ (must be deterministic)")
    results["cam_segment_sum"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kb.cam_segment_sum(cam_t, inv.cam_perm, inv.cam_bounds), device),
        plain_ms=time_ms(lambda: kb.cam_segment_sum_plain(cam_t, inv.cam_perm, inv.cam_bounds), device),
        note=f"[{cam_t.shape[0]}, {O}] -> [{C}, {cam_t.shape[0]}], rel err {rel:.2e} vs the plain "
             "version in float64, deterministic")
    return results


# ---- phase 4: the slice -----------------------------------------------------


def run_slice(device, size: int, blobs: int, **overrides):
    """Two rendered size x size views of a 3D blob scene through
    sfm_tpu_torch.reconstruct; returns (reconstruction, launch counts of that
    call, wall seconds, ground-truth scene)."""
    from sfm_tpu_torch import kernels, reconstruct
    from sfm_tpu_torch.utils.synthetic import render_blob_scene

    t0 = time.perf_counter()
    imgs, scene = render_blob_scene(image_size=(size, size), num_images=2, num_blobs=blobs,
                                focal=SLICE_FOCAL * size / SLICE_IMAGE, arc_fraction=SLICE_ARC)
    log(f"[slice] rendered 2 x {size}^2 images with {blobs} blobs in {time.perf_counter() - t0:.2f}s")
    kernels.reset_launches()
    t0 = time.perf_counter()
    rec = reconstruct(list(imgs), device=device, **overrides)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    return rec, launches, wall, scene


def pose_errors_deg(rec, scene) -> tuple[float, float]:
    """(rotation error, translation direction error) of camera 1 relative to
    camera 0 against the scene's ground truth, degrees."""
    import numpy as np
    import torch

    from sfm_tpu_torch.geometry.projection import relative_pose
    from sfm_tpu_torch.geometry.rotations import so3_exp

    gt = [torch.from_numpy(np.asarray(a, np.float32))
          for a in (scene.rvecs[0], scene.tvecs[0], scene.rvecs[1], scene.tvecs[1])]
    rv_gt, t_gt = relative_pose(*gt)
    R = (so3_exp(torch.from_numpy(rec.rvecs[1])).T @ so3_exp(rv_gt)).numpy()
    rot = float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))
    t_est = rec.tvecs[1] / np.linalg.norm(rec.tvecs[1])
    t_ref = (t_gt / t_gt.norm()).numpy()
    return rot, float(np.degrees(np.arccos(np.clip(abs(t_est @ t_ref), -1, 1))))


def check_slice(rec, launches, scene, min_points: int = 100):
    """The bars of tests/integration/test_two_view.py (pose vs ground truth)
    plus chip_smoke's own: >= min_points points, < 1 px, all kernels used."""
    s = rec.summary()
    if s["num_registered"] != 2:
        raise AssertionError(f"slice: {s['num_registered']} images registered, expected 2")
    if s["num_points"] < min_points:
        raise AssertionError(f"slice: {s['num_points']} points, expected >= {min_points}")
    if not s["mean_reproj_error_px"] < 1.0:
        raise AssertionError(f"slice: mean reprojection error {s['mean_reproj_error_px']} px")
    if not (abs(rec.points[rec.point_valid]) < 1e6).all():
        raise AssertionError("slice: non-finite or runaway points")
    rot, trans = pose_errors_deg(rec, scene)
    if not (rot < 2.0 and trans < 8.0):
        raise AssertionError(f"slice: pose error {rot:.3f} deg rotation, {trans:.3f} deg translation")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"slice: kernels never launched by the main path: {missing}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from sfm_tpu_torch import kernels

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} | torch {torch.__version__} cuda {torch.version.cuda} | {smi}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off (sfm_tpu_torch/__init__.py)")

    kernels.library()
    log(f"[build] kernels built and loaded in {kernels.build_seconds:.2f}s")

    results = {"dog_extrema_scores": check_dog(device, SLICE_IMAGE),
               "match_topk2": check_match(device, 4096)}
    results.update(check_ba(device, 2000))
    for k, r in results.items():
        log(f"[kernel] {k}: max_abs_err {r['max_abs_err']:.3e} | kernel {r['ms']:.4f} ms | "
            f"plain {r['plain_ms']:.4f} ms | {r['note']}")

    rec, launches, wall, scene = run_slice(device, SLICE_IMAGE, SLICE_BLOBS)
    log(f"[slice] reconstruct wall {wall:.2f}s | stages " +
        ", ".join(f"{k} {v:.3f}s" for k, v in rec.stage_seconds.items()))
    log(f"[slice] summary {json.dumps(rec.summary())}")
    log(f"[slice] launches {json.dumps(launches)}")
    log("[slice] relative pose error vs ground truth: %.4f deg rotation, %.4f deg translation"
        % pose_errors_deg(rec, scene))
    check_slice(rec, launches, scene)

    record = {"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
         "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
        for k in KERNELS]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
