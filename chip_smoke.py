#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (sfm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):
  1. device: the card's name and power limit; TF32 must be off;
  2. build: compile the kernels in sfm_tpu_torch/csrc (one nvcc per source,
     all at once, sm_90a);
  3. features kernels: K1 and K2 against their plain PyTorch versions on
     the card at the slices' shapes (K1 bit-exact on a [1, 6, 1024, 1024]
     octave, and untimed on a ragged [3, 6, 200, 328], an L = 4 stack, W % 4
     != 0, an offset view and 8 x 8; K2 on one pair and on a block of 32
     pairs of 4096 x 4096, on ragged shapes, on a batch whose pairs differ
     in validity, one of them without a valid column, and on fewer columns
     than one tile; both once more, after the incremental slice, at the
     shapes that run handed them, K1 on the stacks it was handed);
  4. two-view slice: sfm_tpu_torch.reconstruct on two rendered 1024x1024
     images with the default config; 2 images registered, >= 100 points,
     mean reprojection error < 1 px, pose against the ground truth, and
     every kernel of that path launched by that run; then K3, K5 and K9 on
     the BA problem that run solved;
  5. incremental slice: sfm_tpu_torch.reconstruct on a rendered ring of
     1024x1024 views with the default config; >= 95% of the images
     registered, mean reprojection error < 1 px, camera-centre RMSE after
     Sim(3) alignment < 1% of the orbit radius, the final global BA on the
     PCG branch, and the seven kernels of that path launched by that run
     (pcg_solve, the whole PCG solve in one launch, in place of the
     coupling-only K11, which must not launch: its device code runs inside
     pcg_solve; K7 as the Schur-Jacobi blocks that K3 builds for a PCG
     solve); then K3, K5, K9, K7 (the standalone entry and the blocks out of
     K3) and K11 on that final BA's problem, K3
     and K5 on the run's last dense local BA, and K7 and K11 once more on an
     orbit problem with long tracks; K3 and K5 on the final BA beside the
     chains of launches they replace (device launches, device and event
     time per call, launches per LM iteration: the "[lm]" line); pcg_solve
     on both problems, on the orbit problem once more in its streaming mode,
     and on a wide orbit of 1024 cameras (more cameras than blocks: resident,
     streaming, and on a grid of 8 blocks); extract_features on the ring's
     first chunk of 8 views with use_pallas True and False (every Features
     tensor identical), K12 on the keypoints and gradients of that chunk's
     four octaves (one launch a call, within 1e-5 of its plain version,
     timed beside its bound: the "[descriptors]" line), K13 on each octave
     call of build_pyramid over that chunk and over 8 noise views of 256^2
     (the last octave, 32, reads whole rows: one launch a call, within
     1e-6 of its plain version, timed beside its bound and the two
     torch.matmul it replaces: the "[blur]" line), K14 on each octave
     call of extract_features over that chunk, over the 2048^2 octave of
     its first two views upsampled and over three of its views at 200^2
     (one launch a call; at most 1e-3 of the live candidates differ from
     the plain version in valid, by 1e-4 px / level or by 1e-5 relative
     in response; timed beside its bound: the "[refine]" line), K15 on
     the same octave calls (one launch a call; the selection bit-equal to
     top_k_stable's and the kernel's keys to its plain version's; timed
     beside its bound, the plain version and the full sort it replaced:
     the "[select]" line); the
     split of the feature stage's device time by part is the program's
     spans' (python3
     -m portbench.run --workload r16k-features --seed N --seconds 51
     --trace 1), not this script's;
  6. divide-and-conquer slice: the same views through reconstruct with
     partition.enabled (clusters of 40 + 10 of overlap, the incremental
     engine inside, every other field default): >= 95% registered, < 1 px,
     camera RMSE < 3% of the radius, two or more clusters merged, the merged
     polish on the PCG branch, the same seven kernels launched (and the
     coupling-only K11 not); then pcg_solve on the first merged polish
     (x against the float64 iterate after PCG_X_STEPS steps);
  7. global-engine slice: the first 24 views through reconstruct with
     engine_mode="global": every image registered, < 1 px, camera RMSE < 3%
     of the radius;
  8. merged-model polish at full width: a synthetic merged model of 10,240
     cameras and about 1.5 M observations (tracks of 40-150 views, 0.5 px
     noise, 1% gross outliers, perturbed poses and points) through the
     pipeline's own _merged_polish with the default config: K4, K6, K8,
     pcg_solve_big (every CG solve in one launch, K10's coupling code
     inside) and K9 launched, and nothing else (not the coupling-only K10
     entry, not the small-C kernels); every solve's cost falls; < 1 px
     afterwards; the camera RMSE falls and ends under 1% of the radius; the
     gross outliers dropped; then K4, K6, K8 and K10 on the first solve's
     problem, each timed beside its small-camera-count twin, pcg_solve_big
     on the same problem as check_pcg holds pcg_solve (x after PCG_X_STEPS
     steps) beside the loop over K10 and K9 it replaced, and the polish's
     LM iteration (device launches and device time per LM iteration: the
     "[lm] merged polish" line);
  9. config #3 from image files: the incremental ring's scene at its
     spacing with 96 views (arc fraction 0.48; 128, South Building's count,
     before phase 14 joined the time limit), each written as an 8-bit
     binary PGM into a temporary directory, through
     sfm_tpu_torch.cli.main(["reconstruct", DIR, "--out", OUT,
     'pair_mode="vocab_tree"']) in this process, every other field default:
     streaming decode, K1, the vocab tree, K2 on the vocab pairs, densify
     (K2 on the ladder pairs), the incremental engine, COLMAP text + bin +
     PLY; >= 95% registered, < 1 px, camera RMSE < 1% of the radius, fewer
     candidate pairs than exhaustive, the final global BA on PCG, the
     engine's kernels launched, and read_colmap_bin(OUT/sparse) equal to
     the Reconstruction's cameras, images and points; then the same command
     again on the same OUT: no stage may run (the streamed feature stage,
     the match stage and the incremental engine raise if called) and the
     model and PLY must come out byte-identical; the idle share of the
     path's vocab retrieval and of one match block (the "[vocab]" line);
 10. the off-by-default paths: the two-view slice's views through
     reconstruct with sift.upsample_first_octave, match.guided and
     ransac.model="fundamental": the two-view bars and kernels, then K1 on
     every stack that run handed it (the [2, 6, 2048, 2048] upsampled octave
     among them), bit-exact and timed ("options" rows of K1's shapes), and
     bit-exact on the upsampled octave of two noise images (dense extrema);
 11. intrinsics refinement at full width, the only path of 8-wide camera
     blocks (rvec, tvec, log focal scale, dk1): (a) phase 5's
     reconstruction through build_problem(refine_intrinsics=True) (C = 128,
     O = 65,536 padded, the PCG branch), where the 8-wide builds of K3
     (without and with the Schur-Jacobi blocks), K5 (cost, step, and the
     step under each freeze setting: the candidate points bit-identical
     across them, the frozen columns unmoved), K7 and K11 standalone,
     pcg_solve and K9 at 8, 72 and 108 rows are held and timed as check_ba,
     check_schur, check_pcg and check_segment_sum hold the 6-wide ones;
     (b) that problem, and the orbit problem without outliers (C = 128,
     O = 65,536), with every focal at 0.96 x the rendered one and k1 = 0
     through bundle_adjust with focal and k1 refined: < 1 px, the 8-wide
     K3, K5 and pcg_solve launched and no plain version handed a CUDA
     tensor (forbid_plain); on the orbit the non-gauge focals within 1.5%
     of the rendered 1200 and |k1| < 0.01 (the ring's shallow, narrow view
     leaves them nearly unobservable: reported); each BA 6 and 8 wide at
     the rendered focal, timed; (c) 46 views of phase 5's blobs (arc 0.23)
     rendered at 1.04 x the 1228.8 the ingest assumes, through reconstruct
     with ba.refine_focal and ba.refine_distortion: >= 95% registered,
     < 1 px, camera RMSE < 3% of the radius, the mean refined focal nearer
     the rendered one than the prior, the global BAs 8 wide and the local
     ones 6 wide, no plain version on the card;
 12. several devices, on the one card: the process joins a one-process
     NCCL group through dist.mesh (initialize_multihost, make_mesh) and
     holds each multi-device route against the single-card one: (a) DP
     extraction of phase 11's 46 views (every Features array identical);
     (b) stages.ring_match_pairs, the ring matcher (K2), against the block
     matcher on every pair (the same pairs, indices and masks); (c) the
     match + verify stage as a multi-device run calls it (the ring's
     matches, pair-sharded) against the single-card graph on the ring's
     first 256 pairs (identical); (d)
     bundle_adjust_sharded on phase 5's final global BA problem at 6 and 8
     wide and (e) on phase 8's merged polish problem for 3 LM iterations
     (its cost falling at each) against bundle_adjust: final cost within
     rtol 1e-3, poses within 5e-3 (tests/distributed/test_sharding.py's
     bars; rotations, and camera centres after a Sim(3) alignment: the
     scale is free), a rerun bit-identical, no plain version on the card, K3's
     sharded mode (fused_ne_sums) and both halves of K11
     (coupling_point_half, coupling_camera_half) launched; (f) those three
     entries against their plain versions in float64 at (d)'s and (e)'s
     shapes, timed; (g) the sharded LM's steps and one sharded solve under
     torch.profiler (the "[lm] sharded LM" lines);
 13. the refined polish, 8-wide camera blocks past 4,096 cameras (run
     before phase 12, which shards its problem): (a) phase 8's merged
     model as it was built, every focal at 0.96 x the rendered 400, through
     the engine's global BA with ba.refine_focal and ba.refine_distortion
     (pipeline/engine.py _run_ba's three calls: build_problem with
     refine_intrinsics, dispatch_bundle_adjust, writeback), default BA
     config: the 8-wide K4, K6, K8, pcg_solve_big and K9 launched and
     nothing else, no plain version on the card, the cost falls, the
     observations that are not gross outliers < 1 px afterwards; the focal
     error (median, worst), max |k1| and the camera RMSE reported with no
     bar; (b) the 8-wide K4, K6, K8 and K10 on that BA's problem against
     their plain versions at phase 8's bars (check_big), each timed beside
     the 6-wide twin of phase 8, and pcg_solve_big 8 wide as check_pcg
     holds it (x after PCG_X_STEPS steps, beside the loop over K10 and K9);
     (c) in phase 12's group, bundle_adjust_sharded on that problem for 3
     LM iterations against bundle_adjust, at phase 12's bars;
 14. config #4 from files (BASELINE.json: a landmark scene of 1-2k views):
     (a) benchmarks/ladder.py's scene at 1,000 views (256^2, 600 blobs,
     focal 307.2, a full orbit of radius 4) written as PGM files and run
     through cli.main(["reconstruct", DIR, "--out", OUT, ...]) with the
     ladder's fields as overrides (vocab pairs, partition into clusters of
     62 + 16, four threads of global-engine clusters, ba.max_iterations 15,
     the n-scaled capacities), inside forbid_plain (every kernel module's
     plain versions); (b) >= 990 of 1,000 registered, < 1.0 px, camera
     RMSE < 0.5% of the radius, the global_sfm and partition.* stages
     timed, >= 8 clusters reconstructed on more than one thread, the
     polish on the PCG branch over >= 950 cameras, K1, K2, K3 (with K7's
     blocks), K5, K9 and pcg_solve launched and neither the coupling-only
     K11 nor any large-camera kernel, no plain version on the card, the
     COLMAP binary read back equal; (c) K1 on every stack and K2 on the
     first pair block of each shape the run handed them, K3, K5, K9 and
     pcg_solve on the polish's own problem, each held and timed; (d) the
     "[config4]" line: stage seconds, pairs, clusters built, reconstructed,
     gated in and merged, rescued images, the idle share of the largest
     cluster BA and of one match block, the phase's seconds.
Each kernel check holds the kernel against its plain version with the
tolerance stated and takes the median time of the kernel, the plain version
and (where one PyTorch call computes the same function) that call (CUDA
events, TIMED_RUNS runs), and the least time the card could take (bytes over
3.35 TB/s or operations over the peak rate, whichever is larger). K9 is
held and timed on each BA problem's own segment tables on both sides: the
camera side (a permutation) for K = 6, 36 and 42 rows, the point side
(sorted) for K = 3 and 9, bit-identical on a rerun. pcg_solve is held
against its plain version in float64 and timed beside `loop_ms`, the same
solve as Python steps over the coupling-only K11 (K10 then K9 for
pcg_solve_big). Every row also carries its device time per call
(`device_ms`, torch.profiler). The record (32 rows) reports K1-K3,
K5, K7, K9, K11, K12, K13, K14 and pcg_solve at the incremental slice's shapes, K4, K6,
K8, K10 and pcg_solve_big at the merged polish's, the 8-wide K3, K5, K7,
K11 and pcg_solve (`*_w8`) at phase 11's, the 8-wide K4, K6, K8, K10 and
pcg_solve_big at phase 13's, K3's sharded mode and the two
halves of K11 at both widths at phase 12's (the 6-wide ones at the merged
polish's too, under `shapes`), every kernel's launches on each
path (two_view, incremental, partition, global, vocab, options,
merged_polish, refined_ba, refined_orbit_ba, refined, refined_polish, config4,
sharded; `launches` is the largest of them;
K11's rows count the launches of pcg_solve and K10's those of
pcg_solve_big, which run their code, at either width; K7's count K3's
launches that build the Schur-Jacobi blocks), K7's
K3 times without and with the blocks (`k3_ms`, `k3_device_ms`), and for
K1, K2, K3, K5, K9, K12, K13, K14 and pcg_solve a row per timed shape under
`shapes` (phase 14's among them).
The line before the last two is the kernels' JSON record, then the card's
name and power limit; the last line is {"ok": true, "device": {...}}.
On every path K13 and K14 launch as often as K1 (once per octave call of the
feature stage), and no path hands K13's plain version a CUDA tensor where
forbid_plain watches. Without a CUDA device the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

from portbench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S

# Kernel name -> (source, the TPU kernel it replaces: file:line of pallas_call).
KERNELS = {
    "dog_extrema_scores": ("sfm_tpu_torch/csrc/dog_extrema.cu", "sfm_tpu/kernels/dog_extrema.py:111"),
    # K12 replaces no TPU kernel: sfm_tpu's descriptors are plain JAX.
    "sift_descriptors": ("sfm_tpu_torch/csrc/sift_descriptors.cu",
                         "none (sfm_tpu/ops/descriptor.py is plain JAX)"),
    # K13 replaces no TPU kernel: sfm_tpu's pyramid blurs with dense products.
    "blur_levels": ("sfm_tpu_torch/csrc/blur_levels.cu", "none (sfm_tpu/ops/pyramid.py is plain JAX)"),
    # K14 replaces no TPU kernel: sfm_tpu's refinement is plain JAX.
    "subpixel_refine": ("sfm_tpu_torch/csrc/subpixel_refine.cu",
                        "none (sfm_tpu/ops/detect.py refine_candidates is plain JAX)"),
    # K15 replaces no TPU kernel: sfm_tpu's candidate selection is jax.lax.top_k.
    "select_keys": ("sfm_tpu_torch/csrc/select_candidates.cu",
                    "none (sfm_tpu/ops/detect.py select_candidates is jax.lax.top_k)"),
    "match_topk2": ("sfm_tpu_torch/csrc/match_topk.cu", "sfm_tpu/kernels/match_topk.py:74"),
    "fused_ne_payloads": ("sfm_tpu_torch/csrc/ba_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:366"),
    "fused_cost_sums": ("sfm_tpu_torch/csrc/ba_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:524"),
    "cam_segment_sum": ("sfm_tpu_torch/csrc/ba_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:752"),
    "whw_cam_reduce": ("sfm_tpu_torch/csrc/schur_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:639"),
    "schur_coupling_matvec": ("sfm_tpu_torch/csrc/schur_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:975"),
    "fused_ne_payloads_big": ("sfm_tpu_torch/csrc/ba_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:423"),
    "fused_cost_sums_big": ("sfm_tpu_torch/csrc/ba_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:565"),
    "whw_payloads_big": ("sfm_tpu_torch/csrc/schur_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:682"),
    "schur_coupling_payloads_big": ("sfm_tpu_torch/csrc/schur_kernels.cu",
                                    "sfm_tpu/kernels/schur_spmv.py:935"),
    # The whole PCG solve over K11's device code: the fori_loop of _pcg.
    "pcg_solve": ("sfm_tpu_torch/csrc/schur_kernels.cu",
                  "sfm_tpu/kernels/schur_spmv.py:975 + sfm_tpu/ba/core.py:858"),
    # The same kernel past 4096 cameras (streaming mode) over K10's device code.
    "pcg_solve_big": ("sfm_tpu_torch/csrc/schur_kernels.cu",
                      "sfm_tpu/kernels/schur_spmv.py:935 + sfm_tpu/ba/core.py:858"),
}
# The 8-wide builds of K3, K5, K7, K11 and pcg_solve (intrinsics
# refinement: the same sources, each a C entry of its own, counted under
# `<name>_w8`), which only phase 11 runs.
WIDE_KERNELS = tuple(f"{k}_w8" for k in ("fused_ne_payloads", "fused_cost_sums", "whw_cam_reduce",
                                         "schur_coupling_matvec", "pcg_solve"))
KERNELS.update({k: KERNELS[k.removesuffix("_w8")] for k in WIDE_KERNELS})
# The camera-sharded LM's entries (phase 12 alone launches them): K3's
# sharded mode and K11 cut at h, at both widths.
KERNELS.update({
    "fused_ne_sums": ("sfm_tpu_torch/csrc/ba_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:366"),
    "coupling_point_half": ("sfm_tpu_torch/csrc/schur_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:975"),
    "coupling_camera_half": ("sfm_tpu_torch/csrc/schur_kernels.cu", "sfm_tpu/kernels/schur_spmv.py:975"),
})
KERNELS.update({f"{k}_w8": KERNELS[k] for k in ("fused_ne_sums", "coupling_point_half",
                                                 "coupling_camera_half")})
# The large-camera-count BA set (more than 4096 cameras) and the set that
# serves the engines' problems; K9 cam_segment_sum reduces for both.
BIG_KERNELS = ("fused_ne_payloads_big", "fused_cost_sums_big", "whw_payloads_big",
               "schur_coupling_payloads_big", "pcg_solve_big")
# Their 8-wide builds, which only phase 13 (the refined polish) runs.
BIG_WIDE_KERNELS = tuple(f"{k}_w8" for k in BIG_KERNELS)
KERNELS.update({k: KERNELS[k.removesuffix("_w8")] for k in BIG_WIDE_KERNELS})
SMALL_KERNELS = tuple(k for k in KERNELS if k not in BIG_KERNELS + WIDE_KERNELS + BIG_WIDE_KERNELS
                      and not k.startswith(("fused_ne_sums", "coupling_")))
# Kernels whose device code runs inside another launch on the main path, by
# the count of that launch: K11's coupling inside pcg_solve, K10's inside
# pcg_solve_big. Their coupling-only entries launch on no path. (K7's code
# runs inside K3's launches for a PCG solve, and fused_ne_payloads counts
# those launches for whw_cam_reduce itself.)
INSIDE = {"schur_coupling_matvec": "pcg_solve", "schur_coupling_payloads_big": "pcg_solve_big",
          "schur_coupling_matvec_w8": "pcg_solve_w8",
          "schur_coupling_payloads_big_w8": "pcg_solve_big_w8"}
# An 8-wide global BA on the PCG branch: K3 with the blocks (counted for
# K7 too), K5 and pcg_solve at width 8.
REFINED_PCG_KERNELS = ("fused_ne_payloads_w8", "fused_cost_sums_w8", "whw_cam_reduce_w8", "pcg_solve_w8")
# The engines' PCG solves launch pcg_solve and K3 with the Schur-Jacobi
# blocks (counted for K7).
ENGINE_KERNELS = tuple(k for k in SMALL_KERNELS if k not in INSIDE)
# The merged polish: the large-C set, the CG solve in one pcg_solve_big
# launch, K9.
POLISH_KERNELS = tuple(k for k in BIG_KERNELS if k not in INSIDE) + ("cam_segment_sum",)
# The refined polish (phase 13): the same at width 8.
REFINED_POLISH_KERNELS = tuple(k for k in BIG_WIDE_KERNELS if k not in INSIDE) + ("cam_segment_sum",)
TWO_VIEW_KERNELS = ("dog_extrema_scores", "sift_descriptors", "blur_levels", "subpixel_refine", "select_keys",
                    "match_topk2",
                    "fused_ne_payloads", "fused_cost_sums", "cam_segment_sum")
# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit); the
# tensor cores' bf16 rate has no counterpart in portbench.peaks.
BF16_TENSOR_OPS_PER_S = 989e12
SLICE_IMAGE = 1024
SLICE_FOCAL = 1200.0
SLICE_BLOBS = 1500
SLICE_ARC = 0.015   # 5.4 degrees between the views: wide enough to triangulate,
                    # narrow enough for the blob descriptors to pass the ratio test
# The incremental slice: 100 views on a half ring (1.8 degrees apart) around
# 1500 blobs, radius 7, focal 1228.8 (the prior ingest assumes without EXIF,
# 1.2 x the long side). Sized so that the final global BA's padded problem
# (C = 128 cameras, O = 65536) crosses the unchanged dense gate (C * O > 4M)
# and takes PCG while every earlier BA stays dense; tools/torch_perf.py
# scene compares the candidates (PERF.md).
INC_IMAGES = 100
INC_BLOBS = 1500
INC_ARC = 0.5
INC_FOCAL = 1228.8
INC_RADIUS = 7.0
# The divide-and-conquer slice: the same ring in clusters of 40 + 10 of overlap.
PART_CLUSTER = 40
PART_OVERLAP = 10
# The merged-model polish at full width: 10,240 cameras, 16,000 points in
# tracks of 40-150 views (about 1.5 M observations).
POLISH_CAMERAS = 10240
POLISH_POINTS = 16000
POLISH_TRACKS = (40, 150)
# Camera centres start 2 units (two camera spacings) off, each on its own:
# above the ~1 unit that 0.5 px of pixel noise leaves in the ring's
# low-frequency modes, so that the polish has an error to remove.
POLISH_CENTRE_NOISE = 2.0
# The global-engine slice: the first views of the same ring spacing.
GLOBAL_IMAGES = 24
# pcg_solve's wide orbit: 1024 cameras, each seeing all 120 points, so that
# the card's grid gives every block 7-8 cameras and a grid of 8 blocks 128
# (two passes of its 64 lane groups).
WIDE_CAMERAS = 1024
WIDE_POINTS = 120
WIDE_BLOCKS = 8
# check_pcg compares x with the float64 iterate after this many steps on the
# first merged polish (every other problem: after all cfg.cg_iterations).
PCG_X_STEPS = 8
# kernels/ba_kernels.NE_CAM_ROWS: rows of the camera payload K3/K4 hand to K9.
NE_CAM_ROWS = 42
# Phase 11, intrinsics refinement: the final global BA's problem of phase 5,
# and the orbit problem without outliers (REFINED_ORBIT: C = 128, O =
# 65,536, every point in ~100 views), each with every focal set to
# REFINED_BA_FOCAL of the rendered one and k1 = 0 (the orbit must recover
# both, within REFINED_FOCAL_BAR and 0.01); then a ring of REFINED_IMAGES
# views (config #2's Temple Ring count) at phase 5's spacing, rendered at
# (1 + REFINED_FOCAL_OFFSET) x the focal the ingest assumes (1.2 x 1024 =
# INC_FOCAL), so that its prior is that far off: its camera RMSE within
# REFINED_RMSE_BAR of the radius and its refined focal nearer the truth
# than the prior. Phase 5's blob ring, a narrow field of view over a shallow
# scene, leaves the per-camera focal and k1 nearly unobservable (refined
# from a correct prior they drift ~4%; on synthetic features of that
# geometry the port's engine matches sfm_tpu's, tools/refine_parity.py:
# PERF.md), so the recovery bars sit on the orbit.
REFINED_BA_FOCAL = 0.96
REFINED_ORBIT = (100, 500)
REFINED_IMAGES = 46
REFINED_ARC = 0.23
REFINED_FOCAL_OFFSET = 0.04
REFINED_FOCAL_BAR = 0.015
REFINED_RMSE_BAR = 0.03
REFINED_OVERRIDES = {"ba.refine_focal": True, "ba.refine_distortion": True}
# Per-shape rows of a kernel that is timed at several shapes (K1, K2, K9;
# K1's carry the calls the incremental slice made at that shape).
SHAPE_FIELDS = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "calls")
PCG_FIELDS = ("loop_ms", "loop_device_ms")
# Shared memory of one H100 SXM: 132 SMs of 227 KB a block. What a CG step
# reads beyond it comes from device memory again every step (check_pcg's
# bound).
SMEM_BYTES = 132 * 232448

def log(msg: str) -> None:
    print(msg, flush=True)


# Timed calls per CUDA-event median, and calls per profiled device time:
# 21 and 10 until phase 14 (config #4 at 1,000 views) joined the script's
# time limit. A plain version (a reference, often 100x slower than its
# kernel) and the Python loops a fused solve replaced take PLAIN_RUNS.
TIMED_RUNS = 11
PROFILED_CALLS = 5
PLAIN_RUNS = 3


def time_ms(fn, device, runs: int = TIMED_RUNS) -> float:
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


# Traced sessions: those that recorded fewer device launches than another
# session of the same calls, those that recorded none, all of them, and the
# launches the short ones missed against the fullest session of their
# measurement, of all the launches the fullest sessions imply (main prints
# them).
TRACE_SESSIONS = {"short": 0, "empty": 0, "all": 0, "missing": 0, "launches": 0}
# Profiler sessions merged per traced measurement (each costs its profiler's
# set-up and report besides the calls; two keep the script inside its time
# limit with phase 14 in it).
PROFILE_SESSIONS = 2
# Idle card on each side of a session's kept step, seconds.
PROFILE_PAD_S = 0.05


def profiled_sessions(fn, calls: int = 1, sessions: int = PROFILE_SESSIONS, pad_s: float = PROFILE_PAD_S):
    """torch.profiler over `calls` calls of fn(), `sessions` times: each
    session runs the calls twice, the first step (device tracing already
    on) discarded, the kept one between pad_s of idle card on each side.
    The device activity only: the host's operator events triple the events
    a trace of many small launches parses (a block of the match stage: ~9 s
    a session with them on an H100 host, ~4 without), and no device row
    needs them. Yields (the profiler, the kept calls' wall ms, fn()'s last
    result) for each session."""
    import torch

    for _ in range(sessions):
        steps = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=steps) as prof:
            for step in range(2):
                torch.cuda.synchronize()
                time.sleep(pad_s * step)
                t0 = time.perf_counter()
                for _ in range(calls):
                    out = fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                time.sleep(pad_s * step)
                prof.step()
        yield prof, wall, out


def traced(fn, calls: int = 1, sessions: int = PROFILE_SESSIONS, pad_s: float = PROFILE_PAD_S):
    """Device rows of profiled_sessions. A trace can miss launches near its
    ends, up to half of a session's in a process that has run many kernels
    (PERF.md section 7). So each device row counts the most launches any
    session recorded, at its mean time per launch over all sessions.
    Returns (rows (name, launches, ms) by ms, the median wall ms of the kept
    calls, fn()'s last result)."""
    seen, walls, totals = {}, [], []
    for prof, wall, out in profiled_sessions(fn, calls, sessions, pad_s):
        walls.append(wall)
        rows = device_rows(prof)
        totals.append(sum(e.count for e in rows))
        for e in rows:
            n, ms, most = seen.get(e.key, (0, 0.0, 0))
            seen[e.key] = (n + e.count, ms + e.self_device_time_total / 1e3, max(most, e.count))
    TRACE_SESSIONS["all"] += sessions
    TRACE_SESSIONS["short"] += sum(t < max(totals) for t in totals)
    TRACE_SESSIONS["empty"] += sum(t == 0 for t in totals)
    TRACE_SESSIONS["missing"] += sum(max(totals) - t for t in totals)
    TRACE_SESSIONS["launches"] += max(totals) * sessions
    rows = [(key[:60], most, most * ms / n) for key, (n, ms, most) in seen.items()]
    return sorted(rows, key=lambda r: -r[2]), statistics.median(walls), out


def device_rows(prof) -> list:
    """The device's own rows of a torch.profiler trace (kernels, memcpy,
    memset). The rows of the host ops that launched them carry the same
    time once more, and annotations (the schedule's "ProfilerStep*", the
    port's spans) the span of their range: all are left out."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep") and not getattr(e, "is_user_annotation", False)]


def per_call(rows, calls: int) -> tuple[float, float, list]:
    """(device launches, device ms) per call of traced rows over `calls`
    calls, and the rows as (name, launches per call, ms per call)."""
    top = [(name, n / calls, ms / calls) for name, n, ms in rows]
    return sum(r[1] for r in top), sum(r[2] for r in top), top


def device_ms(fn, device, calls: int = PROFILED_CALLS) -> float | None:
    """Device time per call of fn() after a warm-up (traced, per_call over
    `calls` calls), with one more session when none recorded a device row;
    None off the card or when that one recorded none either (not
    measured)."""
    if device.type != "cuda":
        return None
    fn()
    rows = traced(fn, calls)[0]
    if not rows:
        rows = traced(fn, calls, sessions=1)[0]
    ms = per_call(rows, calls)[1]
    return ms if ms > 0 else None


def max_rel(a, b) -> tuple[float, float]:
    """(max |a - b|, that divided by max(|b|.max(), 1))."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1.0)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> dict:
    """Least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---- phase 3: kernels against their plain versions -------------------------


def check_dog_shape(device, gauss, pre: float, what: str, timed: bool = True) -> dict:
    """K1 on one Gaussian stack: bit-exact (torch.equal) against its plain
    version; timed, its ms, device ms, plain ms and bound."""
    import torch

    from sfm_tpu_torch.kernels import dog_extrema as k1

    out = k1.dog_extrema_scores(gauss, pre)
    ref = k1.dog_extrema_scores_plain(gauss, pre)
    n_ext = int((ref > 0).sum())
    if not torch.equal(out, ref):
        raise AssertionError(f"dog_extrema_scores {what}: not bit-exact ({int((out != ref).sum())} "
                             f"voxels differ, {n_ext} extrema)")
    row = dict(shape=what, max_abs_err=float((out - ref).abs().max()), extrema=n_ext)
    if timed:
        # Operations: the L-1 DoG differences per pixel, then for the L-3
        # scored levels 26 neighbour compares for the maximum, 26 for the
        # minimum and the threshold.
        B, L, H, W = gauss.shape
        ops = B * H * W * ((L - 1) + (L - 3) * 53)
        row.update(ms=time_ms(lambda: k1.dog_extrema_scores(gauss, pre), device),
                   plain_ms=time_ms(lambda: k1.dog_extrema_scores_plain(gauss, pre), device, PLAIN_RUNS),
                   library_ms=None, **bound(nbytes(gauss, out), ops, FP32_OPS_PER_S),
                   device_ms=device_ms(lambda: k1.dog_extrema_scores(gauss, pre), device))
    return row


def check_dog(device, size: int):
    """K1 on the [1, 6, size, size] first octave of a uniform-noise image
    (dense in extrema): bit-exact; then, untimed, on stacks whose shapes
    the kernel's routes make interesting (dog_edge_stacks)."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops.detect import pre_threshold
    from sfm_tpu_torch.ops.pyramid import build_pyramid

    cfg = SiftConfig(num_octaves=1, image_max_dim=size)
    img = np.random.default_rng(0).uniform(0, 1, (1, size, size)).astype(np.float32)
    gauss = build_pyramid(torch.from_numpy(img).to(device), cfg)[0].contiguous()
    pre = pre_threshold(cfg)
    row = check_dog_shape(device, gauss, pre, "x".join(map(str, gauss.shape)))
    if row["extrema"] == 0:
        raise AssertionError("dog_extrema_scores: no extremum in a noise octave")
    edges = [check_dog_shape(device, g, pre, what, timed=False) for what, g in dog_edge_stacks(device)]
    row["note"] = (f"exact, {row['extrema']} extrema; exact untimed on " +
                   ", ".join(f"{r['shape']} ({r['extrema']} extrema)" for r in edges))
    return row


def dog_edge_stacks(device):
    """(what, stack) for K1's untimed checks: a ragged [3, 6, 200, 328]
    (partial tiles), L = 4 (one scored level), W % 4 != 0 and an offset view
    (the 4-byte route), and 8 x 8 (no interior pixel: all zeros). Smoothed
    noise whose levels drift apart like a Gaussian stack's."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)

    def stack(shape):
        g = 0.1 * np.cumsum(rng.uniform(0, 1, shape), axis=1) + 0.05 * rng.normal(size=shape)
        return torch.from_numpy(g.astype(np.float32)).to(device)

    flat = stack((2, 6, 136, 200)).reshape(-1)
    offset = torch.empty(flat.numel() + 1, device=device)
    offset[1:] = flat
    return [("ragged 3x6x200x328", stack((3, 6, 200, 328))), ("L=4 2x4x256x256", stack((2, 4, 256, 256))),
            ("W%4=3 2x6x136x203", stack((2, 6, 136, 203))),
            ("offset view 2x6x136x200", offset[1:].view(2, 6, 136, 200)),
            ("8x8 2x6x8x8", stack((2, 6, 8, 8)))]


@contextlib.contextmanager
def record_dog_stacks():
    """Record every [B, L, H, W] the feature stage hands K1, with a copy of
    the first stack of each shape and the number of calls, by wrapping the
    extractor's kernel entry for the duration."""
    from sfm_tpu_torch.ops import sift

    seen, inner = {}, sift.dog_extrema_scores

    def wrapped(gauss, pre):
        key = tuple(gauss.shape)
        if key not in seen:
            seen[key] = dict(stack=gauss.clone(), pre=pre, calls=0)
        seen[key]["calls"] += 1
        return inner(gauss, pre)

    sift.dog_extrema_scores = wrapped
    try:
        yield seen
    finally:
        sift.dog_extrema_scores = inner


def check_dog_path(device, seen) -> list:
    """K1 at every shape the feature stage handed it, on the first stack it
    was handed there: bit-exact and timed."""
    rows = []
    for key in sorted(seen, key=lambda k: (-k[2], -k[0])):
        rec = seen[key]
        rows.append({**check_dog_shape(device, rec["stack"], rec["pre"], "x".join(map(str, key))),
                     "calls": rec["calls"]})
    return rows


def ring_chunk(device, ring):
    """The first feature chunk of the ring as the feature stage hands it to
    extract_features: canvases [8, H, W] and valid_hw, on the device, and the
    default SiftConfig."""
    import torch

    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.pipeline import ingest, stages

    cfg = PipelineConfig().sift
    batch = ingest.load_images(list(ring[:stages._FEATURE_CHUNK]), cfg)
    return (torch.from_numpy(batch.canvases).to(device), cfg,
            torch.from_numpy(batch.valid_hw).to(device))


def check_features_route(images, cfg, valid_hw) -> int:
    """extract_features on one chunk with use_pallas True (K1) and False
    (the plain score map): every Features tensor identical. Returns the
    valid keypoints."""
    import dataclasses

    import torch

    from sfm_tpu_torch.ops.sift import extract_features

    a = extract_features(images, cfg, valid_hw)
    b = extract_features(images, dataclasses.replace(cfg, use_pallas=False), valid_hw)
    differ = [name for name, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]
    if differ:
        raise AssertionError(f"extract_features: use_pallas True and False differ in {differ}")
    return int(a.valid.sum())


# K12 against its plain version: the largest gap of any descriptor entry
# (fp32 reassociation; both normalise to unit length, entries <= 0.2).
DESC_GAP = 1e-5
# K12's operations a lattice point: the position 8, two 4-tap samples 24,
# magnitude and soft bins 12, the weighted adds into 4 cells x 2 bins 16.
DESC_OPS_PER_POINT = 60


@contextlib.contextmanager
def record_calls(module, name: str):
    """Record the arguments of every call made of `module.name` (a kernel
    wrapper as the feature stage's module binds it), by wrapping it for the
    duration."""
    calls, inner = [], getattr(module, name)

    def wrapped(*args):
        calls.append(args)
        return inner(*args)

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def descriptor_least_bytes(kps, dx) -> int:
    """Bytes one K12 call must move: the [N, 128] descriptors written once,
    the keypoint fields read once, and each 32-byte sector of dx and of dy
    that a tap of some lattice point reads, once (the plain version's
    offsets, level, clamp box and 4 taps)."""
    import torch

    from sfm_tpu_torch.kernels import sift_descriptors as k12

    B, L, H, W = dx.shape
    n = kps.x.shape[0]
    lat = torch.from_numpy(k12._LATTICE).to(dx.device)
    scale = kps.sigma[:, None] * 3.0
    du, dv = lat[None, :, 0] * scale, lat[None, :, 1] * scale
    c, s = torch.cos(kps.angle)[:, None], torch.sin(kps.angle)[:, None]
    lev = torch.round(kps.level).long().clamp(0, L - 1)

    def corner(pos, centre, size):
        """First tap along one axis, in image pixels."""
        if min(H, W) >= 64:
            box = (torch.round(centre).long() - 32).clamp(0, size - 64)[:, None]
            return (pos - box).clamp(0.0, 64 - 1.000001).floor().long() + box
        return pos.clamp(0.0, size - 1.000001).floor().long()

    x0 = corner(kps.x[:, None] + c * du - s * dv, kps.x, W)
    y0 = corner(kps.y[:, None] + s * du + c * dv, kps.y, H)
    plane = (kps.img * L + lev)[:, None, None, None]
    rows = plane * H + torch.stack([y0, y0 + 1], -1)[..., None]
    taps = rows * W + torch.stack([x0, x0 + 1], -1)[..., None, :]
    sectors = torch.unique(taps // 8).numel()   # 8 floats a sector
    return 2 * 32 * sectors + n * 128 * 4 + n * (8 + 5 * 4)


def descriptor_edge_cases(device, cfg):
    """(what, keypoints, dx, dy, config) for K12's untimed checks: stacks
    under 64 px on a side (the whole plane as the clamp box), square and
    not, of uniform noise, with keypoints inside and up to 3 px outside the
    image, blurs up to 6 px and levels past both ends; the second with
    root-SIFT."""
    import dataclasses

    import numpy as np
    import torch

    from sfm_tpu_torch.ops.detect import OctaveKeypoints

    rng = np.random.default_rng(11)
    out = []
    for shape, root in (((2, 4, 48, 48), False), ((3, 5, 40, 72), True)):
        B, L, H, W = shape
        n = 512

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        kps = OctaveKeypoints(
            img=torch.from_numpy(rng.integers(0, B, n)).to(device), x=f32(rng.uniform(-3, W + 3, n)),
            y=f32(rng.uniform(-3, H + 3, n)), level=f32(rng.uniform(-1, L, n)),
            sigma=f32(rng.uniform(1.6, 6.0, n)), response=f32(np.ones(n)),
            angle=f32(rng.uniform(-np.pi, np.pi, n)), valid=torch.ones(n, dtype=torch.bool, device=device))
        dx, dy = (f32(rng.uniform(-0.1, 0.1, shape)) for _ in range(2))
        out.append((f"{n} kps on " + "x".join(map(str, shape)) + (" root-SIFT" if root else ""),
                    kps, dx, dy, dataclasses.replace(cfg, root_sift=root)))
    return out


def check_descriptors(device, images, cfg, valid_hw) -> list:
    """K12 on one chunk as extract_features hands it each octave: one launch
    a call, the kernel against its plain version on the card (largest gap
    <= DESC_GAP), and each octave's call timed (event and device time)
    beside its bound and the plain version's time; then, untimed and held
    to the same gap, the first octave with root-SIFT and the
    descriptor_edge_cases."""
    import dataclasses
    import functools

    from sfm_tpu_torch import kernels
    from sfm_tpu_torch.kernels import sift_descriptors as k12
    from sfm_tpu_torch.ops import sift
    from sfm_tpu_torch.ops.sift import extract_features

    before = kernels.LAUNCHES["sift_descriptors"]
    with record_calls(sift, "sift_descriptors") as calls:
        extract_features(images, cfg, valid_hw)
    launched = kernels.LAUNCHES["sift_descriptors"] - before
    if launched != len(calls) or len(calls) != cfg.num_octaves:
        raise AssertionError(f"sift_descriptors: {launched} launches for {len(calls)} calls "
                             f"of {cfg.num_octaves} octaves")
    rows = []
    for kps, dx, dy, call_cfg in calls:
        kernel = functools.partial(k12.sift_descriptors, kps, dx, dy, call_cfg)
        plain = functools.partial(k12.sift_descriptors_plain, kps, dx, dy, call_cfg)
        gap = float((kernel() - plain()).abs().max())
        what = f"{kps.x.shape[0]} kps on " + "x".join(map(str, dx.shape))
        if not gap <= DESC_GAP:
            raise AssertionError(f"sift_descriptors {what}: max abs gap {gap:.3e} > {DESC_GAP}")
        ops = kps.x.shape[0] * k12._LATTICE.shape[0] * DESC_OPS_PER_POINT
        rows.append(dict(shape=what, max_abs_err=gap, calls=1, ms=time_ms(kernel, device),
                         plain_ms=time_ms(plain, device, PLAIN_RUNS), library_ms=None,
                         device_ms=device_ms(kernel, device),
                         **bound(descriptor_least_bytes(kps, dx), ops, FP32_OPS_PER_S)))
    kps, dx, dy, call_cfg = calls[0]
    untimed = [(rows[0]["shape"] + " root-SIFT", kps, dx, dy, dataclasses.replace(call_cfg, root_sift=True))]
    for what, kps, dx, dy, call_cfg in untimed + descriptor_edge_cases(device, cfg):
        gap = float((k12.sift_descriptors(kps, dx, dy, call_cfg)
                     - k12.sift_descriptors_plain(kps, dx, dy, call_cfg)).abs().max())
        if not gap <= DESC_GAP:
            raise AssertionError(f"sift_descriptors {what}: max abs gap {gap:.3e} > {DESC_GAP}")
        rows[0].setdefault("untimed", []).append((what, gap))
    return rows


# K13 against its plain version: the largest gap of any level's pixel (0
# where the library sums in the kernel's order: ascending columns from 0).
BLUR_GAP = 1e-6


def blur_bytes_ops(base, sigmas) -> tuple[int, int]:
    """K13's least bytes (the base read once, the L levels written once) and
    operations (a multiply-add two, over each level's band in both passes)."""
    from sfm_tpu_torch.kernels import blur_levels as k13

    B, n, _ = base.shape
    widths = k13.band_tables(n, k13.sigma_keys(sigmas)).widths
    return 4 * B * n * n * (1 + len(sigmas)), 4 * B * n * n * int(widths.sum())


def check_blur(device, images) -> list:
    """K13 on each octave call of build_pyramid over one chunk (the ring's
    [8, 1024, 1024]) and over 8 noise views of 256^2 (the last octave, 32,
    under twice the widest radius: rows that read every column): one launch
    a call, within BLUR_GAP of its plain version on the card, each call
    timed (event and device time) beside its bound, the plain version's time
    (which builds and uploads the operator stack) and the library's (the two
    torch.matmul with the stack already on the card)."""
    import numpy as np
    import torch

    from sfm_tpu_torch import kernels
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.kernels import blur_levels as k13
    from sfm_tpu_torch.ops import pyramid
    from sfm_tpu_torch.ops.pyramid import build_pyramid

    noise = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (8, 256, 256)).astype(np.float32)).to(device)
    rows = []
    for imgs, cfg in ((images, SiftConfig()), (noise, SiftConfig(image_max_dim=256))):
        before = kernels.LAUNCHES["blur_levels"]
        with record_calls(pyramid, "blur_levels") as calls:
            build_pyramid(imgs, cfg)
        launched = kernels.LAUNCHES["blur_levels"] - before
        if launched != len(calls) or len(calls) != cfg.num_octaves:
            raise AssertionError(f"blur_levels: {launched} launches for {len(calls)} calls "
                                 f"of {cfg.num_octaves} octaves")
        for base, sigmas in calls:
            kernel = lambda: k13.blur_levels(base, sigmas)  # noqa: E731
            out, ref = kernel(), k13.blur_levels_plain(base, sigmas)
            gap = float((out - ref).abs().max())
            what = "x".join(map(str, base.shape)) + ("" if base.is_contiguous() else " view")
            if not gap <= BLUR_GAP:
                raise AssertionError(f"blur_levels {what}: max abs gap {gap:.3e} > {BLUR_GAP}")
            n = base.shape[1]
            T = torch.from_numpy(np.stack([np.eye(n, dtype=np.float32) if q is None else k13._toeplitz_blur(n, q)
                                           for q in k13.sigma_keys(sigmas)])).to(device)
            library = lambda: torch.matmul(torch.matmul(T[None], base[:, None]), T.transpose(1, 2)[None])  # noqa: E731
            rows.append(dict(shape=what, max_abs_err=gap, exact=bool(torch.equal(out, ref)), calls=1,
                             ms=time_ms(kernel, device), device_ms=device_ms(kernel, device),
                             plain_ms=time_ms(lambda: k13.blur_levels_plain(base, sigmas), device, PLAIN_RUNS),
                             library_ms=time_ms(library, device),
                             **bound(*blur_bytes_ops(base, sigmas), FP32_OPS_PER_S)))
    return rows


# K14 against its plain version. A candidate differs where its valid
# differs, or its x, y or level by more than REFINE_POS_GAP (or, past 1,024
# px, one fp32 rounding step of the coordinate, 1.2e-4), or (valid on
# either side) its response or blur by more than REFINE_REL_GAP of the
# plain value: a decision within rounding of its threshold (the 0.6 step,
# |offset| < 1, the contrast and edge tests) may flip, since the kernel
# solves and sums in its own order. At most REFINE_FLIPS of a call's live
# candidates (score > 0) may differ.
REFINE_FLIPS = 1e-3
REFINE_POS_GAP = 1e-4
REFINE_REL_GAP = 1e-5
# K14's operations: a round's cube, derivatives, solve, clamp and step ~110,
# the final cube and tests ~40.
REFINE_OPS_PER_ROUND = 110
REFINE_OPS_FINAL = 40


def refine_least_bytes(gauss, idx) -> int:
    """Bytes one K14 call must move: idx and scores read once, the eight
    [B * K] outputs written once (8 + 6 * 4 + 1 bytes a candidate), and each
    32-byte sector of the stack that a candidate's first 4 x 3 x 3 cube
    touches, once (a step moves a cube by one voxel; the sectors it reaches
    then are not counted)."""
    import torch

    B, L, H, W = gauss.shape
    K = idx.shape[1]
    dev = gauss.device
    flat = idx.reshape(-1)
    b = torch.arange(B, device=dev).repeat_interleave(K)
    lev = (flat // (H * W)).clamp(1, L - 3)
    y = (flat % (H * W) // W).clamp(2, H - 3)
    x = (flat % W).clamp(2, W - 3)
    d = torch.arange(-1, 2, device=dev)
    planes = (b * L + lev)[:, None] + torch.arange(-1, 3, device=dev)
    rows = planes[:, :, None] * H + (y[:, None] + d)[:, None, :]
    taps = rows[..., None] * W + (x[:, None] + d)[:, None, None, :]
    sectors = torch.unique(taps // 8).numel()   # 8 floats a sector
    return 32 * sectors + B * K * (8 + 4) + B * K * (8 + 6 * 4 + 1)


def refine_gaps(got, ref, scores) -> dict:
    """K14's output against its plain version's on one call: the candidates
    that differ (see REFINE_FLIPS), the live ones, those equal in every
    field, and the largest gaps of the rest."""
    import torch

    pos = torch.stack([(getattr(got, f) - getattr(ref, f)).abs() for f in ("x", "y", "level")])
    bar = torch.stack([(getattr(ref, f).abs() * 2.0**-23).clamp_min(REFINE_POS_GAP) for f in ("x", "y", "level")])
    rel = torch.stack([(getattr(got, f) - getattr(ref, f)).abs() / getattr(ref, f).abs().clamp_min(1e-30)
                       for f in ("response", "sigma")]).amax(0)
    either = got.valid | ref.valid
    differ = (got.valid != ref.valid) | ~(pos <= bar).all(0) | (either & ~(rel <= REFINE_REL_GAP))
    same = torch.stack([torch.eq(getattr(got, f), getattr(ref, f)) for f in got._fields]).all(0)
    rest = ~differ
    return dict(candidates=int(differ.numel()), live=int((scores.reshape(-1) > 0).sum()),
                differ=int(differ.sum()), identical=int(same.sum()),
                pos_gap=float(pos.amax(0)[rest].max()) if rest.any() else 0.0,
                rel_gap=float(rel[rest & either].max()) if (rest & either).any() else 0.0,
                valid=int(ref.valid.sum()))


def check_refine(device, images, cfg, valid_hw, ring) -> list:
    """K14 as extract_features hands it each octave call, on the ring's
    chunk of 8 views (octaves 0-3), on the 2048^2 octave of its first two
    views upsampled, and on a chunk of three of its views at 200^2 (whose
    last octave holds fewer voxels than the candidate budget): one launch a
    call, the kernel against its plain version on the card (REFINE_FLIPS),
    and each call timed (event and device time) beside its bound and the
    plain version's time."""
    import dataclasses
    import functools

    import torch

    from sfm_tpu_torch import kernels
    from sfm_tpu_torch.kernels import subpixel_refine as k14
    from sfm_tpu_torch.ops import sift
    from sfm_tpu_torch.ops.sift import extract_features
    from sfm_tpu_torch.pipeline import ingest

    small_cfg = dataclasses.replace(cfg, image_max_dim=200)
    small = ingest.load_images(list(ring[:3]), small_cfg)
    runs = [(images, cfg, valid_hw, None),
            (images[:2], dataclasses.replace(cfg, upsample_first_octave=True), valid_hw[:2], 1),
            (torch.from_numpy(small.canvases).to(device), small_cfg,
             torch.from_numpy(small.valid_hw).to(device), None)]
    rows = []
    for imgs, run_cfg, hw, keep in runs:
        before = kernels.LAUNCHES["subpixel_refine"]
        with record_calls(sift, "subpixel_refine") as calls:
            extract_features(imgs, run_cfg, hw)
        launched = kernels.LAUNCHES["subpixel_refine"] - before
        if launched != len(calls) or len(calls) != run_cfg.num_octaves:
            raise AssertionError(f"subpixel_refine: {launched} launches for {len(calls)} calls "
                                 f"of {run_cfg.num_octaves} octaves")
        for gauss, idx, scores, call_cfg in calls[:keep]:
            kernel = functools.partial(k14.subpixel_refine, gauss, idx, scores, call_cfg)
            plain = functools.partial(k14.subpixel_refine_plain, gauss, idx, scores, call_cfg)
            gaps = refine_gaps(kernel(), plain(), scores)
            what = f"{idx.shape[1]} candidates on " + "x".join(map(str, gauss.shape))
            if gaps["differ"] > REFINE_FLIPS * max(gaps["live"], 1):
                raise AssertionError(f"subpixel_refine {what}: {json.dumps(gaps)}")
            ops = idx.numel() * (REFINE_OPS_PER_ROUND * call_cfg.refine_iters + REFINE_OPS_FINAL)
            rows.append(dict(shape=what, max_abs_err=gaps["pos_gap"], **gaps, calls=1, ms=time_ms(kernel, device),
                             device_ms=device_ms(kernel, device), plain_ms=time_ms(plain, device, PLAIN_RUNS),
                             library_ms=None, **bound(refine_least_bytes(gauss, idx), ops, FP32_OPS_PER_S)))
    return rows


def check_select(device, images, cfg, valid_hw, ring) -> list:
    """K15 as extract_features hands it each octave call, on the same three
    runs as check_refine (the ring's chunk of 8 views, octaves 0-3; the
    2048^2 octave of its first two views upsampled; three of its views at
    200^2, whose last octave holds fewer voxels than the candidate budget):
    one launch a call; the selection (the kernel, then the sort of its keys)
    equal to top_k_stable's, the full sort it replaced, and the first k of
    the kernel's sorted keys to its plain version's, bit for bit; each call timed (event and
    device time) beside its bound, the plain version's time and the full
    sort's (library_ms)."""
    import dataclasses
    import functools

    import torch

    from sfm_tpu_torch import kernels
    from sfm_tpu_torch.kernels import select_candidates as k15
    from sfm_tpu_torch.ops import detect, sift
    from sfm_tpu_torch.ops.sift import extract_features
    from sfm_tpu_torch.pipeline import ingest

    small_cfg = dataclasses.replace(cfg, image_max_dim=200)
    small = ingest.load_images(list(ring[:3]), small_cfg)
    runs = [(images, cfg, valid_hw, None),
            (images[:2], dataclasses.replace(cfg, upsample_first_octave=True), valid_hw[:2], 1),
            (torch.from_numpy(small.canvases).to(device), small_cfg,
             torch.from_numpy(small.valid_hw).to(device), None)]
    rows = []
    for imgs, run_cfg, hw, keep in runs:
        before = kernels.LAUNCHES["select_keys"]
        with record_calls(sift, "select_candidates") as calls:
            extract_features(imgs, run_cfg, hw)
        launched = kernels.LAUNCHES["select_keys"] - before
        if launched != len(calls) or len(calls) != run_cfg.num_octaves:
            raise AssertionError(f"select_keys: {launched} launches for {len(calls)} calls "
                                 f"of {run_cfg.num_octaves} octaves")
        for score, k in calls[:keep]:
            B = score.shape[0]
            what = f"{k} candidates of " + "x".join(map(str, score.shape))
            keys, plain_keys = (torch.full((B, 3 * k), k15.EMPTY, dtype=torch.int64, device=device)
                                for _ in range(2))
            kernel = functools.partial(k15.select_keys, score, k, keys)
            plain = functools.partial(k15.select_keys_plain, score, k, plain_keys)
            full_sort = functools.partial(detect.top_k_stable, score.reshape(B, -1), k)
            kernel()
            plain()
            idx, vals = detect.select_candidates(score, k)
            want_vals, want_idx = full_sort()
            if not (torch.equal(torch.sort(keys, 1).values[:, :k], plain_keys[:, :k]) and torch.equal(idx, want_idx)
                    and torch.equal(vals, want_vals)):
                raise AssertionError(f"select_keys {what}: the selection differs from top_k_stable's "
                                     "or the keys from the plain version's")
            positives = (score.reshape(B, -1) > 0).sum(1)
            rows.append(dict(shape=what, max_abs_err=0.0, calls=1, positives=int(positives.min()),
                             ms=time_ms(kernel, device), device_ms=device_ms(kernel, device),
                             plain_ms=time_ms(plain, device, PLAIN_RUNS),
                             library_ms=time_ms(full_sort, device, PLAIN_RUNS),
                             **bound(nbytes(score) + 8 * B * k, 0, FP32_OPS_PER_S)))
    return rows


def _planted_descriptors(device, n1: int, n2: int, seed: int, pairs: int = 1, invalid=None):
    """da [pairs, n1, 128] noisy copies of rows of db [pairs, n2, 128]; the
    last invalid[p] rows of pair p's db (n2 // 16 by default) are invalid and
    hold NaN (padding must not leak)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    db = rng.standard_normal((pairs, n2, 128), dtype=np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    src = rng.integers(0, n2, (pairs, n1))
    da = np.take_along_axis(db, src[:, :, None], 1)
    da += 0.05 * rng.standard_normal((pairs, n1, 128), dtype=np.float32)
    da /= np.linalg.norm(da, axis=-1, keepdims=True)
    invalid = np.full(pairs, n2 // 16) if invalid is None else np.asarray(invalid)
    vb = np.arange(n2)[None] < (n2 - invalid)[:, None]
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


def check_match_shape(device, shape, inputs=None):
    """K2 at one (pairs, n1, n2): the kernel held against the plain version
    on planted descriptors (or on `inputs`, a block the pipeline handed
    it), then both timed. The bf16 Gram is tensor-core work: 2 * pairs *
    n1 * n2 * 128 operations; bytes: the operands (as bf16), the validity
    and the three outputs."""
    from sfm_tpu_torch.kernels import match_topk as k2

    p, n1, n2 = shape
    what = f"{p} x {n1} x {n2}"
    da, db, vb = inputs if inputs is not None else _planted_descriptors(device, n1, n2, seed=10 + p, pairs=p)
    out = k2.match_topk2(da, db, vb)
    n_clear, err = _compare_topk2(out, k2.match_topk2_plain(da, db, vb), what)
    moved = nbytes(vb, *out) + 2 * (da.numel() + db.numel())
    return dict(shape=what, max_abs_err=err, clear_rows=n_clear, rows=p * n1,
                ms=time_ms(lambda: k2.match_topk2(da, db, vb), device),
                plain_ms=time_ms(lambda: k2.match_topk2_plain(da, db, vb), device, PLAIN_RUNS),
                library_ms=None, **bound(moved, 2 * p * n1 * n2 * 128, BF16_TENSOR_OPS_PER_S),
                device_ms=device_ms(lambda: k2.match_topk2(da, db, vb), device))


def check_match(device, n: int, batch: int = 32):
    """K2 against its plain version: idx equal except near-ties (second
    distance within 1e-3 of the first), d1/d2 to rtol 1e-5 + atol 1e-5 (the
    tensor cores and the plain version sum the bf16 products in different
    orders). Shapes: ragged 1000 x 999; three pairs of 700 x 600 whose
    validity differs (the usual tail, every column invalid: d1 = d2 = 1e9 and
    idx = 0, half the columns); N2 = 50, less than one tile; exact ties
    (twin rows of db: d1 == d2 and the lower column); then, timed, one
    pair and a block of `batch` pairs of n x n (the matcher's block_pairs).
    Returns (the single pair's record, both timed shapes)."""
    import torch

    from sfm_tpu_torch.kernels import match_topk as k2

    for what, inputs in (
            ("ragged 1000x999", _planted_descriptors(device, 1000, 999, seed=1)),
            ("3 pairs 700x600", _planted_descriptors(device, 700, 600, seed=2, pairs=3,
                                                     invalid=[37, 600, 300])),
            ("300x50", _planted_descriptors(device, 300, 50, seed=3))):
        out = k2.match_topk2(*inputs)
        _compare_topk2(out, k2.match_topk2_plain(*inputs), what)
        if what.startswith("3 pairs"):
            d1, d2, idx = (t[1] for t in out)
            if not (bool((d1 == 1e9).all()) and bool((d2 == 1e9).all()) and bool((idx == 0).all())):
                raise AssertionError("match_topk2: a pair without valid columns must give "
                                     "d1 = d2 = 1e9 and idx = 0")
    # Exact ties: columns 7 and 40 of db are one row, 300 and 411 another;
    # rows of da planted on them are as near to the twin, so d1 == d2 and
    # argmin names the lower column.
    da, db, vb = _planted_descriptors(device, 2048, 2048, seed=5)
    db[0, 40], db[0, 411] = db[0, 7], db[0, 300]
    da[0, :64] = torch.nn.functional.normalize(db[0, 7] + 0.01 * da[0, :64], dim=-1)
    da[0, 64:128] = torch.nn.functional.normalize(db[0, 411] + 0.01 * da[0, 64:128], dim=-1)
    d1, d2, idx = k2.match_topk2(da, db, vb)
    _compare_topk2((d1, d2, idx), k2.match_topk2_plain(da, db, vb), "exact ties")
    if not (bool((idx[0, :64] == 7).all()) and bool((idx[0, 64:128] == 300).all())
            and torch.equal(d1[0, :128], d2[0, :128])):
        raise AssertionError("match_topk2: an exact tie must give d1 == d2 and the lower column")
    timed = [check_match_shape(device, (p, n, n)) for p in (1, batch)]
    first = dict(timed[0])
    first["note"] = (f"{first['clear_rows']}/{first['rows']} rows clear of near-ties; ragged 1000x999, "
                     "3 pairs of differing validity and N2=50 also checked; no single library call "
                     "(the plain version is a cuBLAS matmul + min)")
    return first, timed


def log_shapes(what: str, rows) -> None:
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[kernel] {what} {r['shape']}: max_abs_err {r['max_abs_err']:.3e} | kernel {r['ms']:.4f} ms | "
            f"plain {r['plain_ms']:.4f} ms | library {lib} | bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']})")


@contextlib.contextmanager
def record_match_shapes(blocks: dict | None = None):
    """Record the (pairs, n1, n2) of every K2 call the pipeline makes, by
    wrapping the matcher's kernel entry for the duration; with `blocks`, a
    copy of the first (da, db, vb) of each shape lands there too."""
    from sfm_tpu_torch.ops import match

    shapes, inner = [], match.match_topk2

    def wrapped(da, db, vb):
        shape = (da.shape[0], da.shape[1], db.shape[1])
        shapes.append(shape)
        if blocks is not None and shape not in blocks:
            blocks[shape] = (da.clone(), db.clone(), vb.clone())
        return inner(da, db, vb)

    match.match_topk2 = wrapped
    try:
        yield shapes
    finally:
        match.match_topk2 = inner


def pcg_build(core, prob, cfg) -> dict:
    """bundle_adjust's flag for its normal-equation build on this problem:
    the Schur-Jacobi blocks from K3 on the PCG branch. None for a package
    from before the flag (tools/torch_perf.py runs these helpers on older
    trees too)."""
    import inspect

    if "schur_jacobi" not in inspect.signature(core.build_normal_equations).parameters:
        return {}
    return dict(schur_jacobi=not core.uses_dense_solver(prob, cfg))


def first_iteration_inputs(prob, cfg):
    """What the main path's bundle_adjust(prob, cfg) hands the kernels in its
    first LM iteration: (solve invariants with the near-plane floor, normal
    equations at the initial damping, built as bundle_adjust builds them)."""
    import torch

    from sfm_tpu_torch.ba import core

    inv = core.solve_invariants(prob, core.near_plane_floor(prob))
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=prob.cam_params.device)
    return inv, core.build_normal_equations(prob, prob.cam_params, prob.points, lam, cfg, inv,
                                            **pcg_build(core, prob, cfg))


def raised_floor(prob):
    """A near-plane floor that gates the nearest tenth of the weighted
    observations: midway in the first gap between sorted depths past that
    tenth that is wider than fp32 rounding. At a floor equal to an
    observation's own depth, a kernel's and its plain version's roundings of
    that depth would gate it differently."""
    import torch

    from sfm_tpu_torch.kernels import ba_kernels as kb

    z = kb.projection(prob.cam_params[prob.obs_cam.long()], prob.intrinsics[prob.obs_cam.long()],
                      prob.points[prob.obs_point.long()], prob.obs_uv)["xc2"]
    zs = z[prob.obs_w > 0].sort().values
    gaps = torch.nonzero(zs[1:] - zs[:-1] > 1e-5 * zs[:-1].abs()).flatten()
    k = int(gaps[gaps >= len(zs) // 10][0])
    return ((zs[k] + zs[k + 1]) / 2).reshape(())


# K3's outputs, in the order fused_ne_payloads returns them, and those of
# them that are per-observation payloads.
NE_FIELDS = ("Hcc", "Hpp_inv", "W_t", "bc", "bp", "packed")
NE_PAYLOADS = ("W_t", "packed")
# check_ba's bars (PERF.md section 6 gives the readings they were set from).
NE_BAR = 1e-5          # Hcc per camera block; bc, bp and K5's dp per block of their term scale
NE_PAYLOAD_BAR = 1e-4  # W and the packed camera rows, of their max |value|
HINV_BAR = 1e-3        # Hpp^-1, every point block of its max |value|
HINV_MEDIAN_BAR = 1e-4  # Hpp^-1, the median point block
# check_ba's third input: the points moved by this share of the median depth
# (seed 0), so that the gradient stands far above fp32 rounding.
PERTURB = 1e-2


def block_errors(a, b, scale):
    """Per leading index (a camera or point block): max |a - b| over the
    block's max scale, in float64."""
    d = (a.double() - b.double()).abs().flatten(1).max(1).values
    return d / scale.double().flatten(1).max(1).values.clamp_min(1e-300)


def rhs_scales(prob, inv, points, z_floor, loss):
    """The float64 sums per camera [C, 6] and per point [P, 3] of the
    absolute terms of bc = -sum Jc^T r and bp = -sum Jp^T r, with each
    residual r = f x s + c - uv taken as its three terms: the scale that
    fp32 rounding of those sums is relative to. Near convergence bc and bp
    cancel to far below it, so neither their own size nor the sum of
    |Jc^T r| (whose r has lost the digits of |uv|) can be that scale."""
    import torch

    from sfm_tpu_torch.ba.core import residual_jac_analytic
    from sfm_tpu_torch.geometry.losses import robust_weight
    from sfm_tpu_torch.kernels import ba_kernels as kb

    N = inv.cam_inv_perm.numel()
    oc = prob.obs_cam[:N].long()
    cams, intr = prob.cam_params.double()[oc], prob.intrinsics.double()[oc]
    pts, st = points.double()[prob.obs_point[:N].long()], inv.static_t[:, :N].double()
    r, Jc, Jp, depth = residual_jac_analytic(cams, pts, intr, st[:2].T)
    w = kb._gate(st[2], depth, None if z_floor is None else z_floor.double())
    sw = torch.sqrt((robust_weight((r * r).sum(-1), *loss) * w).clamp_min(0.0))
    pr = kb.projection(cams, intr, pts, st[:2].T)
    intr = pr["intr"]   # refined by an 8-wide camera
    mag = torch.stack([(intr[:, 0] * pr["x"] * pr["s"]).abs() + intr[:, 2].abs() + st[0].abs(),
                       (intr[:, 1] * pr["y"] * pr["s"]).abs() + intr[:, 3].abs() + st[1].abs()], -1)
    mag = mag * sw[:, None]
    cam_t = torch.einsum("oai,oa->io", Jc.abs() * (sw * st[3])[:, None, None], mag)
    pt_t = torch.einsum("oai,oa->io", Jp.abs() * (sw * st[4])[:, None, None], mag)
    return (kb.cam_segment_sum_plain(cam_t, inv.cam_perm, inv.cam_bounds),
            kb.cam_segment_sum_plain(pt_t, None, inv.point_bounds))


def dp_scale(step64, prob, inv):
    """The float64 scale per point [P, 3] of K5's back-substitution
    dp = Hpp^-1 (bp - sum W^T dc): |Hpp^-1| (|bp| + sum |W|^T |dc|), dc
    masked by cam_fixed (g cancels near convergence, as bc does)."""
    import torch

    from sfm_tpu_torch.kernels import ba_kernels as kb

    N, D = inv.cam_inv_perm.numel(), step64.dc.shape[-1]
    dc = torch.where(step64.cam_fixed[:, None], 0.0, step64.dc).abs()
    u_t = torch.einsum("iko,io->ko", step64.W_t[:, :N].abs().reshape(D, 3, N),
                       dc[prob.obs_cam[:N].long()].T)
    g = step64.bp.abs() + kb.cam_segment_sum_plain(u_t, None, inv.point_bounds)
    return torch.einsum("pij,pj->pi", step64.Hpp_inv.abs(), g)


def ne_errors(out, ref, cam_scale, pt_scale) -> dict:
    """K3's outputs against a reference: Hcc per camera block of the block's
    max |value|; bc and bp per camera and per point block of their term
    scale (rhs_scales); Hpp^-1 per point block of its max |value| (the
    padding points' 1e6 I blocks would set any array-wide scale), as the
    worst block ("Hpp_inv") and the median one ("Hpp_inv_median"); W and
    the packed rows of their max |value|."""
    import torch

    scales = {"Hcc": ref[0].abs(), "Hpp_inv": ref[1].abs(), "bc": cam_scale, "bp": pt_scale}
    errs = {}
    for name, a, b in zip(NE_FIELDS, out, ref):
        if name in scales:
            e = block_errors(a, b, scales[name])
            errs[name] = float(e.max())
            if name == "Hpp_inv":
                errs["Hpp_inv_median"] = float(torch.median(e))
        else:
            errs[name] = float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return errs


def ne_bad(errs) -> list:
    """The K3 errors (ne_errors) past check_ba's bars."""
    bars = {"Hcc": NE_BAR, "bc": NE_BAR, "bp": NE_BAR, "Hpp_inv": HINV_BAR,
            "Hpp_inv_median": HINV_MEDIAN_BAR, "W_t": NE_PAYLOAD_BAR, "packed": NE_PAYLOAD_BAR}
    return [k for k, bar in bars.items() if not errs[k] <= bar]


def perturbed_points(prob):
    """The problem's points moved by PERTURB of the median depth of its
    weighted observations, from seed 0."""
    import torch

    from sfm_tpu_torch.kernels import ba_kernels as kb

    oc = prob.obs_cam.long()
    z = kb.projection(prob.cam_params[oc], prob.intrinsics[oc], prob.points[prob.obs_point.long()],
                      prob.obs_uv)["xc2"]
    sigma = PERTURB * float(z[prob.obs_w > 0].median())
    noise = torch.randn(prob.points.shape, generator=torch.Generator().manual_seed(0))
    return prob.points + sigma * noise.to(prob.points.device)


def resolved(value64, scale) -> float:
    """The median over blocks of max |value| over max scale: how far a value
    stands above the rounding its scale allows (a zeroed or garbled output
    fails NE_BAR in most blocks once this is well above it)."""
    import torch

    s = scale.double().flatten(1).max(1).values
    keep = s > 0
    return float(torch.median(value64.abs().flatten(1).max(1).values[keep] / s[keep]))


def lm_dc(prob, cfg, inv, ne):
    """The camera step of the first LM iteration as bundle_adjust takes it
    (dense or PCG reduced solve)."""
    from sfm_tpu_torch.ba import core

    rhs = core._schur_rhs(ne, prob, inv)
    return (core._dense_schur_solve(ne, prob, rhs, inv) if core.uses_dense_solver(prob, cfg)
            else core._pcg(ne, prob, rhs, cfg, inv))


def schur_matvec_step(ne, prob, v, inv):
    """S v for one v [C, 6] as a step of the Python CG loop that pcg_solve
    replaced: Hcc v minus the coupling (the coupling-only K11, or past
    MAX_CAMS K10 then K9). check_pcg times kernels.ba_kernels.pcg_loop over
    it beside pcg_solve; the tests hold S v with it."""
    import torch

    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.kernels import ba_kernels as kb

    if core.uses_big_kernels(prob):
        y_t = kb.schur_coupling_payloads_big(ne.W_t, ne.Hpp_inv, prob.obs_point, inv.point_bounds,
                                             inv.cam_inv_perm.shape[0], core._rows_t(v, prob.obs_cam))
        coupling = kb.cam_segment_sum(y_t, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm)
    else:
        coupling = kb.schur_coupling_matvec(ne.W_t, ne.Hpp_inv, prob.obs_cam, prob.obs_point,
                                            inv.point_bounds, inv.cam_perm, inv.cam_bounds,
                                            v.contiguous(), inv.cam_inv_perm)
    return torch.einsum("cij,cj->ci", ne.Hcc, v) - coupling


def lm_step(prob, cfg, inv, ne):
    """That step as K5's candidate mode takes it (with 8-wide cameras the
    config's frozen intrinsic columns, as core.lm_candidate passes them)."""
    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.kernels import ba_kernels as kb

    return kb.LMStep(lm_dc(prob, cfg, inv, ne).contiguous(), ne.W_t, ne.Hpp_inv, ne.bp,
                     prob.cam_fixed, prob.point_fixed, **core.frozen_columns(cfg, prob.cam_params.shape[-1]))


def ne_bytes_ops(prob, inv) -> tuple[int, int]:
    """What K3 must move and compute on this problem for camera blocks of
    width D: the N observations' camera and point ids, statics (5 rows) and
    places, the points, cameras, intrinsics, segment tables and lam read
    once; W [3D, O] (its zero tail too), the M packed camera rows (D^2 + D),
    Hpp^-1, bp, Hcc and bc written once. Operations: ~300 per observation
    at D = 6 (projection, Jacobian, payloads), ~420 at D = 8 (the payloads
    grow as D^2), ~80 per point (sums, damping, inversion), D^2 + D per
    packed row (camera sums)."""
    O, C, P, D = prob.obs_w.shape[0], prob.num_cameras, prob.num_points, prob.cam_params.shape[-1]
    N, M = inv.cam_inv_perm.numel(), inv.cam_perm.numel()
    rows = D * D + D
    moved = 4 * (2 * N + 5 * N + N + 3 * P + (D + 6) * C + P + 1 + C + 1 + 1
                 + 3 * D * O + rows * M + 9 * P + 3 * P + rows * C)
    return moved, (300 if D == 6 else 420) * N + 80 * P + rows * M


def cost_bytes_ops(prob, inv, step: bool) -> tuple[int, int]:
    """What K5 must move and compute for camera blocks of width D: the N
    observations' camera and point ids and u, v, weight, the points,
    cameras, intrinsics and point segments read once, three sums written;
    with a step also W (3D rows of the N observations), dc, Hpp^-1, bp and
    the freeze masks read and the candidate points and cameras written.
    Operations: ~70 per observation for the projection and robust cost,
    with a step 6D more for W^T dc and ~20 per point for dp."""
    O, C, P, D = prob.obs_w.shape[0], prob.num_cameras, prob.num_points, prob.cam_params.shape[-1]
    N = inv.cam_inv_perm.numel()
    moved = 4 * (2 * N + 3 * N + 3 * P + (D + 6) * C + P + 1 + 3)
    ops = 70 * N
    if step:
        moved += 4 * (3 * D * N + D * C + 9 * P + 3 * P + 3 * P + D * C) + C + P
        ops += 6 * D * N + 20 * P
    return moved, ops


def check_ba(prob, cfg, device, what: str):
    """K3 and K5 on a BA problem the main path solved, against their plain
    versions evaluated in float64 on the same fp32 inputs (so the bars
    measure the kernel's own rounding), at three inputs: the first LM
    iteration's (the main path's), the same with the near-plane floor raised
    to the nearest tenth of the depths (the gate removes observations), and
    the points moved by PERTURB of the median depth (seed 0), where the
    gradient stands far above fp32 rounding. Bars, fixed (PERF.md section 6
    gives the readings they were set from):
    - K3's Hcc within NE_BAR (1e-5) of each camera block's max |value|;
    - bc and bp within NE_BAR of each camera's and each point's term scale
      (rhs_scales: the float64 sum of the absolute terms of the sums, the
      residual's prediction and observation taken apart); at the moved
      points the median block's value must stand 10 NE_BAR above that
      scale, so that a zeroed or garbled bc or bp fails;
    - Hpp^-1 within HINV_BAR (1e-3) of its max |value| in every point block
      and within HINV_MEDIAN_BAR (1e-4) in the median block (inverting the
      3x3 blocks of weakly triangulated points loses digits in any fp32
      evaluation);
    - the per-observation payloads, W and the packed camera rows, within
      NE_PAYLOAD_BAR (1e-4) of their max |value| (K3's payload bar since its
      port: closed-form Jacobians of rotations near pi cancel);
    - K5 at the given parameters: the two sums and the mean cost rel 1e-5;
    - K5 with the iteration's own step (the dense or PCG solve of
      bundle_adjust at those inputs): candidate cameras and points within
      1e-5 of their max |value|; the point step dp within NE_BAR of each
      point's scale (dp_scale) beyond the fp32 rounding of the candidate
      point itself (one ulp), its value 10 NE_BAR above that scale at the
      moved points; the cost rel 1e-5;
    - identical bits on a rerun, for both kernels.
    Every error is logged beside the plain fp32 version's. Times (at the
    main path's inputs): K3 and K5 with the step beside their plain
    versions in fp32 and their bounds. An 8-wide problem runs the 8-wide
    builds, under their names (`_w8`)."""
    import dataclasses

    import torch

    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.kernels import ba_kernels as kb

    inv = core.solve_invariants(prob, core.near_plane_floor(prob))
    O, C, P, N = prob.obs_w.shape[0], prob.num_cameras, prob.num_points, inv.cam_inv_perm.numel()
    shape = f"{what}: O={O} ({N} in point segments) C={C} P={P}"
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=device)
    loss = (cfg.robust_loss, cfg.robust_scale_px)
    tables = (inv.point_bounds, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm)
    f64 = lambda t: None if t is None else t.double()
    ulp = 2.0 ** -23
    results = {}
    suffix = "" if prob.cam_params.shape[-1] == 6 else "_w8"

    def ne_args(pts, z, dt=lambda t: t):
        return (prob.obs_cam, prob.obs_point, dt(pts), dt(inv.static_t), dt(prob.cam_params.contiguous()),
                dt(prob.intrinsics), *tables, lam, dt(z), *loss)

    def cost_args(pts, z, dt=lambda t: t):
        return (prob.obs_cam, prob.obs_point, dt(pts), dt(inv.static_t), dt(prob.cam_params.contiguous()),
                dt(prob.intrinsics), inv.point_bounds, dt(z), *loss)

    fmt = lambda d: ", ".join(f"{k} {v:.2e}" for k, v in d.items())
    notes = {"ne": [], "cost": []}
    cases = (("gate raised", prob.points, raised_floor(prob)),
             (f"points moved {PERTURB:g} of the median depth", perturbed_points(prob), inv.z_floor),
             ("first iteration", prob.points, inv.z_floor))
    for label, pts, z in cases:
        tag, moved = f"{shape} ({label})", pts is not prob.points
        cam_scale, pt_scale = rhs_scales(prob, inv, pts, z, loss)
        out = kb.fused_ne_payloads(*ne_args(pts, z), plan=inv.pcg_plan)
        ref = kb.fused_ne_payloads_plain(*ne_args(pts, z, f64))
        errs = ne_errors(out, ref, cam_scale, pt_scale)
        errs32 = ne_errors(kb.fused_ne_payloads_plain(*ne_args(pts, z)), ref, cam_scale, pt_scale)
        seen = {"bc": resolved(ref[3], cam_scale), "bp": resolved(ref[4], pt_scale)}
        if ne_bad(errs):
            raise AssertionError(f"fused_ne_payloads ({tag}): {ne_bad(errs)} off; errors {errs}, "
                                 f"plain fp32 {errs32}")
        if moved and not min(seen.values()) >= 10 * NE_BAR:
            raise AssertionError(f"fused_ne_payloads ({tag}): bc, bp stand {seen} over their scale")
        if not all(torch.equal(x, y) for x, y in zip(out, kb.fused_ne_payloads(*ne_args(pts, z), plan=inv.pcg_plan))):
            raise AssertionError(f"fused_ne_payloads ({tag}): two runs differ (must be deterministic)")
        notes["ne"].append(f"{label}: {fmt(errs)} (plain fp32: {fmt(errs32)}; median value over "
                           f"scale bc {seen['bc']:.2e}, bp {seen['bp']:.2e})")
        _, _, sums = kb.fused_cost_sums(*cost_args(pts, z), plan=inv.pcg_plan)
        _, _, sums64 = kb.fused_cost_sums_plain(*cost_args(pts, z, f64))
        rel = ((sums.double() - sums64).abs() / sums64.abs().clamp_min(1e-30)).max()
        if not float(rel) <= 1e-5:
            raise AssertionError(f"fused_cost_sums ({tag}): {sums.tolist()} vs {sums64.tolist()}")
        if not torch.equal(sums, kb.fused_cost_sums(*cost_args(pts, z), plan=inv.pcg_plan)[2]):
            raise AssertionError(f"fused_cost_sums ({tag}): two runs differ (must be deterministic)")
        if label == "gate raised" and not float(sums[1]) < float(prob.obs_w.sum()):
            raise AssertionError("fused_cost_sums: the near-plane gate removed nothing")
        # The step as bundle_adjust takes it: a PCG solve's build carries K3's
        # Schur-Jacobi blocks (the other outputs bit-identical, check_schur).
        whw = (None if core.uses_dense_solver(prob, cfg)
               else kb.fused_ne_payloads(*ne_args(pts, z), plan=inv.pcg_plan, schur_jacobi=True)[6])
        ne = core.NormalEq(*out[:5], whw=whw)
        step = lm_step(dataclasses.replace(prob, points=pts), cfg, inv, ne)
        step64 = kb.LMStep(*(f64(t) for t in step[:4]), *step[4:])
        cand = kb.fused_cost_sums(*cost_args(pts, z), step=step, plan=inv.pcg_plan)
        cand64 = kb.fused_cost_sums_plain(*cost_args(pts, z, f64), step=step64)
        cand32 = kb.fused_cost_sums_plain(*cost_args(pts, z), step=step)
        dps, dp64 = dp_scale(step64, prob, inv), cand64[1] - pts.double()

        def cand_errors(c):
            e = {k: float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                 for k, a, b in zip(("cams", "points"), c[:2], cand64[:2])}
            beyond = ((c[1].double() - cand64[1]).abs() - ulp * cand64[1].abs()).clamp_min(0.0)
            e["dp"] = float(block_errors(beyond, torch.zeros_like(beyond), dps).max())
            e["dp_of_max"] = float((c[1].double() - pts.double() - dp64).abs().max()) / max(
                float(dp64.abs().max()), 1e-30)
            e["cost"] = abs(float(c[2][2]) / float(cand64[2][2]) - 1.0)
            return e

        cerr, cerr32 = cand_errors(cand), cand_errors(cand32)
        seen_dp = resolved(dp64, dps)
        if not (cerr["cams"] <= 1e-5 and cerr["points"] <= 1e-5 and cerr["dp"] <= NE_BAR
                and cerr["cost"] <= 1e-5):
            raise AssertionError(f"fused_cost_sums with a step ({tag}): errors {cerr}, plain fp32 {cerr32}")
        if moved and not seen_dp >= 10 * NE_BAR:
            raise AssertionError(f"fused_cost_sums with a step ({tag}): dp stands {seen_dp:.2e} over its scale")
        again = kb.fused_cost_sums(*cost_args(pts, z), step=step, plan=inv.pcg_plan)
        if not all(torch.equal(x, y) for x, y in zip(cand, again)):
            raise AssertionError(f"fused_cost_sums with a step ({tag}): two runs differ")
        notes["cost"].append(f"{label}: {fmt(cerr)} (plain fp32: {fmt(cerr32)}; median dp over "
                             f"scale {seen_dp:.2e})")
    args, cargs = ne_args(prob.points, inv.z_floor), cost_args(prob.points, inv.z_floor)
    ne_moved, ne_ops = ne_bytes_ops(prob, inv)
    results["fused_ne_payloads" + suffix] = dict(
        max_abs_err=float(max((a.double() - b).abs().max() for a, b in zip(out, ref))),
        ms=time_ms(lambda: kb.fused_ne_payloads(*args, plan=inv.pcg_plan), device),
        plain_ms=time_ms(lambda: kb.fused_ne_payloads_plain(*args), device, PLAIN_RUNS),
        library_ms=None, **bound(ne_moved, ne_ops, FP32_OPS_PER_S),
        device_ms=device_ms(lambda: kb.fused_ne_payloads(*args, plan=inv.pcg_plan), device),
        note=f"{shape}: errors vs float64 (ne_errors) " + "; ".join(notes["ne"]) + "; deterministic")
    c_moved, c_ops = cost_bytes_ops(prob, inv, step=True)
    results["fused_cost_sums" + suffix] = dict(
        max_abs_err=max(float((a.double() - b).abs().max()) for a, b in zip(cand, cand64)),
        ms=time_ms(lambda: kb.fused_cost_sums(*cargs, step=step, plan=inv.pcg_plan), device),
        plain_ms=time_ms(lambda: kb.fused_cost_sums_plain(*cargs, step=step), device, PLAIN_RUNS),
        library_ms=None, **bound(c_moved, c_ops, FP32_OPS_PER_S),
        device_ms=device_ms(lambda: kb.fused_cost_sums(*cargs, step=step, plan=inv.pcg_plan), device),
        note=f"{shape}, with each input's own step: errors vs float64 " + "; ".join(notes["cost"])
             + f"; at the given parameters {time_ms(lambda: kb.fused_cost_sums(*cargs, plan=inv.pcg_plan), device):.4f} ms, "
             f"sums {sums.tolist()}, bound {bound(*cost_bytes_ops(prob, inv, step=False), FP32_OPS_PER_S)['bound_ms'] * 1e3:.2f} us; "
             "deterministic")
    return results


def check_k9(prob, cfg, device):
    """K9 on a BA problem's own segment tables (check_segment_sum); the
    record's row is the camera side at K = 42."""
    from sfm_tpu_torch.ba import core

    inv = core.solve_invariants(prob, core.near_plane_floor(prob))
    k9 = check_segment_sum(inv, prob.obs_w.shape[0], prob.num_cameras, prob.num_points, device)
    log_shapes("cam_segment_sum", k9)
    return {"cam_segment_sum": dict(next(r for r in k9 if r["side"] == "camera" and r["K"] == NE_CAM_ROWS),
                                    shapes=k9)}


# K9 at the rows an 8-wide solve gives it: y (8), the camera payload (72)
# and the payload with the Schur-Jacobi entries (108), the widths that
# ne_cams_kernel sums in one and two 64-column tiles.
WIDE_K9_SIDES = (("camera", 8), ("camera", 72), ("camera", 108))
# K9 at the rows the 8-wide large-camera route gives it: K10's y (8), K8's
# payload (64), K4's camera payload (72); K10's u (3) and K4's point
# payload (9) on the point side.
BIG_WIDE_K9_SIDES = (("camera", 8), ("camera", 64), ("camera", 72), ("point", 3), ("point", 9))


def check_segment_sum(inv, O: int, C: int, P: int, device,
                      sides=(("camera", 6), ("camera", 36), ("camera", NE_CAM_ROWS), ("point", 3),
                             ("point", 9))):
    """K9 at the row counts the solver hands it, on a solve's own segment
    tables: by default the camera side (a permutation) for K = 6 (K10's y),
    36 (K8's payload) and 42 (the camera payload), the point side (sorted)
    for K = 3 (K10's u) and 9 (the point payload); an 8-wide solve's rows
    with WIDE_K9_SIDES. On standard-normal values. Each is
    held to 2e-6 of the output's max against the plain version in float64 on
    the same values (the fp32 plain version on a GPU adds with atomics in an
    order that changes from run to run; the kernel's own fp32 sums of up to a
    few thousand terms stay under 1e-6) and must give identical bits on a
    rerun. library_ms: torch.segment_reduce on the point side; on the camera
    side index_select into camera order, then torch.segment_reduce (two
    calls; the port calls neither). Bytes: the N weighted observations' rows,
    the tables, the output."""
    import torch

    from sfm_tpu_torch.kernels import ba_kernels as kb

    N = inv.cam_perm.numel()
    gen = torch.Generator(device=device).manual_seed(9)
    perm_long = inv.cam_perm.long()
    rows = []
    for side, K in sides:
        values = torch.randn((K, O), generator=gen, device=device)
        if side == "camera":
            args, S = (values, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm), C
            library = lambda: torch.segment_reduce(torch.index_select(values.T, 0, perm_long), "sum",
                                                   offsets=inv.cam_bounds, axis=0)
        else:
            args, S = (values, None, inv.point_bounds), P
            library = lambda: torch.segment_reduce(values.T, "sum", offsets=inv.point_bounds, axis=0)
        out = kb.cam_segment_sum(*args)
        ref = kb.cam_segment_sum_plain(values.double(), *args[1:3])
        err, rel = max_rel(out, ref)
        if rel > 2e-6:
            raise AssertionError(f"cam_segment_sum {side} side K={K} S={S}: relative error {rel}")
        # The yardstick adds each segment's terms one after the other in fp32
        # (hundreds on the camera side): it is held to 1e-5, the kernel to 2e-6.
        if max_rel(library(), ref)[1] > 1e-5:
            raise AssertionError(f"cam_segment_sum {side} side K={K}: torch.segment_reduce computes "
                                 "something else")
        if not torch.equal(out, kb.cam_segment_sum(*args)):
            raise AssertionError(f"cam_segment_sum {side} side K={K}: two runs differ (must be deterministic)")
        rows.append(dict(
            shape=f"{side} side [{K}, {O}] ({N} weighted) -> [{S}, {K}]", side=side, K=K, S=S,
            max_abs_err=err,
            ms=time_ms(lambda: kb.cam_segment_sum(*args), device),
            plain_ms=time_ms(lambda: kb.cam_segment_sum_plain(*args[:3]), device, PLAIN_RUNS),
            library_ms=time_ms(library, device),
            device_ms=device_ms(lambda: kb.cam_segment_sum(*args), device),
            **bound(4 * (K * N + (N if side == "camera" else 0) + S + 1 + S * K), K * N, FP32_OPS_PER_S),
            note=f"[{K}, {O}] ({N} weighted) -> [{S}, {K}], rel err {rel:.2e} vs the plain version in "
                 "float64, deterministic; library_ms: " +
                 ("index_select + torch.segment_reduce (two calls)" if side == "camera"
                  else "torch.segment_reduce")))
    return rows


def schur_problem(device, num_cameras: int = 100, num_points: int = 500):
    """An orbit scene of num_cameras cameras seeing num_points points,
    perturbed, with 5% outliers: at the defaults C = 128 and O = 65536 after
    padding, every point in ~100 views (long point segments, which the
    incremental slice's short tracks do not exercise). tools/torch_perf.py
    crossover sweeps its sizes."""
    from sfm_tpu_torch.ba.problem import build_problem

    prob, _, _ = build_problem(orbit_reconstruction(num_cameras, num_points), device=device)
    return prob


def orbit_reconstruction(num_cameras: int, num_points: int, outliers: float = 0.05):
    """schur_problem's model as a Reconstruction (that share of the
    observations moved by 20 px)."""
    import numpy as np

    from sfm_tpu_torch.scene.state import Reconstruction
    from sfm_tpu_torch.utils.synthetic import make_orbit_scene

    scene = make_orbit_scene(num_cameras=num_cameras, num_points=num_points,
                             image_size=(SLICE_IMAGE,) * 2, focal=SLICE_FOCAL, noise_px=0.5, seed=5)
    rng = np.random.default_rng(6)
    obs = np.argwhere(scene.visible)
    uv = scene.pixels[obs[:, 0], obs[:, 1]].copy()
    out = rng.random(len(uv)) < outliers
    uv[out] += rng.normal(0, 20, (int(out.sum()), 2)).astype(np.float32)
    K = num_cameras
    return Reconstruction(
        intrinsics=scene.intrinsics.copy(),
        rvecs=scene.rvecs + rng.normal(0, 0.01, (K, 3)).astype(np.float32),
        tvecs=scene.tvecs + rng.normal(0, 0.01, (K, 3)).astype(np.float32),
        registered=np.ones(K, bool),
        points=scene.points + rng.normal(0, 0.02, scene.points.shape).astype(np.float32),
        point_errors=np.zeros(num_points, np.float32), point_valid=np.ones(num_points, bool),
        obs_point=obs[:, 1].astype(np.int32), obs_image=obs[:, 0].astype(np.int32),
        obs_kp=obs[:, 1].astype(np.int32), obs_uv=uv.astype(np.float32),
    )


def check_big(prob, cfg, device):
    """K4, K6, K8 and K10 on a BA problem of more than 4096 cameras, at the
    inputs of its first LM iteration, against their plain versions; then
    K3, K5, K7 and K11 (which serve any camera count) on the same inputs, so
    that each twin pair is timed side by side. K10 is the coupling code of
    the large-C pcg_solve (check_pcg holds that solve). Tolerances: K4's W and
    camera payload 1e-6 of each block's max against K3's W and packed
    camera rows on the same inputs (the same device code on rows gathered
    elsewhere; K3 is held to its plain version on the other slices'
    problems) and 1e-3 against its plain version in
    float64: on a merged model the world origin lies many depths from a
    camera's points, R p + t cancels, and any fp32 evaluation of the
    residual (the kernel's or the plain version's, which sit 3e-4 apart)
    moves the IRLS weight of an observation by ~1e-4; K6 rtol 1e-5 against
    the plain version in float64 (sum order) and identical bits on a rerun,
    K5's sums at the same parameters rtol 1e-5 against the same; K8 1e-5 of
    max against the plain version in float64
    (K7's bar; no sums over observations, but the three-term products cancel:
    the fp32 plain version itself sits at 9e-7); K10 1e-5 of max against the
    plain version in float64 (K11's bar: fp32 tree sums over a point's ~100
    observations, with cancellation in the signed sums), identical bits on a
    rerun; K8 and K10 reduced by K9 against K7 and K11 to 1e-5. K4 and K6 are
    checked once more with the near-plane floor raised. The route's
    whole-block damping and inversion (core._sym3_big, _damp_big,
    _sym_solve3_big) must give the bits of sym3, damp and sym_solve3 on this
    problem's blocks. An 8-wide problem (phase 13) runs the `_w8` builds of
    all eight, at the same bars, and K9 at its rows (BIG_WIDE_K9_SIDES).
    Returns (results of the four by launch name, twin timings, K9's rows on
    this problem's segment tables)."""
    import torch

    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.kernels import ba_kernels as kb

    if not core.uses_big_kernels(prob):
        raise AssertionError(f"big-C check: C={prob.num_cameras} takes the small-C kernels")
    inv, ne = first_iteration_inputs(prob, cfg)
    O, C, P, N = prob.obs_w.shape[0], prob.num_cameras, prob.num_points, inv.cam_perm.numel()
    D = prob.cam_params.shape[-1]
    suffix = "" if D == 6 else "_w8"
    shape = f"O={O} ({N} weighted) C={C} P={P}" + (f" D={D}" if D != 6 else "")
    pts_t = core._pts_t(prob, prob.points)
    cams = prob.cam_params.contiguous()
    cams_t = core._rows_t(cams, prob.obs_cam)
    loss = (cfg.robust_loss, cfg.robust_scale_px)
    results, twins = {}, {}

    def big_args(z_floor):
        return (pts_t, inv.static_t, cams_t, inv.intr_t, z_floor, *loss)

    def big_args64(z_floor):
        return (*(t.double() for t in big_args(z_floor)[:4]), z_floor.double(), *loss)

    # K3 and K5 serve any camera count, on pcg_solve's plan (made at any count).
    plan = inv.pcg_plan
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=device)

    def small_args(z_floor):
        return (prob.obs_cam, prob.obs_point, prob.points, inv.static_t, cams, prob.intrinsics, inv.point_bounds,
                inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm, lam, z_floor, *loss)

    def cost_args(z_floor):
        return (prob.obs_cam, prob.obs_point, prob.points, inv.static_t, cams, prob.intrinsics, inv.point_bounds,
                z_floor, *loss)

    for raised, zf in ((True, raised_floor(prob)), (False, inv.z_floor)):
        tag = " (gate raised)" if raised else ""
        out = kb.fused_ne_payloads_big(*big_args(zf))
        ref = kb.fused_ne_payloads_big_plain(*big_args64(zf))
        errs = [max_rel(x, y) for x, y in zip(out, ref)]
        # The same device code as K3's: W, and the camera rows in K3's packed order.
        k3 = kb.fused_ne_payloads(*small_args(zf), plan=plan)
        twin = [max_rel(out[0], k3[2]), max_rel(out[2][:, inv.cam_perm.long()].T, k3[5])]
        if max(e[1] for e in errs) > MERGED_NE_BAR or max(e[1] for e in twin) > 1e-6:
            raise AssertionError(f"fused_ne_payloads_big{suffix}{tag}: relative errors {errs}, vs K3 (W, "
                                 f"camera rows) {twin}")
        sums = kb.fused_cost_sums_big(*big_args(zf))
        sums_ref = kb.fused_cost_sums_big_plain(*big_args64(zf))
        if not torch.allclose(sums.double(), sums_ref, rtol=1e-5, atol=0.0):
            raise AssertionError(f"fused_cost_sums_big{suffix}{tag}: {sums.tolist()} vs {sums_ref.tolist()}")
        sums5 = kb.fused_cost_sums(*cost_args(zf), plan=plan)[2]
        if not torch.allclose(sums5[:2].double(), sums_ref, rtol=1e-5, atol=0.0):
            raise AssertionError(f"fused_cost_sums_big{suffix}{tag}: K5 gives {sums5.tolist()}")
        if not torch.equal(sums, kb.fused_cost_sums_big(*big_args(zf))):
            raise AssertionError(f"fused_cost_sums_big{suffix}{tag}: two runs differ (must be deterministic)")
        if raised and not float(sums[1]) < float(prob.obs_w.sum()):
            raise AssertionError("fused_cost_sums_big: the near-plane gate removed nothing")
    a4, a3, a5 = big_args(inv.z_floor), small_args(inv.z_floor), cost_args(inv.z_floor)
    obs_in = nbytes(*a4[:4])
    results["fused_ne_payloads_big" + suffix] = dict(
        max_abs_err=max(e[0] for e in errs),
        ms=time_ms(lambda: kb.fused_ne_payloads_big(*a4), device),
        plain_ms=time_ms(lambda: kb.fused_ne_payloads_big_plain(*a4), device, PLAIN_RUNS),
        library_ms=None, **bound(obs_in + nbytes(*out), (300 if D == 6 else 420) * O, FP32_OPS_PER_S),
        device_ms=device_ms(lambda: kb.fused_ne_payloads_big(*a4), device),
        note=f"{shape}, rel err {max(e[1] for e in errs):.2e} (vs K3's W and camera rows "
             f"{max(e[1] for e in twin):.2e}); also with the gate raised")
    results["fused_cost_sums_big" + suffix] = dict(
        max_abs_err=float((sums - sums_ref).abs().max()),
        ms=time_ms(lambda: kb.fused_cost_sums_big(*a4), device),
        plain_ms=time_ms(lambda: kb.fused_cost_sums_big_plain(*a4), device, PLAIN_RUNS),
        library_ms=None, **bound(obs_in + nbytes(sums), 60 * O, FP32_OPS_PER_S),
        device_ms=device_ms(lambda: kb.fused_cost_sums_big(*a4), device),
        note=f"{shape}, sums {sums.tolist()}, deterministic, K5's within rtol 1e-5; also with the "
             "gate raised")
    gather_ms = time_ms(lambda: core._rows_t(cams, prob.obs_cam), device)
    # K3 builds the whole damped normal equations (point sums, inversions,
    # camera sums); K4 its per-observation payloads only.
    twins["K4 vs K3"] = dict(
        big_ms=results["fused_ne_payloads_big" + suffix]["ms"], gather_ms=gather_ms,
        small_ms=time_ms(lambda: kb.fused_ne_payloads(*a3, plan=plan), device))
    twins["K6 vs K5"] = dict(
        big_ms=results["fused_cost_sums_big" + suffix]["ms"], gather_ms=gather_ms,
        small_ms=time_ms(lambda: kb.fused_cost_sums(*a5, plan=plan), device))

    # The route's whole-block damping and inversion give the bits of the
    # helpers K3's plain version uses (kernels.ba_kernels sym3, damp,
    # sym_solve3) on this problem's point and camera blocks.
    _, yp_t, cam_t = kb.fused_ne_payloads_big(*big_args(inv.z_floor))
    red6 = kb.cam_segment_sum(yp_t, None, inv.point_bounds)[:, :6]
    hcc = kb.cam_segment_sum(cam_t, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm)[:, :D * D].reshape(C, D, D)
    hpp = kb.damp(kb.sym3(red6), lam)
    if not (torch.equal(core._sym3_big(red6), kb.sym3(red6))
            and torch.equal(core._damp_big(kb.sym3(red6), lam), hpp)
            and torch.equal(core._damp_big(hcc, lam), kb.damp(hcc, lam))
            and torch.equal(core._sym_solve3_big(hpp), kb.sym_solve3(hpp))):
        raise AssertionError("the large-C route's block damping and inversion differ from sym3, damp, sym_solve3")
    log(f"[big] {shape}: the route's block damping and inversion bit-identical to sym3, damp, sym_solve3")

    W_t, Hinv = ne.W_t, ne.Hpp_inv
    k8 = (W_t, Hinv, prob.obs_point)
    out = kb.whw_payloads_big(*k8)
    err, rel = max_rel(out, kb.whw_payloads_big_plain(W_t.double(), Hinv.double(), prob.obs_point))
    if rel > 1e-5:
        raise AssertionError(f"whw_payloads_big{suffix}: relative error {rel} ({shape})")
    if not torch.equal(out, kb.whw_payloads_big(*k8)):
        raise AssertionError(f"whw_payloads_big{suffix}: two runs differ (must be deterministic)")
    k7 = (W_t, Hinv, prob.obs_point, inv.cam_perm, inv.cam_bounds)
    whw7 = kb.whw_cam_reduce(*k7, inv.cam_inv_perm)
    rel7 = max_rel(kb.cam_segment_sum(out, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm), whw7.double())[1]
    if rel7 > 1e-5:
        raise AssertionError(f"whw_payloads_big{suffix} + cam_segment_sum vs whw_cam_reduce: {rel7}")
    # Bytes: W's 3D rows, the point ids, the point blocks, D^2 rows out.
    # Operations: u = W Hinv (18 D), then D^2 three-term dot products.
    results["whw_payloads_big" + suffix] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kb.whw_payloads_big(*k8), device),
        plain_ms=time_ms(lambda: kb.whw_payloads_big_plain(*k8), device, PLAIN_RUNS),
        library_ms=None, **bound(4 * (3 * D * O + O + 9 * P + D * D * O), (18 * D + 6 * D * D) * O,
                                 FP32_OPS_PER_S),
        device_ms=device_ms(lambda: kb.whw_payloads_big(*k8), device),
        note=f"{shape}, rel err {rel:.2e} vs the plain version in float64, deterministic; "
             f"reduced by K9 it is K7's output to {rel7:.2e}")
    twins["K8 (+K9) vs K7"] = dict(
        big_ms=results["whw_payloads_big" + suffix]["ms"],
        reduce_ms=time_ms(lambda: kb.cam_segment_sum(out, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm), device),
        small_ms=time_ms(lambda: kb.whw_cam_reduce(*k7, inv.cam_inv_perm), device))

    v = torch.randn((C, D), generator=torch.Generator(device=device).manual_seed(7), device=device)
    v_obs_t = core._rows_t(v, prob.obs_cam)
    k10 = (W_t, Hinv, prob.obs_point, inv.point_bounds, inv.cam_inv_perm.numel(), v_obs_t)
    y_t = kb.schur_coupling_payloads_big(*k10)
    err, rel = max_rel(y_t, kb.schur_coupling_payloads_big_plain(
        W_t.double(), Hinv.double(), *k10[2:5], v_obs_t.double()))
    if rel > 1e-5:
        raise AssertionError(f"schur_coupling_payloads_big{suffix}: relative error {rel} ({shape})")
    if not torch.equal(y_t, kb.schur_coupling_payloads_big(*k10)):
        raise AssertionError(f"schur_coupling_payloads_big{suffix}: two runs differ (must be deterministic)")
    k11 = (W_t, Hinv, prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm, inv.cam_bounds, v,
           inv.cam_inv_perm)
    out11 = kb.schur_coupling_matvec(*k11)
    rel11 = max_rel(kb.cam_segment_sum(y_t, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm), out11.double())[1]
    if rel11 > 1e-5:
        raise AssertionError(f"schur_coupling_payloads_big{suffix} + cam_segment_sum vs schur_coupling_matvec: "
                             f"{rel11}")
    # Bytes: W's 3D rows, the point ids and segments, the point blocks, v
    # and y (D rows each). Operations: W^T v and W h (6 D each) and the
    # point sums per observation, Hinv g per point.
    results["schur_coupling_payloads_big" + suffix] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kb.schur_coupling_payloads_big(*k10), device),
        plain_ms=time_ms(lambda: kb.schur_coupling_payloads_big_plain(*k10), device, PLAIN_RUNS),
        library_ms=None,
        **bound(4 * (3 * D * O + O + P + 1 + 9 * P + D * O + D * O), (12 * D + 9) * O + 18 * P, FP32_OPS_PER_S),
        device_ms=device_ms(lambda: kb.schur_coupling_payloads_big(*k10), device),
        note=f"{shape}, rel err {rel:.2e} vs the plain version in float64, deterministic; "
             f"reduced by K9 it is K11's output to {rel11:.2e}")
    twins["K10 (+K9) vs K11"] = dict(
        big_ms=results["schur_coupling_payloads_big" + suffix]["ms"],
        gather_ms=time_ms(lambda: core._rows_t(v, prob.obs_cam), device),
        reduce_ms=time_ms(lambda: kb.cam_segment_sum(y_t, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm), device),
        small_ms=time_ms(lambda: kb.schur_coupling_matvec(*k11), device))
    del out, y_t, v_obs_t, out11, whw7
    return results, twins, (check_segment_sum(inv, O, C, P, device) if D == 6 else
                            check_segment_sum(inv, O, C, P, device, BIG_WIDE_K9_SIDES))


def arc_ring_reconstruction(num_cameras: int, num_points: int, track_range: tuple[int, int],
                            seed: int, noise_px: float = 0.5, outlier_fraction: float = 0.01,
                            centre_noise: float = 0.05):
    """A merged model as the divide-and-conquer pipeline hands it to its
    polish, built with numpy alone (no dense [C, P] table): num_cameras
    cameras one unit apart on a ring, looking outward; each point lies
    outside the ring and is seen by a contiguous arc of cameras whose length
    is drawn from track_range, at a depth of 3 arc lengths (baseline over
    depth 1/3; nearer points would put the world origin thousands of depths
    away and the fp32 camera blocks past their conditioning). Pixels carry noise_px of Gaussian noise and outlier_fraction
    of them a gross offset of 60-200 px; rotations, camera centres and
    points are perturbed (2 mrad, centre_noise units, 0.5% of the depth). obs_kp holds the observation's row
    number, so a caller can tell which rows a filter dropped. Returns
    (Reconstruction, ground truth: rvecs, tvecs, radius, outlier rows)."""
    import types

    import numpy as np
    import torch

    from sfm_tpu_torch.geometry.projection import project
    from sfm_tpu_torch.scene.state import Reconstruction

    rng = np.random.default_rng(seed)
    C, P = num_cameras, num_points
    radius = C / (2 * np.pi)
    phi = 2 * np.pi * np.arange(C) / C
    # World -> camera: a rotation about y by phi - pi/2 turns the outward
    # radial direction (cos phi, 0, sin phi) into the camera's z axis.
    alpha = (phi - np.pi / 2 + np.pi) % (2 * np.pi) - np.pi
    rvecs = np.stack([np.zeros(C), alpha, np.zeros(C)], 1)
    centres = radius * np.stack([np.cos(phi), np.zeros(C), np.sin(phi)], 1)
    ca, sa = np.cos(alpha), np.sin(alpha)
    R = np.zeros((C, 3, 3))
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1], R[:, 2, 0], R[:, 2, 2] = ca, sa, 1.0, -sa, ca
    tvecs = -np.einsum("cij,cj->ci", R, centres)
    intrinsics = np.tile(np.asarray([400.0, 400.0, 256.0, 256.0, 0.0, 0.0], np.float32), (C, 1))

    length = rng.integers(track_range[0], track_range[1] + 1, P)
    first = rng.integers(0, C, P)
    depth = 3.0 * length * rng.uniform(0.9, 1.1, P)
    mid = 2 * np.pi * (first + (length - 1) / 2) / C
    points = np.stack([(radius + depth) * np.cos(mid), depth * rng.uniform(-0.3, 0.3, P),
                       (radius + depth) * np.sin(mid)], 1)
    obs_point = np.repeat(np.arange(P), length)
    rank = np.arange(len(obs_point)) - np.repeat(np.cumsum(length) - length, length)
    obs_image = (first[obs_point] + rank) % C
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    uv = project(f32(points[obs_point]), f32(rvecs[obs_image]), f32(tvecs[obs_image]),
                 f32(intrinsics[obs_image])).numpy().astype(np.float64)
    uv += rng.normal(0, noise_px, uv.shape)
    outlier = np.where(rng.random(len(uv)) < outlier_fraction)[0]
    ang = rng.uniform(0, 2 * np.pi, len(outlier))
    uv[outlier] += rng.uniform(60, 200, len(outlier))[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)

    from sfm_tpu_torch.geometry.rotations import so3_exp

    noisy_rvecs = (rvecs + rng.normal(0, 0.002, (C, 3))).astype(np.float32)
    noisy_R = so3_exp(torch.from_numpy(noisy_rvecs)).numpy().astype(np.float64)
    noisy_tvecs = -np.einsum("cij,cj->ci", noisy_R, centres + rng.normal(0, centre_noise, (C, 3)))
    rec = Reconstruction(
        intrinsics=intrinsics, rvecs=noisy_rvecs, tvecs=noisy_tvecs.astype(np.float32),
        registered=np.ones(C, bool),
        points=(points + rng.normal(0, 0.005, (P, 3)) * depth[:, None]).astype(np.float32),
        point_errors=np.zeros(P, np.float32), point_valid=np.ones(P, bool),
        obs_point=obs_point.astype(np.int32), obs_image=obs_image.astype(np.int32),
        obs_kp=np.arange(len(obs_point), dtype=np.int32), obs_uv=uv.astype(np.float32),
    )
    truth = types.SimpleNamespace(rvecs=rvecs.astype(np.float32), tvecs=tvecs.astype(np.float32),
                                  radius=radius, outlier_rows=outlier)
    return rec, truth


def check_schur(prob, cfg, device):
    """K7 and K11 on a PCG-sized BA problem, at the normal equations of its
    first LM iteration (K11 on a random v), against their plain versions
    evaluated in float64 on the same inputs. Tolerance 1e-5 of the output's
    max: both kernels sum in fp32, each camera's (and each point's) terms in
    a fixed tree order, so the error is bounded by ~log2(n) * eps of the
    summed magnitudes (n up to ~1000 terms per camera, ~1e-6), with a margin
    for the cancellation in K11's signed sums. Both must give identical bits
    on a rerun. K7 twice: its standalone entry, and the blocks that K3
    builds with the normal equations for a PCG solve (the path's K7: the
    same bar and rerun; its other outputs bit-identical to K3 without the
    blocks; within 1e-6 of the standalone entry, which runs the same device
    code), with K3's time without and with the blocks. An 8-wide problem
    runs the 8-wide builds, under their names (`_w8`)."""
    import torch

    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.kernels import ba_kernels as kb

    inv, ne = first_iteration_inputs(prob, cfg)
    O, C, P, N = prob.obs_w.shape[0], prob.num_cameras, prob.num_points, inv.cam_perm.numel()
    D = prob.cam_params.shape[-1]
    suffix = "" if D == 6 else "_w8"
    if core.uses_dense_solver(prob, cfg):
        raise AssertionError(f"schur check: C={C}, O={O} takes the dense solver, not PCG")
    W_t, Hinv = ne.W_t, ne.Hpp_inv
    shape = f"O={O} ({N} weighted) C={C} P={P}"
    results = {}

    k7 = (W_t, Hinv, prob.obs_point, inv.cam_perm, inv.cam_bounds)
    out = kb.whw_cam_reduce(*k7, inv.cam_inv_perm)
    ref = kb.whw_cam_reduce_plain(W_t.double(), Hinv.double(), *k7[2:])
    err, rel = max_rel(out, ref)
    if rel > 1e-5:
        raise AssertionError(f"whw_cam_reduce: relative error {rel} ({shape})")
    if not torch.equal(out, kb.whw_cam_reduce(*k7, inv.cam_inv_perm)):
        raise AssertionError("whw_cam_reduce: two runs differ (must be deterministic)")
    # The path's K7: the blocks out of K3's two launches (schur_jacobi, a PCG
    # solve's build), the same bar, the normal equations untouched by them.
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=device)
    k3 = (prob.obs_cam, prob.obs_point, prob.points, inv.static_t, prob.cam_params.contiguous(),
          prob.intrinsics, inv.point_bounds, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm, lam,
          inv.z_floor, cfg.robust_loss, cfg.robust_scale_px)
    with_blocks = kb.fused_ne_payloads(*k3, plan=inv.pcg_plan, schur_jacobi=True)
    without = kb.fused_ne_payloads(*k3, plan=inv.pcg_plan)
    if not (all(torch.equal(a, b) for a, b in zip(with_blocks[:5], without[:5]))
            and torch.equal(with_blocks[5][:, :kb.ne_cam_rows(D)], without[5])):
        raise AssertionError(f"fused_ne_payloads: the Schur-Jacobi blocks changed the normal equations ({shape})")
    blocks = with_blocks[6]
    err3, rel3 = max_rel(blocks, kb.whw_cam_reduce_plain(with_blocks[2].double(), with_blocks[1].double(),
                                                         *k7[2:]))
    if rel3 > 1e-5:
        raise AssertionError(f"fused_ne_payloads' Schur-Jacobi blocks: relative error {rel3} ({shape})")
    if not torch.equal(blocks, kb.fused_ne_payloads(*k3, plan=inv.pcg_plan, schur_jacobi=True)[6]):
        raise AssertionError("fused_ne_payloads' Schur-Jacobi blocks: two runs differ (must be deterministic)")
    # The same device code as the standalone entry on the same W and Hpp^-1.
    twin = max_rel(blocks, out.double())[1]
    if twin > 1e-6:
        raise AssertionError(f"fused_ne_payloads' Schur-Jacobi blocks vs whw_cam_reduce: {twin}")
    # Bytes: the N weighted observations' W and ids, each point's H^-1, the
    # camera segments, the output. Operations: the D x D product per
    # observation (324 at D = 6).
    moved = 4 * (3 * D * N + 9 * P + 2 * N + C + 1 + D * D * C)
    k3_ms = [time_ms(lambda: kb.fused_ne_payloads(*k3, plan=inv.pcg_plan, schur_jacobi=sj), device)
             for sj in (False, True)]
    k3_dev = [device_ms(lambda: kb.fused_ne_payloads(*k3, plan=inv.pcg_plan, schur_jacobi=sj), device)
              for sj in (False, True)]
    results["whw_cam_reduce" + suffix] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kb.whw_cam_reduce(*k7, inv.cam_inv_perm), device),
        plain_ms=time_ms(lambda: kb.whw_cam_reduce_plain(*k7), device, PLAIN_RUNS),
        library_ms=None, **bound(moved, 9 * D * D * N, FP32_OPS_PER_S),
        device_ms=device_ms(lambda: kb.whw_cam_reduce(*k7, inv.cam_inv_perm), device),
        k3_ms=k3_ms, k3_device_ms=k3_dev,
        note=f"{shape}, standalone entry: rel err {rel:.2e} vs the plain version in float64, "
             f"deterministic; in K3 (the path): rel err {rel3:.2e} ({err3:.3e}), deterministic, "
             f"{'bit-identical to' if twin == 0.0 else f'{twin:.2e} from'} the standalone entry; K3 "
             f"without / with the blocks {k3_ms[0]:.4f} / {k3_ms[1]:.4f} ms"
             + ("" if k3_dev[0] is None else f", device {k3_dev[0] * 1e3:.2f} / {k3_dev[1] * 1e3:.2f} us"))

    v = torch.randn((C, D), generator=torch.Generator(device=device).manual_seed(7),
                    device=device)
    k11 = (W_t, Hinv, prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm,
           inv.cam_bounds, v, inv.cam_inv_perm)
    out = kb.schur_coupling_matvec(*k11)
    ref = kb.schur_coupling_matvec_plain(W_t.double(), Hinv.double(), *k11[2:7], v.double())
    err, rel = max_rel(out, ref)
    if rel > 1e-5:
        raise AssertionError(f"schur_coupling_matvec: relative error {rel} ({shape})")
    if not torch.equal(out, kb.schur_coupling_matvec(*k11)):
        raise AssertionError("schur_coupling_matvec: two runs differ (must be deterministic)")
    # Bytes: the N weighted observations' W and camera ids, each point's
    # H^-1 and bounds, the camera segments, v and the output (obs_point is
    # not needed: the point segments come from point_bounds). Operations: u
    # and y (6D multiply-adds each) and the sums per observation, h per point.
    moved = 4 * (3 * D * N + N + 9 * P + P + 1 + N + C + 1 + D * C + D * C)
    results["schur_coupling_matvec" + suffix] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kb.schur_coupling_matvec(*k11), device),
        plain_ms=time_ms(lambda: kb.schur_coupling_matvec_plain(*k11[:8]), device, PLAIN_RUNS),
        library_ms=None, **bound(moved, (12 * D + 9) * N + 18 * P, FP32_OPS_PER_S),
        device_ms=device_ms(lambda: kb.schur_coupling_matvec(*k11), device),
        note=f"{shape}, rel err {rel:.2e} vs the plain version in float64, deterministic")
    return results


def check_pcg(prob, cfg, device, what: str, streaming: bool | None = None,
              blocks: int | None = None, x_steps: int | None = None):
    """pcg_solve (the whole PCG solve in one launch) on a PCG-sized BA
    problem at the inputs of its first LM iteration (normal equations,
    Schur-Jacobi preconditioner, rhs), against pcg_solve_plain in float64 on
    the same inputs: x within 1e-3 of max|x| after cfg.cg_iterations steps
    (fp32 CG drifts from the float64 iterates), or after x_steps steps where
    given (PCG_X_STEPS on the merged polishes: their float64 solves are far
    from converged after 64 steps, and the fp32 drift of any order of sums
    grows step by step), |S x - rhs| at most twice the float64 solution's
    + 1e-6 |rhs| after cfg.cg_iterations steps (S applied in float64),
    within 1e-5 after one step; identical bits on a rerun. streaming=True forces the mode
    that reads W from device memory every step; blocks replaces the card's
    grid by a grid of that many blocks (each then owns more cameras). Past
    MAX_CAMS cameras (the merged polish at full width) this is the launch
    counted as pcg_solve_big, in the streaming mode its plan picks. Timed
    beside loop_ms: the same solve as Python steps over the coupling matvec
    that pcg_solve replaced (pcg_loop over schur_matvec_step: the
    coupling-only K11, or K10 then K9 past MAX_CAMS), and the plain version
    in fp32; device_ms and loop_device_ms from torch.profiler. Bound: the
    operations of cfg.cg_iterations steps over the weighted rows against
    the bytes: what a step must read (the weighted rows' W, camera and
    camera-sorted place, the point and camera blocks) once, rhs and x once,
    and, in every step after the first, again the part of a step's reads
    that all SMs' shared memory (SMEM_BYTES, 30.7 MB) cannot hold: on the
    merged polish W alone is 108 MB, so most of it comes from device memory
    every step. The 50 MB L2 is not counted as holding any of it between
    steps: it is a cache that W streams through, not storage a kernel fills
    (an L2 access-policy window that pinned part of W could go below this
    bound; not tried). The per-step scratch (packed y rows, camera
    vectors) is not charged. An 8-wide problem runs the 8-wide build."""
    import torch

    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.kernels import ba_kernels as kb

    inv, ne = first_iteration_inputs(prob, cfg)
    O, C, P, M = prob.obs_w.shape[0], prob.num_cameras, prob.num_points, inv.cam_perm.numel()
    N, D = inv.cam_inv_perm.numel(), prob.cam_params.shape[-1]
    if core.uses_dense_solver(prob, cfg):
        raise AssertionError(f"pcg check: C={C}, O={O} takes the dense solver, not PCG")
    M_inv, d = core.pcg_preconditioner(ne, prob, inv)
    rhs = core._schur_rhs(ne, prob, inv).contiguous()
    if device.type == "cuda" and blocks is None:
        plan = kb.pcg_launch_plan(inv.point_bounds, streaming, cam_dim=D)
    else:  # on the CPU pcg_solve takes its plain version: the plan only labels the row
        plan = kb.pcg_plan(inv.point_bounds, blocks or 4, streaming=streaming, cam_dim=D)
        plan = plan._replace(block_points=plan.block_points.to(device))
    its, tol = cfg.cg_iterations, cfg.cg_tolerance
    tables = (prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm, inv.cam_bounds)
    args = (ne.W_t, ne.Hpp_inv, *tables, inv.cam_inv_perm, ne.Hcc, M_inv, d, rhs)
    W64, H64, Hcc64, M64, d64, rhs64 = (t.double() for t in (ne.W_t, ne.Hpp_inv, ne.Hcc, M_inv, d, rhs))

    def fused(n):
        return kb.pcg_solve(*args, n, tol, plan=plan)

    def plain64(n):
        return kb.pcg_solve_plain(W64, H64, *tables, Hcc64, M64, d64, rhs64, n, tol)

    def plain32(n=its):
        return kb.pcg_solve_plain(ne.W_t, ne.Hpp_inv, *tables, ne.Hcc, M_inv, d, rhs, n, tol)

    def residual(x):
        Sx = torch.einsum("cij,cj->ci", Hcc64, x) - kb.schur_coupling_matvec_plain(W64, H64, *tables, x)
        return float((Sx - rhs64).norm())

    def loop():
        return kb.pcg_loop(lambda v: schur_matvec_step(ne, prob, v, inv), M_inv, d, rhs, its, tol)

    shape = (f"{what}: O={O} ({M} weighted) C={C} P={P}" + (f" D={D}" if D != 6 else "")
             + f", {'streaming' if plan.streaming else 'resident'}"
             + (f", {blocks} blocks" if blocks else ""))
    x, ref = fused(its), plain64(its)
    x_its = x_steps or its
    xs, refs = (x, ref) if x_steps is None else (fused(x_steps), plain64(x_steps))
    scale = max(float(refs.abs().max()), 1e-30)
    err = float((xs.double() - refs).abs().max())
    if not err <= 1e-3 * scale:
        raise AssertionError(f"pcg_solve ({shape}): max err {err} against max|x| {scale} after "
                             f"{x_its} steps")
    res, res_ref, rhs_norm = residual(x.double()), residual(ref), float(rhs64.norm())
    if not res <= 2.0 * res_ref + 1e-6 * rhs_norm:
        raise AssertionError(f"pcg_solve ({shape}): |S x - rhs| {res} against {res_ref} in float64")
    ref1 = plain64(1)
    scale1 = max(float(ref1.abs().max()), 1e-30)
    err1 = float((fused(1).double() - ref1).abs().max())
    if not err1 <= 1e-5 * scale1:
        raise AssertionError(f"pcg_solve ({shape}): one step off by {err1} ({err1 / scale1:.2e} of max|x|)")
    err1_32 = float((plain32(1).double() - ref1).abs().max())
    if not torch.equal(x, fused(its)):
        raise AssertionError(f"pcg_solve ({shape}): two runs differ (must be deterministic)")
    # How far fp32 alone drifts from float64 here (not a bar): the plain version in fp32.
    err32 = float((plain32().double() - ref).abs().max())
    # A step reads each weighted row's W, camera and camera-sorted place (80
    # B; 104 at D = 8), each point's Hpp^-1 and bound (40 B), each camera's
    # Hcc, M^-1 and d (312 B; 544); rhs is read and x written once.
    step_bytes = 4 * (3 * D + 2) * M + 40 * P + 4 * (2 * D * D + D) * C
    rereads = max(0, step_bytes - SMEM_BYTES)
    moved = step_bytes + (its - 1) * rereads + 8 * D * C
    return dict(
        shape=shape, max_abs_err=err,
        ms=time_ms(lambda: fused(its), device),
        loop_ms=time_ms(loop, device, PLAIN_RUNS),
        plain_ms=time_ms(plain32, device, PLAIN_RUNS),
        library_ms=None,
        **bound(moved, its * ((12 * D + 9) * M + 18 * P + (4 * D * D + 16) * C), FP32_OPS_PER_S),
        device_ms=device_ms(lambda: fused(its), device),
        loop_device_ms=device_ms(loop, device, calls=1),
        note=f"{shape}, grid {plan.grid}, {plan.smem_bytes} B staged per block, a step's "
             f"{step_bytes} B charged once, {rereads} B of them {its - 1}x more; err {err / scale:.2e} "
             f"of max|x| vs float64 after {x_its} steps (plain fp32 after {its}: "
             f"{err32 / max(float(ref.abs().max()), 1e-30):.2e}), |Sx - rhs| {res:.3e} (float64 "
             f"solution {res_ref:.3e}, |rhs| {rhs_norm:.3e}), one step {err1 / scale1:.2e} of max|x| "
             f"(plain fp32 {err1_32 / scale1:.2e}), deterministic")


def device_time_ms(rows) -> tuple[float, list]:
    """Total device ms of traced rows, and the twelve longest rows."""
    return sum(r[2] for r in rows), rows[:12]


def device_launches(rows) -> int:
    """Kernels, copies and fills the device ran, of traced rows."""
    return sum(r[1] for r in rows)


def profile_calls(fn, device, calls: int = PROFILED_CALLS) -> dict:
    """fn() `calls` times under torch.profiler after a warm-up: device
    launches and device ms per call (per_call), and the four device rows
    that took longest (name, launches and ms per call); then its CUDA-event
    ms per call (time_ms)."""
    fn()
    launches, ms, top = per_call(traced(fn, calls)[0], calls)
    return dict(launches=launches, device_ms=ms, event_ms=time_ms(fn, device), top=top[:4])


def lm_report(prob, cfg, device, stand_in: bool = False) -> dict:
    """The normal-equation build (core.build_normal_equations, as
    bundle_adjust builds it: with K3's Schur-Jacobi blocks on the PCG
    branch) and the LM candidate with its cost, at the first LM iteration
    of one BA problem, each as device launches, device ms (torch.profiler)
    and event ms per call; then one whole bundle_adjust under
    torch.profiler: device launches and device ms per LM iteration, device
    busy ms, wall ms, idle share. The candidate is
    core.lm_candidate where the package has it, else the steps of an older
    LM loop (_back_substitute, the freeze masks, the additions,
    compute_cost), so that tools/torch_perf.py lm can run this on an
    unpacked parent tree. stand_in (C <= MAX_CAMS) adds the chains K3 and
    K5 replace, as the large-camera route still runs them on the same
    problem (core.MAX_CAMS set to 0 for those calls), and
    "lm_iteration_replaced": that iteration's launches with the two chains
    in place of K3 and K5."""
    import torch

    from sfm_tpu_torch.ba import core

    inv = core.solve_invariants(prob, core.near_plane_floor(prob))
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=device)
    cams, points = prob.cam_params, prob.points
    build = pcg_build(core, prob, cfg)   # as bundle_adjust builds: with K3's blocks for PCG
    ne = core.build_normal_equations(prob, cams, points, lam, cfg, inv, **build)
    dc = lm_dc(prob, cfg, inv, ne)

    def candidate(inv):
        if hasattr(core, "lm_candidate"):
            return core.lm_candidate(ne, prob, dc, cams, points, cfg, inv)
        zero = torch.zeros((), device=device)
        dp = core._back_substitute(ne, prob, dc, inv)
        new_cams = cams + torch.where(prob.cam_fixed[:, None], zero, dc)
        new_points = points + torch.where(prob.point_fixed[:, None], zero, dp)
        return new_cams, new_points, core.compute_cost(prob, new_cams, new_points, cfg, inv)

    rows = {"NE build": profile_calls(
                lambda: core.build_normal_equations(prob, cams, points, lam, cfg, inv, **build), device),
            "candidate": profile_calls(lambda: candidate(inv), device)}
    if stand_in:
        saved = core.MAX_CAMS
        core.MAX_CAMS = 0
        try:
            inv_big = core.solve_invariants(prob, inv.z_floor)
            rows["NE chain replaced"] = profile_calls(
                lambda: core.build_normal_equations(prob, cams, points, lam, cfg, inv_big), device)
            rows["candidate chain replaced"] = profile_calls(lambda: candidate(inv_big), device)
        finally:
            core.MAX_CAMS = saved
    trace, wall, (_, stats) = traced(lambda: core.bundle_adjust(prob, cfg))
    its = max(int(stats.iterations), 1)
    busy = device_time_ms(trace)[0]
    per_it = device_launches(trace) / its
    rows["bundle_adjust"] = dict(lm_iterations=its, launches_per_lm_iteration=per_it,
                                 device_ms=busy, device_ms_per_lm_iteration=busy / its, wall_ms=wall,
                                 idle_share=1.0 - busy / wall)
    if stand_in:
        rows["bundle_adjust"]["lm_iteration_replaced"] = per_it + sum(
            rows[old]["launches"] - rows[new]["launches"]
            for old, new in (("NE chain replaced", "NE build"), ("candidate chain replaced", "candidate")))
    return rows


def log_results(what: str, results: dict) -> None:
    for k, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        loop = f"loop {r['loop_ms']:.4f} ms | " if "loop_ms" in r else ""
        log(f"[kernel] {what + ': ' if what else ''}{k}: max_abs_err {r['max_abs_err']:.3e} | kernel {r['ms']:.4f} ms | "
            f"{loop}plain {r['plain_ms']:.4f} ms | library {lib} | bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}) | {r['note']}")


# ---- phase 4: the slice -----------------------------------------------------


def run_slice(device, size: int, blobs: int, **overrides):
    """Two rendered size x size views of a 3D blob scene through
    sfm_tpu_torch.reconstruct; returns (reconstruction, launch counts of that
    call, BA log, wall seconds, ground-truth scene)."""
    from sfm_tpu_torch import kernels, reconstruct
    from sfm_tpu_torch.utils.synthetic import render_blob_scene

    t0 = time.perf_counter()
    imgs, scene = render_blob_scene(image_size=(size, size), num_images=2, num_blobs=blobs,
                                focal=SLICE_FOCAL * size / SLICE_IMAGE, arc_fraction=SLICE_ARC)
    log(f"[slice] rendered 2 x {size}^2 images with {blobs} blobs in {time.perf_counter() - t0:.2f}s")
    with record_bundle_adjustments() as ba_log:
        kernels.reset_launches()
        t0 = time.perf_counter()
        rec = reconstruct(list(imgs), device=device, **overrides)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    return rec, launches, ba_log, wall, scene


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
    missing = [k for k in TWO_VIEW_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"slice: kernels never launched by the main path: {missing}")


# ---- phase 5: the incremental slice ----------------------------------------


@contextlib.contextmanager
def record_bundle_adjustments(keep=None):
    """Record (cameras, observations, solver, LM iterations, seconds) of each
    bundle adjustment the pipeline runs (padded capacities, which decide the
    solver), and the problem and config it was given, by wrapping the BA
    entry point for the duration. With `keep`, only the BAs whose record
    keep(record) passes hold their problem and config (the others None)."""
    import torch

    from sfm_tpu_torch import ba
    from sfm_tpu_torch.ba.core import uses_dense_solver

    log, inner = [], ba.bundle_adjust

    def wrapped(prob, cfg):
        t0 = time.perf_counter()
        out, stats = inner(prob, cfg)
        if prob.cam_params.is_cuda:
            torch.cuda.synchronize()
        b = dict(C=prob.num_cameras, O=int(prob.obs_w.shape[0]), width=prob.cam_params.shape[-1],
                 solver="dense" if uses_dense_solver(prob, cfg) else "pcg",
                 iterations=int(stats.iterations), seconds=time.perf_counter() - t0,
                 initial_cost=float(stats.initial_cost), final_cost=float(stats.final_cost))
        held = keep is None or keep(b)
        log.append(dict(b, problem=prob if held else None, cfg=cfg if held else None))
        return out, stats

    ba.bundle_adjust = wrapped
    try:
        yield log
    finally:
        ba.bundle_adjust = inner


# Scenes being rendered ahead by prefetch_renders, by their render_pool
# keywords: (the views' AsyncResult, the ground truth).
_PREFETCHED = {}


def _scene_key(scene: dict) -> str:
    return json.dumps(scene, sort_keys=True)


def render_pool(**scene):
    """render_blob_scene(**scene), its views rendered by a pool of spawned
    worker processes (numpy only; the same bits as one process), or taken
    from prefetch_renders' pool where it rendered this scene."""
    import multiprocessing
    import os

    import numpy as np

    from sfm_tpu_torch.utils.synthetic import blob_scene_views, render_blob_view

    ahead = _PREFETCHED.pop(_scene_key(scene), None)
    if ahead is not None:
        return np.stack(ahead[0].get()), ahead[1]
    views, truth = blob_scene_views(**scene)
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        return np.stack(pool.map(render_blob_view, views)), truth


@contextlib.contextmanager
def prefetch_renders(scenes):
    """Render `scenes` (render_pool's keyword dicts) in a background pool of
    two spawned processes (the host's other cores serve the phases the card
    runs meanwhile); render_pool takes a scene's views from there. The pool
    stops on leaving."""
    import multiprocessing

    from sfm_tpu_torch.utils.synthetic import blob_scene_views, render_blob_view

    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        for scene in scenes:
            views, truth = blob_scene_views(**scene)
            _PREFETCHED[_scene_key(scene)] = (pool.map_async(render_blob_view, views), truth)
        yield
    finally:
        _PREFETCHED.clear()
        pool.terminate()
        pool.join()


def ring_scene(images: int, blobs: int, arc: float, focal: float = INC_FOCAL,
               radius: float = INC_RADIUS) -> dict:
    """render_pool's keywords for the blob scene's ring of images x 1024^2
    views."""
    return dict(image_size=(SLICE_IMAGE, SLICE_IMAGE), num_images=images, num_blobs=blobs,
                focal=focal, arc_fraction=arc, radius=radius, seed=1)


def render_ring(images: int, blobs: int, arc: float, focal: float = INC_FOCAL,
                radius: float = INC_RADIUS):
    """render_blob_scene's ring of images x 1024^2 views (render_pool)."""
    return render_pool(**ring_scene(images, blobs, arc, focal, radius))


def run_incremental(device, images: int, blobs: int, arc: float, focal: float = INC_FOCAL,
                    radius: float = INC_RADIUS):
    """A ring of images x 1024^2 rendered views of the blob scene through
    sfm_tpu_torch.reconstruct with the default config; returns
    (reconstruction, launch counts of that call, BA log, wall seconds,
    ground-truth scene)."""
    t0 = time.perf_counter()
    imgs, scene = render_ring(images, blobs, arc, focal, radius)
    log(f"[incremental] rendered {images} x {SLICE_IMAGE}^2 images with {blobs} blobs "
        f"(ring arc {arc}, focal {focal}, radius {radius}) in {time.perf_counter() - t0:.2f}s")
    rec, launches, ba_log, _, wall = run_reconstruct(device, imgs)
    return rec, launches, ba_log, wall, scene


def camera_rmse(rec, scene) -> float:
    """RMSE of the registered camera centres against the ground truth after
    the least-squares Sim(3) alignment (gauge freedom)."""
    import numpy as np
    import torch

    from sfm_tpu_torch.geometry.rotations import so3_exp
    from sfm_tpu_torch.geometry.similarity import umeyama_np

    reg = np.where(rec.registered)[0]

    def centres(rv, tv):
        R = so3_exp(torch.from_numpy(np.asarray(rv[reg], np.float32))).numpy()
        return -np.einsum("kji,kj->ki", R, np.asarray(tv[reg], np.float64))

    est, gt = centres(rec.rvecs, rec.tvecs), centres(scene.rvecs, scene.tvecs)
    s, R, t = umeyama_np(est, gt)
    return float(np.sqrt((((s * est @ R.T + t) - gt) ** 2).sum(-1).mean()))


def check_incremental(rec, launches, ba_log, scene):
    """The bars of tests/integration/test_incremental.py (all but a few
    images registered, camera RMSE < 1% of the orbit radius) at < 1 px, with
    the final global BA on the PCG branch and all seven kernels launched."""
    s = rec.summary()
    n = len(rec.registered)
    if s["num_registered"] < 0.95 * n:
        raise AssertionError(f"incremental: {s['num_registered']}/{n} images registered")
    if not s["mean_reproj_error_px"] < 1.0:
        raise AssertionError(f"incremental: mean reprojection error {s['mean_reproj_error_px']} px")
    rmse = camera_rmse(rec, scene)
    if not rmse < 0.01 * INC_RADIUS:
        raise AssertionError(f"incremental: camera RMSE {rmse} >= 1% of the orbit radius")
    if not ba_log or ba_log[-1]["solver"] != "pcg":
        raise AssertionError(f"incremental: the final global BA did not take PCG: {ba_log[-1:]}")
    missing = [k for k in ENGINE_KERNELS if launches.get(k, 0) == 0]
    if missing or launches.get("schur_coupling_matvec", 0):
        raise AssertionError(f"incremental: kernels never launched by the main path: {missing}; "
                             f"coupling-only K11 launches {launches.get('schur_coupling_matvec', 0)}")
    return rmse


# ---- phase 6: divide-and-conquer from images --------------------------------


@contextlib.contextmanager
def record_merges():
    """Record the number of cluster reconstructions handed to each merge of
    the divide-and-conquer pipeline, by wrapping merge_reconstructions for
    the duration."""
    from sfm_tpu_torch.pipeline import merge

    sizes, inner = [], merge.merge_reconstructions

    def wrapped(recs, cfg):
        sizes.append(len(recs))
        return inner(recs, cfg)

    merge.merge_reconstructions = wrapped
    try:
        yield sizes
    finally:
        merge.merge_reconstructions = inner


def run_reconstruct(device, imgs, **overrides):
    """sfm_tpu_torch.reconstruct on rendered views with the default config
    plus overrides; returns (reconstruction, launch counts of that call, BA
    log, sizes of the cluster merges, wall seconds)."""
    from sfm_tpu_torch import kernels, reconstruct

    with record_bundle_adjustments() as ba_log, record_merges() as merges:
        kernels.reset_launches()
        t0 = time.perf_counter()
        rec = reconstruct(list(imgs), device=device, **overrides)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    return rec, launches, ba_log, merges, wall


def log_bundle_adjustments(what: str, ba_log) -> None:
    for i, b in enumerate(ba_log):
        log(f"[{what}] BA {i}: C={b['C']} O={b['O']} C*O={b['C'] * b['O']} {b['solver']} "
            f"{b['iterations']} LM iterations {b['seconds']:.3f}s, cost {b['initial_cost']:.4f} -> "
            f"{b['final_cost']:.4f}")


def check_partition(rec, launches, ba_log, merges, scene):
    """The incremental slice's bars with the camera RMSE bar at 3% of the
    orbit radius (on this half ring of short tracks the default pose-graph
    straightening bends the merged model and the polish recovers most, not
    all, of it: PERF.md), at least two clusters merged, the merged polish
    (the last BA) on the PCG branch, and the seven kernels of the engine's
    path launched."""
    s = rec.summary()
    n = len(rec.registered)
    if s["num_registered"] < 0.95 * n:
        raise AssertionError(f"partition: {s['num_registered']}/{n} images registered")
    if not s["mean_reproj_error_px"] < 1.0:
        raise AssertionError(f"partition: mean reprojection error {s['mean_reproj_error_px']} px")
    rmse = camera_rmse(rec, scene)
    if not rmse < 0.03 * INC_RADIUS:
        raise AssertionError(f"partition: camera RMSE {rmse} >= 3% of the orbit radius")
    if not merges or max(merges) < 2:
        raise AssertionError(f"partition: no merge of two or more clusters: {merges}")
    if not ba_log or ba_log[-1]["solver"] != "pcg" or ba_log[-1]["C"] < 0.95 * n:
        raise AssertionError(f"partition: the merged polish did not take PCG: {ba_log[-1:]}")
    missing = [k for k in ENGINE_KERNELS if launches.get(k, 0) == 0]
    if missing or launches.get("schur_coupling_matvec", 0):
        raise AssertionError(f"partition: kernels never launched by the main path: {missing}; "
                             f"coupling-only K11 launches {launches.get('schur_coupling_matvec', 0)}")
    return rmse


# ---- phase 7: the merged-model polish at full width -------------------------


def run_polish(device):
    """A synthetic merged model of POLISH_CAMERAS cameras through the
    pipeline's own _merged_polish (BA -> filter -> BA) with the default
    config; returns what check_polish and the kernel checks need: the model
    and its ground truth, (mean reprojection px, camera RMSE) before and
    after, the observation count, the BA log (each solve's problem and
    config), the launch counts and the wall seconds of the polish; and a
    copy of the model as it was built (`model`, phase 13's input)."""
    import copy

    from sfm_tpu_torch import kernels
    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.pipeline.partition import _merged_polish

    t0 = time.perf_counter()
    rec, truth = arc_ring_reconstruction(POLISH_CAMERAS, POLISH_POINTS, POLISH_TRACKS, seed=3,
                                         centre_noise=POLISH_CENTRE_NOISE)
    n_obs = rec.num_observations
    tl = rec.track_lengths()
    before = (rec.mean_reprojection_error(), camera_rmse(rec, truth))
    model = copy.deepcopy(rec)
    log(f"[polish] merged model built in {time.perf_counter() - t0:.2f}s: C={POLISH_CAMERAS} "
        f"P={POLISH_POINTS} O={n_obs}, tracks of {int(tl.min())}-{int(tl.max())} views, "
        f"{len(truth.outlier_rows)} gross outliers; before: {before[0]:.4f} px, camera RMSE "
        f"{before[1]:.5f} ({100 * before[1] / truth.radius:.4f}% of the radius {truth.radius:.1f})")
    with record_bundle_adjustments() as ba_log:
        kernels.reset_launches()
        t0 = time.perf_counter()
        _merged_polish(rec, PipelineConfig(verbose=False), device)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    after = (rec.mean_reprojection_error(), camera_rmse(rec, truth))
    log_bundle_adjustments("polish", ba_log)
    log(f"[polish] BA -> filter -> BA wall {wall:.2f}s; after: {after[0]:.4f} px, camera RMSE "
        f"{after[1]:.5f} ({100 * after[1] / truth.radius:.4f}% of the radius); "
        f"{n_obs - rec.num_observations} observations dropped")
    log(f"[polish] launches {json.dumps(launches)}")
    return dict(rec=rec, truth=truth, before=before, after=after, n_obs=n_obs, ba_log=ba_log,
                launches=launches, wall=wall, model=model)


def check_polish(r):
    """The large-camera-count kernel set with every CG solve in one
    pcg_solve_big launch (and K9) launched, and nothing else: not the
    coupling-only K10 entry, not the small-C kernels; O in 1.4-1.6 M; every
    solve's cost fell; < 1.0 px after the polish; the camera RMSE fell and
    ends under 1% of the radius; at least 95% of the gross outliers dropped
    and under 1% of the other rows."""
    import numpy as np

    rec, truth, launches = r["rec"], r["truth"], r["launches"]
    missing = [k for k in POLISH_KERNELS if launches.get(k, 0) == 0]
    stray = [k for k in KERNELS if k not in POLISH_KERNELS and launches.get(k, 0) != 0]
    if missing or stray:
        raise AssertionError(f"polish: never launched {missing}, launched but not of this path {stray}")
    if not 1.4e6 <= r["n_obs"] <= 1.6e6:
        raise AssertionError(f"polish: {r['n_obs']} observations, expected 1.4-1.6 M")
    for b in r["ba_log"]:
        if b["C"] <= 4096 or b["solver"] != "pcg" or not b["final_cost"] < b["initial_cost"]:
            raise AssertionError(f"polish: BA C={b['C']} {b['solver']} cost {b['initial_cost']} -> "
                                 f"{b['final_cost']}")
    if not r["after"][0] < 1.0:
        raise AssertionError(f"polish: mean reprojection error {r['after'][0]} px")
    if not (r["after"][1] < r["before"][1] and r["after"][1] < 0.01 * truth.radius):
        raise AssertionError(f"polish: camera RMSE {r['before'][1]} -> {r['after'][1]}")
    kept = np.zeros(r["n_obs"], bool)
    kept[rec.obs_kp] = True
    out = np.zeros(r["n_obs"], bool)
    out[truth.outlier_rows] = True
    dropped_out, dropped_in = float((~kept[out]).mean()), float((~kept[~out]).mean())
    if dropped_out < 0.95 or dropped_in > 0.01:
        raise AssertionError(f"polish: dropped {dropped_out:.3f} of the gross outliers and "
                             f"{dropped_in:.4f} of the other observations")
    return dropped_out, dropped_in


# ---- phase 8: the global engine ---------------------------------------------


def check_global(rec, launches, scene, radius: float):
    """The bars of tests/integration/test_global_engine.py as far as they
    apply to rendered views of a short arc: every image registered; < 1.0 px
    (that file's 0.6 px belongs to its 0.3 px synthetic keypoint noise);
    camera-centre RMSE after Sim(3) < 3% of the orbit radius (that file's 1%
    is for a closed ring; on an open arc the averaged translations are weakly
    determined: PERF.md); the kernels of the path launched."""
    s = rec.summary()
    if s["num_registered"] != len(rec.registered):
        raise AssertionError(f"global: {s['num_registered']}/{len(rec.registered)} images registered")
    if not s["mean_reproj_error_px"] < 1.0:
        raise AssertionError(f"global: mean reprojection error {s['mean_reproj_error_px']} px")
    rmse = camera_rmse(rec, scene)
    if not rmse < 0.03 * radius:
        raise AssertionError(f"global: camera RMSE {rmse} >= 3% of the orbit radius")
    missing = [k for k in TWO_VIEW_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"global: kernels never launched by the main path: {missing}")
    return rmse


# ---- phase 9: config #3 from image files through the CLI --------------------

VOCAB_IMAGES = 128   # South Building's image count (BASELINE.json config #3)
VOCAB_ARC = 0.64     # 1.8 degrees between views: the incremental ring's spacing
# Phase 9's depth in chip_smoke.py: 96 views at the same spacing (its final
# global BA still takes PCG), cut from 128 when phase 14 joined.
VOCAB_SMOKE_IMAGES = 96


def write_pgm_views(imgs, directory: str) -> str:
    """Each view as an 8-bit binary PGM (P5): the format the port decodes
    without OpenCV. Returns the directory."""
    import os

    import numpy as np

    os.makedirs(directory, exist_ok=True)
    for i, img in enumerate(imgs):
        h, w = img.shape
        with open(os.path.join(directory, f"view_{i:04d}.pgm"), "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (w, h))
            f.write(np.round(np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes())
    return directory


@contextlib.contextmanager
def record_vocab_run():
    """Record what the path-input pipeline did, by wrapping its entry points
    for the duration: the vocab tree's build seconds and the retrieval's
    (build, quantize and score), the candidate pairs, the verified edges
    before and after densify, the ladder candidates, the seconds spent
    saving each stage's artifact (inside the stage times), the match
    stage's features, candidate pairs and intrinsics (as densify got
    them), and the Reconstruction run_pipeline returned."""
    import torch

    from sfm_tpu_torch.ops import vocab
    from sfm_tpu_torch.pipeline import run, stages
    from sfm_tpu_torch.scene.artifacts import ArtifactStore

    rec = {"artifact_save_s": {}}
    inner = dict(build=vocab.build_vocab_tree, pairs=vocab.vocab_tree_pairs, densify=stages.densify_graph,
                 cand=stages.densify_candidate_pairs, run=run.run_pipeline, save=ArtifactStore.save)

    def timed(key, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        rec[key] = time.perf_counter() - t0
        return out

    def pairs(*a, **k):
        out = timed("vocab_s", inner["pairs"], *a, **k)
        rec["candidate_pairs"] = len(out)
        return out

    def densify(feats, graph, intrinsics, *a, **k):
        rec["verified_before_densify"] = int(graph.ok.sum())
        rec["match_inputs"] = (feats, graph.pairs, intrinsics)
        out = inner["densify"](feats, graph, intrinsics, *a, **k)
        rec["ladder_pairs_added"] = len(out.pairs) - len(graph.pairs)
        rec["verified_edges"] = int(out.ok.sum())
        return out

    def cand(*a, **k):
        out = inner["cand"](*a, **k)
        rec["ladder_candidates"] = len(out)
        return out

    def run_pipeline(*a, **k):
        rec["rec"] = inner["run"](*a, **k)
        return rec["rec"]

    def save(store, stage, key, arrays):
        t0 = time.perf_counter()
        inner["save"](store, stage, key, arrays)
        saved = rec["artifact_save_s"]
        saved[stage] = saved.get(stage, 0.0) + time.perf_counter() - t0

    vocab.build_vocab_tree = lambda *a, **k: timed("build_s", inner["build"], *a, **k)
    vocab.vocab_tree_pairs, stages.densify_graph, stages.densify_candidate_pairs = pairs, densify, cand
    run.run_pipeline, ArtifactStore.save = run_pipeline, save
    try:
        yield rec
    finally:
        vocab.build_vocab_tree, vocab.vocab_tree_pairs = inner["build"], inner["pairs"]
        stages.densify_graph, stages.densify_candidate_pairs = inner["densify"], inner["cand"]
        run.run_pipeline, ArtifactStore.save = inner["run"], inner["save"]


def output_files(out: str) -> dict:
    """The bytes of the COLMAP model (sparse/) and the PLY a reconstruct wrote."""
    import os

    sparse = os.path.join(out, "sparse")
    paths = [os.path.join(sparse, n) for n in sorted(os.listdir(sparse))] + [os.path.join(out, "cloud.ply")]
    files = {}
    for path in paths:
        with open(path, "rb") as f:
            files[os.path.relpath(path, out)] = f.read()
    return files


def run_vocab(workdir: str, images: int = VOCAB_IMAGES, extra: tuple = ()):
    """`images` rendered views of the incremental ring's scene at its
    spacing, written as PGM files and reconstructed through
    sfm_tpu_torch.cli.main(["reconstruct", DIR, "--out", OUT, *extra,
    'pair_mode="vocab_tree"']) in this process (so that launches
    count): streaming decode, K1, the vocab tree, K2 on the vocab pairs,
    densify, the incremental engine, COLMAP text + bin + PLY. Returns the
    run's record."""
    import os

    from sfm_tpu_torch import cli, kernels

    t0 = time.perf_counter()
    imgs, scene = render_ring(images, INC_BLOBS, VOCAB_ARC * images / VOCAB_IMAGES)
    image_dir = write_pgm_views(imgs, os.path.join(workdir, "images"))
    log(f"[vocab] rendered {images} x {imgs.shape[1]}x{imgs.shape[2]} views and wrote them as PGM files "
        f"in {time.perf_counter() - t0:.2f}s")
    del imgs
    argv = ["reconstruct", image_dir, "--out", os.path.join(workdir, "out"), *extra, 'pair_mode="vocab_tree"']
    with record_bundle_adjustments() as ba_log, record_vocab_run() as record:
        kernels.reset_launches()
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError(f"vocab: cli.main({argv}) failed")
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    return dict(record, launches=launches, ba_log=ba_log, wall=wall, scene=scene, argv=argv,
                out=argv[3], images=images)


def check_colmap_round_trip(rec, out: str, what: str = "vocab"):
    """read_colmap_bin(out/sparse) holds the Reconstruction's cameras, its
    registered images (pose, name, observations) and its valid points."""
    import os

    import numpy as np

    from sfm_tpu_torch.scene.export import _quat, read_colmap_bin

    cams, images, points = read_colmap_bin(os.path.join(out, "sparse"))
    if sorted(cams) != list(range(1, len(rec.intrinsics) + 1)):
        raise AssertionError(f"{what}: {len(cams)} cameras read back, {len(rec.intrinsics)} written")
    for i, c in cams.items():
        if not np.array_equal(np.asarray(c["params"]), rec.intrinsics[i - 1, :len(c["params"])].astype(np.float64)) \
                or (c["width"], c["height"]) != tuple(int(v) for v in rec.image_sizes[i - 1]):
            raise AssertionError(f"{what}: camera {i} read back differs")
    reg = np.where(rec.registered)[0]
    if sorted(images) != list(reg + 1):
        raise AssertionError(f"{what}: the images read back are not the registered ones")
    for i in reg:
        im, rows = images[i + 1], rec.obs_image == i
        if not (im["name"] == rec.image_names[i] and np.array_equal(im["tvec"], rec.tvecs[i].astype(np.float64))
                and np.array_equal(im["qvec"], _quat(rec.rvecs[i]).astype(np.float64))
                and np.array_equal(im["xys"], rec.obs_uv[rows].astype(np.float64))
                and np.array_equal(im["point3D_ids"], rec.obs_point[rows] + 1)):
            raise AssertionError(f"{what}: image {i} read back differs")
    valid = np.where(rec.point_valid)[0]
    if sorted(points) != list(valid + 1):
        raise AssertionError(f"{what}: the points read back are not the valid ones")
    xyz = np.stack([points[p + 1]["xyz"] for p in valid])
    if not np.array_equal(xyz, rec.points[valid].astype(np.float64)):
        raise AssertionError(f"{what}: point positions read back differ")
    return len(cams), len(images), len(points)


def check_vocab(run):
    """The incremental ring's bars on config #3 from files: >= 95% of the
    views registered, < 1.0 px, camera RMSE < 1% of the radius, fewer
    candidate pairs than exhaustive matching, the final global BA on the PCG
    branch and the engine's kernels launched; the COLMAP model read back."""
    rec = run["rec"]
    s = rec.summary()
    n = len(rec.registered)
    if s["num_registered"] < 0.95 * n:
        raise AssertionError(f"vocab: {s['num_registered']}/{n} images registered")
    if not s["mean_reproj_error_px"] < 1.0:
        raise AssertionError(f"vocab: mean reprojection error {s['mean_reproj_error_px']} px")
    rmse = camera_rmse(rec, run["scene"])
    if not rmse < 0.01 * INC_RADIUS:
        raise AssertionError(f"vocab: camera RMSE {rmse} >= 1% of the orbit radius")
    if not 0 < run["candidate_pairs"] < n * (n - 1) // 2:
        raise AssertionError(f"vocab: {run['candidate_pairs']} candidate pairs of {n * (n - 1) // 2}")
    ba_log, launches = run["ba_log"], run["launches"]
    if not ba_log or ba_log[-1]["solver"] != "pcg":
        raise AssertionError(f"vocab: the final global BA did not take PCG: {ba_log[-1:]}")
    missing = [k for k in ENGINE_KERNELS if launches.get(k, 0) == 0]
    if missing or launches.get("schur_coupling_matvec", 0):
        raise AssertionError(f"vocab: kernels never launched by the path: {missing}; "
                             f"coupling-only K11 launches {launches.get('schur_coupling_matvec', 0)}")
    return rmse, check_colmap_round_trip(rec, run["out"])


def rerun_vocab(run) -> float:
    """The same command on the same --out: the features, matches and
    reconstruction artifacts load (the streamed feature stage, the match
    stage and the incremental engine raise if called) and the COLMAP model
    and the PLY come out byte-identical. Returns the wall seconds."""
    from sfm_tpu_torch import cli
    from sfm_tpu_torch.pipeline import engine, stages

    first = output_files(run["out"])
    names = ((stages, "extract_stage_streaming"), (stages, "match_and_verify_stage"),
             (engine, "incremental_reconstruct"))
    saved = [getattr(m, n) for m, n in names]

    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"vocab resume: {name} ran despite its completed artifact")
        return fn

    for m, n in names:
        setattr(m, n, refuse(n))
    try:
        t0 = time.perf_counter()
        if cli.main(run["argv"]) != 0:
            raise AssertionError("vocab resume: cli.main failed")
        wall = time.perf_counter() - t0
    finally:
        for (m, n), fn in zip(names, saved):
            setattr(m, n, fn)
    again = output_files(run["out"])
    if again.keys() != first.keys() or any(again[k] != first[k] for k in first):
        raise AssertionError("vocab resume: the written model differs from the first run's: " +
                             str([k for k in first if again.get(k) != first[k]]))
    return wall


def vocab_idle(device, out: str) -> dict:
    """Device ms, launches, wall ms and idle share (chip_smoke.traced) of the
    path's two new device parts, on the run's own features from its
    artifacts: the vocab retrieval (tree build, quantize, score) and the
    match stage on one block of its candidate pairs."""
    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.ops.vocab import vocab_tree_pairs
    from sfm_tpu_torch.pipeline import stages
    from sfm_tpu_torch.scene.artifacts import ArtifactStore

    store = ArtifactStore(out)
    feats, intrinsics = store.load_features(), store.load("meta")["intrinsics"]
    cfg = PipelineConfig()
    pairs = vocab_tree_pairs(feats, cfg.vocab, device)
    block = pairs[:cfg.match.block_pairs]
    parts = {}
    for name, fn in (("vocab_tree_pairs", lambda: vocab_tree_pairs(feats, cfg.vocab, device)),
                     (f"match_and_verify {len(block)} pairs",
                      lambda: stages.match_and_verify_stage(feats, block, intrinsics, cfg, device))):
        rows, wall_ms, _ = traced(fn, sessions=1)
        launches, busy_ms, _ = per_call(rows, 1)
        parts[name] = dict(device_ms=busy_ms, launches=launches, wall_ms=wall_ms,
                           idle_share=1.0 - busy_ms / wall_ms)
    return parts


# ---- phase 10: the off-by-default paths at full width ------------------------

OPTIONS = {"sift.upsample_first_octave": True, "match.guided": True, "ransac.model": "fundamental"}


def run_options(device, size: int = SLICE_IMAGE):
    """The two-view slice's views through reconstruct with first-octave
    upsampling, guided matching and F-RANSAC: the two-view bars, then K1 on
    every stack the feature stage handed it (the 2 x size upsampled octave
    among them), bit-exact and timed, and once more, untimed, on the
    upsampled octave of two uniform-noise images (the rendered views'
    upsampled octave holds few or no extrema; noise is dense in them)."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops.detect import pre_threshold
    from sfm_tpu_torch.ops.pyramid import build_pyramid

    with record_dog_stacks() as stacks:
        rec, launches, _, wall, scene = run_slice(device, size, SLICE_BLOBS, **OPTIONS)
    check_slice(rec, launches, scene)
    if not any(k[2] == 2 * size for k in stacks):
        raise AssertionError(f"options: no upsampled octave handed to K1: {sorted(stacks)}")
    rows = check_dog_path(device, stacks)
    del stacks
    cfg = SiftConfig(num_octaves=1, image_max_dim=size, upsample_first_octave=True)
    img = np.random.default_rng(1).uniform(0, 1, (2, size, size)).astype(np.float32)
    gauss = build_pyramid(torch.from_numpy(img).to(device), cfg)[0].contiguous()
    noise = check_dog_shape(device, gauss, pre_threshold(cfg), "noise " + "x".join(map(str, gauss.shape)),
                            timed=False)
    if noise["extrema"] == 0:
        raise AssertionError("options: no extremum in the upsampled noise octave")
    return rec, launches, wall, scene, rows, noise


# ---- phase 11: intrinsics refinement at full width -------------------------


@contextlib.contextmanager
def forbid_plain():
    """Record every call of a kernel's plain version (the *_plain functions
    of every kernel module: K1's, K2's, K12's, K13's, K14's, K15's and the BA
    kernels') that is handed a CUDA tensor, by wrapping them for the
    duration: on the card every wrapper launches its kernel, so the list
    must stay empty."""
    import torch

    from sfm_tpu_torch.kernels import (ba_kernels, blur_levels, dog_extrema, match_topk, select_candidates,
                                       sift_descriptors, subpixel_refine)

    calls, saved = [], [(m, n, getattr(m, n))
                        for m in (ba_kernels, blur_levels, dog_extrema, match_topk, select_candidates,
                                  sift_descriptors, subpixel_refine)
                        for n in dir(m) if n.endswith("_plain")]

    def guard(name, fn):
        def wrapped(*args, **kwargs):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in (*args, *kwargs.values())):
                calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    for module, name, fn in saved:
        setattr(module, name, guard(name, fn))
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def refine_config(cfg, focal: bool = True, distortion: bool = True):
    import dataclasses

    return dataclasses.replace(cfg, refine_focal=focal, refine_distortion=distortion)


def check_column_freeze(prob, cfg, device) -> str:
    """K5's 8-wide build with the first LM iteration's step under each
    freeze setting (focal and k1 refined, either frozen, both): candidate
    cameras, points and cost against the plain version in float64 at
    check_ba's bars (1e-5 of max |value|, the cost rel 1e-5), the frozen
    columns bit-identical to the given cameras, and the candidate points
    bit-identical across the settings (the back-substitution reads the
    whole step, as sfm_tpu's does). Returns the errors as a note."""
    import torch

    from sfm_tpu_torch.kernels import ba_kernels as kb

    inv, ne = first_iteration_inputs(prob, cfg)
    step = lm_step(prob, cfg, inv, ne)
    cams = prob.cam_params.contiguous()

    def args(dt=lambda t: t):
        z = None if inv.z_floor is None else dt(inv.z_floor)
        return (prob.obs_cam, prob.obs_point, dt(prob.points), dt(inv.static_t), dt(cams),
                dt(prob.intrinsics), inv.point_bounds, z, cfg.robust_loss, cfg.robust_scale_px)

    points, notes = None, []
    for focal, dist in ((False, False), (True, False), (False, True), (True, True)):
        s = step._replace(freeze_focal=focal, freeze_distortion=dist)
        out = kb.fused_cost_sums(*args(), step=s, plan=inv.pcg_plan)
        ref = kb.fused_cost_sums_plain(*args(lambda t: t.double()),
                                       step=kb.LMStep(*(t.double() for t in s[:4]), *s[4:]))
        errs = {k: float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for k, a, b in zip(("cams", "points"), out[:2], ref[:2])}
        errs["cost"] = abs(float(out[2][2]) / float(ref[2][2]) - 1.0)
        tag = f"focal {'frozen' if focal else 'refined'}, k1 {'frozen' if dist else 'refined'}"
        if not (errs["cams"] <= 1e-5 and errs["points"] <= 1e-5 and errs["cost"] <= 1e-5):
            raise AssertionError(f"fused_cost_sums_w8 ({tag}): errors {errs}")
        for col, frozen in ((6, focal), (7, dist)):
            if frozen and not torch.equal(out[0][:, col], cams[:, col]):
                raise AssertionError(f"fused_cost_sums_w8 ({tag}): column {col} moved")
        if points is None:
            points = out[1]
        elif not torch.equal(points, out[1]):
            raise AssertionError(f"fused_cost_sums_w8 ({tag}): the freeze setting moved the points")
        notes.append(f"{tag}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    moved = float((step.dc[:, 6:8].abs().max()))
    return ("freeze settings (points bit-identical across them; max |dc| of columns 6-7 "
            f"{moved:.3e}): " + "; ".join(notes))


def check_refined_kernels(rec, cfg, device) -> tuple[dict, list]:
    """Phase 11 (a): build_problem(rec, refine_intrinsics=True) of phase 5's
    reconstruction (the final global BA's problem, 8 wide: C = 128, O =
    65,536 padded, the PCG branch), focal and k1 refined: the 8-wide K3
    (without and with the Schur-Jacobi blocks), K5 (cost, step, each freeze
    setting), K7 and K11 standalone and pcg_solve against their plain
    versions at the bars check_ba / check_schur / check_pcg hold the 6-wide
    builds to, and K9 at the 8-wide rows (WIDE_K9_SIDES); each timed.
    Returns (rows by kernel, K9 rows)."""
    from sfm_tpu_torch.ba import build_problem, core

    prob, _, _ = build_problem(rec, refine_intrinsics=True, device=device)
    cfg = refine_config(cfg)
    if prob.cam_params.shape[-1] != 8 or core.uses_dense_solver(prob, cfg):
        raise AssertionError(f"refined problem: width {prob.cam_params.shape[-1]}, "
                             f"C={prob.num_cameras} O={prob.obs_w.shape[0]} not on the PCG branch")
    results = {**check_ba(prob, cfg, device, "refined global BA"), **check_schur(prob, cfg, device)}
    results["fused_cost_sums_w8"]["note"] += "; " + check_column_freeze(prob, cfg, device)
    results["pcg_solve_w8"] = check_pcg(prob, cfg, device, "refined global BA")
    inv = core.solve_invariants(prob, core.near_plane_floor(prob))
    k9 = check_segment_sum(inv, prob.obs_w.shape[0], prob.num_cameras, prob.num_points, device,
                           WIDE_K9_SIDES)
    return results, k9


def run_refined_ba(rec, cfg, device, focal: float, recover: bool) -> dict:
    """Phase 11 (b): rec's global BA problem built 8-wide with every focal
    at REFINED_BA_FOCAL of the rendered `focal` and k1 = 0, through
    bundle_adjust with focal and k1 refined (the PCG branch), the launch
    counts set to 0 just before and read just after, no plain version on a
    CUDA tensor. Bars: < 1 px afterwards, the 8-wide K3, K5 and pcg_solve
    launched; with `recover` also the non-gauge cameras' focal within
    REFINED_FOCAL_BAR of `focal` and |k1| < 0.01 (the bars of
    tests/unit/test_ba.py's refinement test). Also times the same BA 6 wide
    and 8 wide at the rendered focal (seconds and LM iterations of each)."""
    import copy

    import numpy as np
    import torch

    from sfm_tpu_torch import kernels
    from sfm_tpu_torch.ba import build_problem, core, writeback

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def solve(r, wide, bcfg):
        prob, cams, pids = build_problem(r, refine_intrinsics=wide, device=device)
        sync()
        t0 = time.perf_counter()
        out, stats = core.bundle_adjust(prob, bcfg)
        sync()
        return prob, out, stats, cams, pids, time.perf_counter() - t0

    timing = {}
    for wide in (False, True):
        prob, _, stats, _, _, sec = solve(rec, wide, refine_config(cfg, wide, wide))
        timing[f"width_{prob.cam_params.shape[-1]}"] = dict(
            seconds=sec, lm_iterations=int(stats.iterations), final_cost=float(stats.final_cost))
    bad = copy.deepcopy(rec)
    bad.intrinsics[:, :2] = REFINED_BA_FOCAL * focal
    bad.intrinsics[:, 4] = 0.0
    before = bad.mean_reprojection_error()
    with forbid_plain() as plain:
        kernels.reset_launches()
        prob, out, stats, cams, pids, sec = solve(bad, True, refine_config(cfg))
        launches = dict(kernels.LAUNCHES)
    writeback(bad, out, cams, pids)
    f, k1 = bad.intrinsics[cams[1:], 0], bad.intrinsics[cams[1:], 4]
    r = dict(before_px=before, after_px=bad.mean_reprojection_error(), seconds=sec,
             lm_iterations=int(stats.iterations), C=prob.num_cameras, O=int(prob.obs_w.shape[0]),
             solver="dense" if core.uses_dense_solver(prob, cfg) else "pcg", rendered_focal=focal,
             focal_mean=float(f.mean()), focal_worst_rel=float(np.abs(f / focal - 1).max()),
             k1_worst=float(np.abs(k1).max()), launches=launches, plain_calls=plain, timing=timing)
    recovered = r["focal_worst_rel"] < REFINED_FOCAL_BAR and r["k1_worst"] < 0.01
    if not (r["after_px"] < 1.0 and (recovered or not recover)):
        raise AssertionError(f"refined BA: {r}")
    missing = [k for k in REFINED_PCG_KERNELS if launches.get(k, 0) == 0]
    if r["solver"] != "pcg" or missing or plain:
        raise AssertionError(f"refined BA: solver {r['solver']}, never launched {missing}, "
                             f"plain versions on the card {sorted(set(plain))}")
    return r


def run_refined_reconstruct(device, offset: float = REFINED_FOCAL_OFFSET,
                            overrides=REFINED_OVERRIDES) -> dict:
    """Phase 11 (c): REFINED_IMAGES views of phase 5's blobs at its radius,
    arc REFINED_ARC, rendered at (1 + offset) x INC_FOCAL, through
    reconstruct with REFINED_OVERRIDES (focal and k1 refined in the global
    BAs), no plain version on a CUDA tensor."""
    t0 = time.perf_counter()
    focal = (1.0 + offset) * INC_FOCAL
    imgs, scene = render_ring(REFINED_IMAGES, INC_BLOBS, REFINED_ARC, focal)
    render_s = time.perf_counter() - t0
    with forbid_plain() as plain:
        rec, launches, ba_log, _, wall = run_reconstruct(device, imgs, **overrides)
    return dict(rec=rec, launches=launches, ba_log=ba_log, wall=wall, scene=scene, focal=focal,
                offset=offset, plain_calls=plain, render_s=render_s, imgs=imgs)


def check_refined_reconstruct(run) -> dict:
    """Phase 11 (c)'s bars: >= 95% of the views registered, < 1 px, camera
    RMSE < REFINED_RMSE_BAR of the radius (the divide-and-conquer and
    global-engine phases' bar), the mean refined focal of the registered
    views nearer the rendered one than the prior; the global BAs 8 wide
    through the 8-wide K3 and K5 (the first registered view, the gauge,
    keeps the prior), the local BAs 6 wide, no plain version on the card."""
    import numpy as np

    rec, launches, ba_log = run["rec"], run["launches"], run["ba_log"]
    s = rec.summary()
    reg = np.where(rec.registered)[0]
    widths = [b["width"] for b in ba_log]
    r = dict(offset=run["offset"], rendered_focal=run["focal"], prior_focal=INC_FOCAL,
             registered=int(s["num_registered"]), views=len(rec.registered),
             mean_reproj_px=s["mean_reproj_error_px"], camera_rmse=camera_rmse(rec, run["scene"]),
             focal_mean=float(rec.intrinsics[reg, 0].mean()),
             focal_mean_non_gauge=float(rec.intrinsics[reg[1:], 0].mean()),
             k1_worst=float(np.abs(rec.intrinsics[reg, 4]).max()),
             bas_8_wide=widths.count(8), bas_6_wide=widths.count(6), wall=run["wall"],
             stage_s=rec.stage_seconds, plain_calls=sorted(set(run["plain_calls"])))
    r["camera_rmse_pct_radius"] = 100 * r["camera_rmse"] / INC_RADIUS
    r["focal_rel"] = r["focal_mean"] / run["focal"] - 1.0
    bad = []
    if r["registered"] < 0.95 * r["views"]:
        bad.append("registered")
    if not r["mean_reproj_px"] < 1.0:
        bad.append("reprojection")
    if not r["camera_rmse"] < REFINED_RMSE_BAR * INC_RADIUS:
        bad.append("camera RMSE")
    if not abs(r["focal_rel"]) < abs(INC_FOCAL / run["focal"] - 1.0):
        bad.append("focal")
    if not (widths and widths[-1] == 8 and r["bas_6_wide"] > 0):
        bad.append("BA widths")
    if any(launches.get(k, 0) == 0 for k in ("fused_ne_payloads_w8", "fused_cost_sums_w8",
                                              "fused_ne_payloads", "fused_cost_sums")):
        bad.append("launches")
    if run["plain_calls"]:
        bad.append("plain versions on the card")
    r["failed"] = bad
    return r


# ---- phase 13: the refined polish (8-wide, past 4,096 cameras) -----------------


def inlier_reprojection_px(rec, truth) -> float:
    """Mean reprojection error of the observations that are not gross
    outliers (truth.outlier_rows: obs_kp holds each row's number)."""
    import numpy as np

    err = rec.reprojection_errors()
    return float(err[~np.isin(rec.obs_kp, truth.outlier_rows)].mean())


def run_refined_polish(model, truth, device) -> dict:
    """Phase 13 (a): phase 8's merged model as it was built (10,240 cameras,
    ~1.5 M observations), every focal at REFINED_BA_FOCAL of the rendered
    400 and k1 0, through the engine's global BA with ba.refine_focal and
    ba.refine_distortion (pipeline/engine.py _run_ba's three calls:
    build_problem with refine_intrinsics, dispatch_bundle_adjust, writeback)
    at the default BA config; the launch counts set to 0 just before and
    read just after, every plain version handed a CUDA tensor recorded
    (forbid_plain). Returns the readings (check_refined_polish holds them
    to their bars), the problem and its BA config."""
    import copy

    import numpy as np

    from sfm_tpu_torch import kernels
    from sfm_tpu_torch.ba import build_problem, dispatch_bundle_adjust, writeback
    from sfm_tpu_torch.config import PipelineConfig, apply_overrides

    rec = copy.deepcopy(model)
    focal = float(rec.intrinsics[0, 0])
    rec.intrinsics[:, :2] *= REFINED_BA_FOCAL
    rec.intrinsics[:, 4] = 0.0
    cfg = apply_overrides(PipelineConfig(verbose=False), REFINED_OVERRIDES)
    before = dict(px=rec.mean_reprojection_error(), inlier_px=inlier_reprojection_px(rec, truth),
                  camera_rmse=camera_rmse(rec, truth))
    with forbid_plain() as plain:
        kernels.reset_launches()
        t0 = time.perf_counter()
        prob, cams, pids = build_problem(rec, refine_intrinsics=True, device=device)
        out, stats = dispatch_bundle_adjust(prob, cfg)
        writeback(rec, out, cams, pids)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    f, k1 = rec.intrinsics[cams[1:], 0], rec.intrinsics[cams, 4]
    rel = np.abs(f / focal - 1.0)
    r = dict(C=prob.num_cameras, O=int(prob.obs_w.shape[0]), width=prob.cam_params.shape[-1],
             lm_iterations=int(stats.iterations), initial_cost=float(stats.initial_cost),
             final_cost=float(stats.final_cost), wall_s=wall, before=before,
             after=dict(px=rec.mean_reprojection_error(), inlier_px=inlier_reprojection_px(rec, truth),
                        camera_rmse=camera_rmse(rec, truth)),
             radius=truth.radius, rendered_focal=focal, prior_focal=REFINED_BA_FOCAL * focal,
             focal_median_rel=float(np.median(rel)), focal_worst_rel=float(rel.max()),
             focal_mean=float(f.mean()), k1_worst=float(np.abs(k1).max()),
             launches=launches, plain_calls=sorted(set(plain)), device=device.type)
    return dict(readings=r, problem=prob, cfg=cfg.ba)


def check_refined_polish(r: dict) -> None:
    """Phase 13 (a)'s bars on run_refined_polish's readings: the 8-wide K4,
    K6, K8, K9 and pcg_solve_big launched and nothing else (no 6-wide
    `_big` entry, no small-C kernel, not the coupling-only K10 entry); no
    plain version on the card; the cost falls; the mean reprojection error
    of the observations that are not gross outliers < 1 px afterwards (no
    filter runs, and the 1% gross outliers of 60-200 px keep the mean over
    all rows above it). Reported with no bar: the focal error of the
    non-gauge cameras against the rendered focal (median, worst), max |k1|,
    the camera RMSE before and after."""
    launches = r["launches"]
    missing = [k for k in REFINED_POLISH_KERNELS if launches.get(k, 0) == 0]
    stray = [k for k in KERNELS if k not in REFINED_POLISH_KERNELS and launches.get(k, 0) != 0]
    bad = []
    if r["device"] == "cuda" and (missing or stray):
        bad.append(f"never launched {missing}, launched but not of this path {stray}")
    if r["width"] != 8 or r["C"] <= 4096:
        bad.append("not an 8-wide problem past 4,096 cameras")
    if r["plain_calls"]:
        bad.append("plain versions on the card")
    if not r["final_cost"] < r["initial_cost"]:
        bad.append("cost")
    if not r["after"]["inlier_px"] < 1.0:
        bad.append("reprojection")
    if bad:
        raise AssertionError(f"refined polish: {bad}: {r}")


# ---- phase 14: config #4 from image files through the CLI -------------------

CONFIG4_IMAGES = 1000   # BASELINE.json config #4: a 1DSfM landmark scene of ~1-2k views
CONFIG4_SIZE = 256
CONFIG4_RADIUS = 4.0
CONFIG4_REGISTERED = 0.99   # of the views (sfm_tpu's ladder row: 1000 of 1000)
CONFIG4_PX = 1.0            # mean reprojection error (sfm_tpu's row: 0.884 px)
CONFIG4_RMSE = 0.005        # camera-centre RMSE over the radius (sfm_tpu's row: 0.315%)
CONFIG4_CLUSTERS = 8        # clusters reconstructed, at the least
CONFIG4_STAGES = ("global_sfm", "partition.clusters", "partition.merge", "partition.polish")


def config4_scene(n: int, size: int = CONFIG4_SIZE) -> dict:
    """benchmarks/ladder.py's render_blob_scene arguments at n views of
    size^2 (its default seed, 0)."""
    return dict(image_size=(size, size), num_images=n, num_blobs=min(60 + 8 * n, 600), focal=size * 1.2,
                arc_fraction=min(0.02 * n, 1.0), radius=CONFIG4_RADIUS)


def config4_overrides(n: int, mode: str = "global", size: int = CONFIG4_SIZE) -> dict:
    """benchmarks/ladder.py's PipelineConfig at n views with partition on,
    as CLI overrides (key -> value): sift, match, ransac, the engine with
    its n-scaled capacities, ba, vocab, partition, pair and engine mode."""
    return {
        "sift.image_max_dim": size, "sift.max_keypoints": 1024, "sift.max_candidates": 4096,
        "sift.num_octaves": 3, "match.max_matches": 512, "match.min_matches": 12,
        "ransac.num_hypotheses": 512, "ransac.min_inliers": 12, "ransac.error_threshold_px": 2.0,
        "engine.init_min_inliers": 25, "engine.abs_pose_min_inliers": 10, "engine.local_ba_window": 6,
        "engine.global_ba_every": 8, "engine.max_images": max(4096, n),
        "engine.max_points": max(1 << 18, 512 * n), "engine.max_observations": max(1 << 20, 4096 * n),
        "ba.max_iterations": 15, "vocab.num_neighbors": min(12, n - 1),
        "partition.enabled": True, "partition.target_cluster_size": max(25, n // 16),
        "partition.overlap_cameras": 16, "partition.parallel_clusters": 4 if n >= 256 else 1,
        "pair_mode": "vocab_tree", "engine_mode": mode,
    }


@contextlib.contextmanager
def record_partition():
    """Record what the divide-and-conquer pipeline did, by wrapping its
    phases for the duration: the sizes of the clusters partition_images
    built; each cluster's engine run (its thread, images, registered
    cameras, valid points, seconds; no counts where the engine gave up);
    the clusters the gate passed to the pose-graph merge and those it
    placed; the images each rescue pass registered."""
    import threading

    import numpy as np

    from sfm_tpu_torch.pipeline import engine, global_engine, merge, partition

    rec = dict(clusters=[], runs=[], merge_in=None, placed=None, rescued=[])
    inner = dict(partition=partition.partition_images, global_reconstruct=global_engine.global_reconstruct,
                 incremental_reconstruct=engine.incremental_reconstruct,
                 pose_graph=partition._merge_via_pose_graph, sim3=merge.apply_sim3_to_reconstruction,
                 rescue=partition._rescue_unregistered)
    lock = threading.Lock()

    def partition_images(*a, **k):
        out = inner["partition"](*a, **k)
        rec["clusters"] = [len(c) for c in out]
        return out

    def cluster_engine(key):
        def fn(feats, graph, *a, **k):
            t0 = time.perf_counter()
            row = dict(thread=threading.current_thread().name,
                       images=int(np.unique(graph.pairs[graph.ok]).size))
            try:
                out = inner[key](feats, graph, *a, **k)
                row.update(registered=int(out.num_registered), points=int(out.point_valid.sum()))
                return out
            finally:
                with lock:
                    rec["runs"].append(dict(row, seconds=time.perf_counter() - t0))
        return fn

    def pose_graph(recs, *a, **k):
        rec["merge_in"], placed = len(recs), [0]

        def sim3(*aa, **kk):
            placed[0] += 1
            return inner["sim3"](*aa, **kk)

        merge.apply_sim3_to_reconstruction = sim3
        try:
            return inner["pose_graph"](recs, *a, **k)
        finally:
            merge.apply_sim3_to_reconstruction = inner["sim3"]
            rec["placed"] = placed[0]

    def rescue(*a, **k):
        out = inner["rescue"](*a, **k)
        rec["rescued"].append(out)
        return out

    partition.partition_images, partition._merge_via_pose_graph = partition_images, pose_graph
    partition._rescue_unregistered = rescue
    global_engine.global_reconstruct = cluster_engine("global_reconstruct")
    engine.incremental_reconstruct = cluster_engine("incremental_reconstruct")
    try:
        yield rec
    finally:
        partition.partition_images, partition._merge_via_pose_graph = inner["partition"], inner["pose_graph"]
        partition._rescue_unregistered = inner["rescue"]
        global_engine.global_reconstruct = inner["global_reconstruct"]
        engine.incremental_reconstruct = inner["incremental_reconstruct"]


def run_config4(workdir: str, images: int = CONFIG4_IMAGES, mode: str = "global", extra: tuple = (),
                **overrides):
    """Config #4 from files: benchmarks/ladder.py's scene at `images` views
    rendered and written as PGM files, then
    sfm_tpu_torch.cli.main(["reconstruct", DIR, "--out", OUT, *extra,
    *the ladder's fields and `overrides` as key=value]) in this process,
    inside forbid_plain (launches count): streaming decode, K1, the vocab
    tree, K2 on the vocab and ladder pairs, partitioning, the clusters on
    partition.parallel_clusters threads through `mode`'s engine, the
    cluster gate, the pose-graph merge, the rescue, the polish, COLMAP text
    + bin + PLY. Returns the run's record, with the stacks and pair blocks
    it handed K1 and K2; of its BAs only the polish's and the largest
    cluster BAs hold their problems."""
    import os

    from sfm_tpu_torch import cli, kernels

    t0 = time.perf_counter()
    imgs, scene = render_pool(**config4_scene(images))
    image_dir = write_pgm_views(imgs, os.path.join(workdir, "images"))
    render_s = time.perf_counter() - t0
    del imgs
    fields = {**config4_overrides(images, mode), **overrides}
    argv = ["reconstruct", image_dir, "--out", os.path.join(workdir, "out"), *extra,
            *(f"{k}={json.dumps(v)}" for k, v in fields.items())]
    blocks, largest = {}, [0]

    def keep(b):
        """The polish's BAs, and each cluster BA of more observations than
        any before it (config4_idle solves the largest one again)."""
        if b["C"] >= 0.95 * images:
            return True
        if b["O"] > largest[0]:
            largest[0] = b["O"]
            return True
        return False

    with forbid_plain() as plain, record_bundle_adjustments(keep) as ba_log, record_vocab_run() as record, \
            record_partition() as part, record_match_shapes(blocks), record_dog_stacks() as stacks:
        kernels.reset_launches()
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError(f"config4: cli.main({argv}) failed")
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    return dict(record, launches=launches, ba_log=ba_log, wall=wall, scene=scene, argv=argv, out=argv[3],
                images=images, mode=mode, fields=fields, render_s=render_s, plain=plain, partition=part,
                match_blocks=blocks, dog_stacks=stacks)


def config4_readings(run) -> dict:
    """What run_config4's run did and how well: accuracy, stage seconds,
    pairs, clusters, threads, rescues, the last BA, launches."""
    rec, part = run["rec"], run["partition"]
    s = rec.summary()
    last = run["ba_log"][-1] if run["ba_log"] else {}
    runs = part["runs"]
    rmse = camera_rmse(rec, run["scene"])
    return {
        "images": run["images"], "mode": run["mode"], "registered": s["num_registered"],
        "points": s["num_points"], "observations": s["num_observations"],
        "mean_reproj_px": s["mean_reproj_error_px"], "median_reproj_px": s["median_reproj_error_px"],
        "camera_rmse": rmse, "camera_rmse_pct_radius": 100 * rmse / CONFIG4_RADIUS,
        "wall_s": run["wall"], "render_s": run["render_s"], "stage_s": rec.stage_seconds,
        "vocab_build_s": run.get("build_s"), "candidate_pairs": run.get("candidate_pairs"),
        "verified_before_densify": run.get("verified_before_densify"),
        "ladder_candidates": run.get("ladder_candidates", 0), "ladder_pairs_added": run.get("ladder_pairs_added"),
        "verified_edges": run.get("verified_edges"), "artifact_save_s": run["artifact_save_s"],
        "clusters_built": len(part["clusters"]), "cluster_sizes": part["clusters"],
        "clusters_reconstructed": sum(r.get("registered", 0) >= 2 and r.get("points", 0) >= 8 for r in runs),
        "clusters_gated_in": part["merge_in"], "clusters_merged": part["placed"],
        "cluster_threads": sorted({r["thread"] for r in runs}),
        "cluster_s": sorted(round(r["seconds"], 3) for r in runs),
        "rescued": part["rescued"],
        "last_ba": {k: v for k, v in last.items() if k not in ("problem", "cfg")},
        "bas": len(run["ba_log"]), "pcg_bas": sum(b["solver"] == "pcg" for b in run["ba_log"]),
        "plain_on_cuda": sorted(set(run["plain"])), "launches": run["launches"],
    }


def check_config4(run, r: dict) -> list:
    """Phase 14's bars (sfm_tpu's ladder row for 1,000 views with a
    margin): the failures, as strings. >= 99% registered, < 1.0 px, camera
    RMSE < 0.5% of the radius, the engine's and the partition's stages
    timed, >= 8 clusters reconstructed on more than one thread, the last
    BA (the polish) on the PCG branch over >= 95% of the views, the
    path's kernels launched (K1, K2, K3 with K7's blocks, K5, K9,
    pcg_solve), neither the coupling-only K11 nor any large-camera kernel,
    no plain version handed a CUDA tensor, and the COLMAP model read back."""
    n, launches = run["images"], run["launches"]
    failed = []
    if r["registered"] < CONFIG4_REGISTERED * n:
        failed.append(f"{r['registered']}/{n} registered")
    if not r["mean_reproj_px"] < CONFIG4_PX:
        failed.append(f"mean reprojection error {r['mean_reproj_px']} px")
    if not r["camera_rmse"] < CONFIG4_RMSE * CONFIG4_RADIUS:
        failed.append(f"camera RMSE {r['camera_rmse_pct_radius']:.3f}% of the radius")
    missing = [k for k in CONFIG4_STAGES if k not in r["stage_s"]]
    if missing:
        failed.append(f"stages not timed: {missing}")
    if r["clusters_reconstructed"] < CONFIG4_CLUSTERS or len(r["cluster_threads"]) < 2:
        failed.append(f"{r['clusters_reconstructed']} clusters on threads {r['cluster_threads']}")
    last = r["last_ba"]
    if last.get("solver") != "pcg" or last.get("C", 0) < 0.95 * n:
        failed.append(f"the polish did not take PCG over the views: {last}")
    never = [k for k in ("dog_extrema_scores", "blur_levels", "match_topk2", "fused_ne_payloads", "whw_cam_reduce",
                         "fused_cost_sums", "cam_segment_sum", "pcg_solve") if launches.get(k, 0) == 0]
    if never:
        failed.append(f"never launched: {never}")
    extra = {k: launches[k] for k in ("schur_coupling_matvec",) + BIG_KERNELS if launches.get(k, 0)}
    if extra:
        failed.append(f"launched off the path: {extra}")
    if r["plain_on_cuda"]:
        failed.append(f"plain versions handed CUDA tensors: {r['plain_on_cuda']}")
    try:
        r["colmap_bin_read_back"] = dict(zip(("cameras", "images", "points"),
                                             check_colmap_round_trip(run["rec"], run["out"], "config4")))
    except AssertionError as e:
        failed.append(str(e))
    return failed


def config4_polish(run):
    """The polish's first BA (over >= 95% of the views, PCG branch)."""
    n = run["images"]
    return next(b for b in run["ba_log"] if b["solver"] == "pcg" and b["C"] >= 0.95 * n)


def config4_kernels(run, device) -> dict:
    """Phase 14 (c): K1 on every stack the run handed it and K2 on the
    first pair block of each shape it handed it, each held against its
    plain version and timed; K3, K5, K9 (check_ba, check_k9) and pcg_solve
    (check_pcg) on the polish's own problem. Returns rows by kernel (a list
    each)."""
    polish = config4_polish(run)
    prob, cfg = polish["problem"], polish["cfg"]
    what = f"config4 polish C={polish['C']} O={polish['O']}"
    rows = {"dog_extrema_scores": check_dog_path(device, run["dog_stacks"]),
            "match_topk2": [check_match_shape(device, shape, inputs)
                            for shape, inputs in sorted(run["match_blocks"].items())]}
    ba = check_ba(prob, cfg, device, what)
    for k in ("fused_ne_payloads", "fused_cost_sums"):
        rows[k] = [dict(ba[k], shape=what)]
    rows["cam_segment_sum"] = check_k9(prob, cfg, device)["cam_segment_sum"]["shapes"]
    rows["pcg_solve"] = [dict(check_pcg(prob, cfg, device, what, x_steps=PCG_X_STEPS), shape=what)]
    return rows


def config4_idle(run, device) -> dict:
    """Device ms, launches, wall ms and idle share (chip_smoke.traced, one
    session) of one cluster's solve (the cluster BA of the most
    observations, as the run handed it to bundle_adjust) and of one match
    block (the match stage on the first block of the run's pairs, with the
    run's config), on the inputs the run held in memory."""
    from sfm_tpu_torch import ba
    from sfm_tpu_torch.config import PipelineConfig, apply_overrides
    from sfm_tpu_torch.pipeline import stages

    n = run["images"]
    cluster = max((b for b in run["ba_log"] if b["C"] < 0.95 * n and b["problem"] is not None),
                  key=lambda b: b["O"])
    feats, pairs, intrinsics = run["match_inputs"]
    cfg = apply_overrides(PipelineConfig(verbose=False), run["fields"])
    block = pairs[:cfg.match.block_pairs]
    parts = {}
    for name, fn in ((f"cluster BA C={cluster['C']} O={cluster['O']} {cluster['solver']}",
                      lambda: ba.bundle_adjust(cluster["problem"], cluster["cfg"])),
                     (f"match_and_verify {len(block)} pairs",
                      lambda: stages.match_and_verify_stage(feats, block, intrinsics, cfg, device))):
        rows, wall_ms, _ = traced(fn, sessions=1)
        launches, busy_ms, _ = per_call(rows, 1)
        parts[name] = dict(device_ms=busy_ms, launches=launches, wall_ms=wall_ms,
                           idle_share=1.0 - busy_ms / wall_ms)
    return parts


# ---- phase 12: several devices, one process on the card ---------------------

# The camera-sharded LM's two kernel entries (K3's sharded mode, K11 cut at
# h), at both camera widths; only phase 12 launches them.
SHARDED_KERNELS = ("fused_ne_sums", "coupling_point_half", "coupling_camera_half")
SHARDED_WIDE = tuple(f"{k}_w8" for k in SHARDED_KERNELS)
# Phase 12 (e): LM iterations of the sharded merged polish; (d): of the
# bit-identical reruns; (g): of the profiled sharded solve.
DIST_POLISH_ITERATIONS = 3
DIST_RERUN_ITERATIONS = 3
DIST_TRACED_ITERATIONS = 2
# Phase 12 (c): the ring's pairs verified both ways (eight blocks of 32).
DIST_VERIFY_PAIRS = 256
# Phase 12 (d) and (e): tests/distributed/test_sharding.py's bars.
DIST_COST_RTOL = 1e-3
DIST_CAMS_ATOL = 5e-3


def join_group(device):
    """Phase 12's process group: this process alone, NCCL on the card,
    joined through dist.mesh as a multi-host run joins it (the coordinator
    fields of ShardConfig, a free port on localhost)."""
    import socket

    from sfm_tpu_torch.config import ShardConfig
    from sfm_tpu_torch.dist.mesh import initialize_multihost, make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_multihost(ShardConfig(multihost=True, coordinator_address=f"localhost:{port}",
                                     num_processes=1, process_id=0), device)
    return make_mesh(1, device)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def counted(fn):
    """fn() with the launch counts set to 0 just before and read just after:
    (its result, the counts that moved)."""
    from sfm_tpu_torch import kernels

    kernels.reset_launches()
    out = fn()
    return out, {k: v for k, v in kernels.LAUNCHES.items() if v}


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def check_dp_extract(imgs, device, mesh) -> dict:
    """Phase 12 (a): the feature stage over the group (DP extraction: each
    process its 8 views of every chunk, K1, then all_gather) against the
    single-card stage on the same views, default config: every Features
    array identical."""
    import numpy as np

    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.pipeline import ingest, stages

    cfg = PipelineConfig(verbose=False)
    batch = ingest.load_images(list(imgs), cfg.sift)
    t0 = time.perf_counter()
    single = stages.extract_stage(batch, cfg, device)
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp, launches = counted(lambda: stages.extract_stage(batch, cfg, device, mesh))
    dp_s = time.perf_counter() - t0
    differ = [f for f in ("xy", "sigma", "angle", "response", "desc", "valid")
              if not np.array_equal(getattr(single, f), getattr(dp, f))]
    if differ or (device.type == "cuda" and not launches.get("dog_extrema_scores")):
        raise AssertionError(f"DP extraction: {differ} differ from the single-card stage; launches {launches}")
    return dict(feats=dp, intrinsics=batch.intrinsics, cfg=cfg, launches=launches, views=len(imgs),
                keypoints=int(dp.valid.sum()), single_s=single_s, dp_s=dp_s)


def block_matches(feats, pairs, cfg, device):
    """The single-card match stage's matches of `pairs` (ops/match.match_block
    over blocks of cfg.match.block_pairs pairs at the stage's keypoint
    bucket) -> numpy (idx_i, idx_j, valid) [E, M]."""
    import numpy as np
    import torch

    from sfm_tpu_torch.ops.match import match_block
    from sfm_tpu_torch.pipeline import stages

    n = stages._bucket_keypoints(int(feats.valid.sum(axis=1).max()), feats.valid.shape[1])
    desc = torch.from_numpy(np.ascontiguousarray(feats.desc[:, :n])).to(device)
    valid = torch.from_numpy(np.ascontiguousarray(feats.valid[:, :n])).to(device)
    outs = []
    for s in range(0, len(pairs), cfg.match.block_pairs):
        i = torch.from_numpy(pairs[s:s + cfg.match.block_pairs, 0].astype(np.int64)).to(device)
        j = torch.from_numpy(pairs[s:s + cfg.match.block_pairs, 1].astype(np.int64)).to(device)
        outs.append([t.cpu().numpy() for t in match_block(desc[i], valid[i], desc[j], valid[j], cfg.match)])
    return tuple(np.concatenate(t) for t in zip(*outs))


def check_ring(dp, device, mesh) -> dict:
    """Phase 12 (b): stages.ring_match_pairs over the group (the ring
    matcher, K2 at every step) against the block matcher on every
    exhaustive pair, kept where it finds match.min_matches: the same pairs,
    indices and masks."""
    import numpy as np

    from sfm_tpu_torch.pipeline import stages

    feats, cfg = dp["feats"], dp["cfg"]
    t0 = time.perf_counter()
    ring, launches = counted(lambda: stages.ring_match_pairs(feats, cfg, device, mesh))
    ring_s = time.perf_counter() - t0
    pairs = stages.exhaustive_pairs(len(feats.xy))
    t0 = time.perf_counter()
    ii, jj, ok = block_matches(feats, pairs, cfg, device)
    block_s = time.perf_counter() - t0
    keep = ok.sum(-1) >= cfg.match.min_matches
    same = [np.array_equal(a, b) for a, b in zip(ring, (pairs[keep], ii[keep], jj[keep], ok[keep]))]
    if not all(same) or (device.type == "cuda" and not launches.get("match_topk2")):
        raise AssertionError(f"ring matcher: pairs, idx_i, idx_j, valid equal {same}; launches {launches}")
    return dict(ring=ring, launches=launches, pairs=int(keep.sum()), exhaustive=len(pairs),
                ring_s=ring_s, block_s=block_s)


def check_sharded_verify(dp, ring, device, mesh) -> dict:
    """Phase 12 (c): the match + verify stage as a multi-device run calls it
    (the ring's matches verified, each process its share of every pair
    block, then all_gather) against the single-card stage on the same pairs
    (the block matcher's matches, equal to the ring's by (b)), on the ring's
    first DIST_VERIFY_PAIRS pairs: every field of the graph identical."""
    import numpy as np

    from sfm_tpu_torch.pipeline import stages

    feats, cfg, intr = dp["feats"], dp["cfg"], dp["intrinsics"]
    pairs, pi, pj, pv = (a[:DIST_VERIFY_PAIRS] for a in ring["ring"])
    t0 = time.perf_counter()
    single = stages.match_and_verify_stage(feats, pairs, intr, cfg, device, seed=cfg.seed)
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph, launches = counted(lambda: stages.match_and_verify_stage(
        feats, pairs, intr, cfg, device, seed=cfg.seed, prematched=(pi, pj, pv), mesh=mesh))
    sharded_s = time.perf_counter() - t0
    fields = ("pairs", "idx_i", "idx_j", "inlier", "num_inliers", "num_h_inliers", "rvec", "tvec", "ok",
              "pose_ok")
    differ = [f for f in fields if not np.array_equal(getattr(single, f), getattr(graph, f))]
    if differ:
        raise AssertionError(f"pair-sharded verify: {differ} differ from the single-card graph")
    return dict(launches=launches, verified=int(graph.ok.sum()), pairs=len(pairs), single_s=single_s,
                sharded_s=sharded_s)


def sharded_local(prob):
    """The rows a one-process group solves: shard_problem_by_camera's rows of
    shard 0, sorted by point (dist.sharded_ba.local_rows)."""
    from sfm_tpu_torch.dist.sharded_ba import local_rows, shard_problem_by_camera

    return local_rows(shard_problem_by_camera(prob, 1), 0, 1)


def pose_gaps(cams, ref, prob) -> dict:
    """How far the cameras `cams` [C, D] sit from `ref` beyond the BA's
    gauge: only camera 0 is fixed, so the problem's scale is free and the LM
    moves along it by rounding alone. The rotations (and the intrinsic
    columns at D = 8) as they are; the camera centres after a Sim(3)
    alignment of cams' onto ref's; over the cameras with a weighted
    observation (the others are padding). Also the raw max |cams - ref|."""
    import numpy as np
    import torch

    from sfm_tpu_torch.geometry.rotations import so3_exp
    from sfm_tpu_torch.geometry.similarity import umeyama_np

    seen = torch.bincount(prob.obs_cam[prob.obs_w > 0].long(), minlength=prob.num_cameras) > 0
    a, b = cams[seen].double().cpu(), ref[seen].double().cpu()

    def centres(c):
        return (-torch.einsum("kji,kj->ki", so3_exp(c[:, :3]), c[:, 3:6])).numpy()

    ca, cb = centres(a), centres(b)
    s, R, t = umeyama_np(ca, cb)
    cols = [0, 1, 2] + list(range(6, a.shape[1]))
    return dict(rotations=float((a[:, cols] - b[:, cols]).abs().max()),
                centres_aligned=float(np.linalg.norm(s * ca @ R.T + t - cb, axis=1).max()),
                raw=float((a - b).abs().max()))


def check_sharded_ba(prob, cfg, device, mesh, what: str, iterations: int | None = None) -> dict:
    """Phase 12 (d), (e): dist.sharded_ba.bundle_adjust_sharded over the
    group against the single-card bundle_adjust on the same problem: final
    cost within DIST_COST_RTOL, the poses within DIST_CAMS_ATOL
    (tests/distributed/test_sharding.py's bars; the rotations and the camera
    centres after a Sim(3) alignment, pose_gaps: on the ring's final BA the
    first run found the raw parameters 5.2e-3 apart at the same fp32 cost),
    a rerun bit-identical, no
    plain version handed a CUDA tensor, the launch counts set to 0 just
    before and read just after. With `iterations` the LM runs that many
    iterations, and the sharded one 1 .. iterations - 1 more: its cost must
    fall at every one. The rerun is of the whole solve with `iterations`,
    else of the first DIST_RERUN_ITERATIONS iterations, twice (a sharded
    CG step is ~40 launches from Python, PERF.md)."""
    import dataclasses

    import torch

    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.dist.sharded_ba import bundle_adjust_sharded, shard_problem_by_camera

    if iterations is not None:
        cfg = dataclasses.replace(cfg, max_iterations=iterations)
    t0 = time.perf_counter()
    single, s_stats = core.bundle_adjust(prob, cfg)
    sync(device)
    single_s = time.perf_counter() - t0
    sharded = shard_problem_by_camera(prob, mesh.size)
    with forbid_plain() as plain:
        t0 = time.perf_counter()
        (out, stats), launches = counted(lambda: bundle_adjust_sharded(sharded, cfg, mesh))
        sync(device)
        sharded_s = time.perf_counter() - t0
        # The rerun: of the whole solve where it is `iterations` long, else
        # of its first DIST_RERUN_ITERATIONS iterations, twice.
        short = dataclasses.replace(cfg, max_iterations=iterations or DIST_RERUN_ITERATIONS)
        first = out if iterations else bundle_adjust_sharded(sharded, short, mesh)[0]
        again = bundle_adjust_sharded(sharded, short, mesh)[0]
        costs = [float(stats.initial_cost)]
        for k in range(1, iterations or 0):
            costs.append(float(bundle_adjust_sharded(sharded, dataclasses.replace(cfg, max_iterations=k),
                                                     mesh)[1].final_cost))
        costs.append(float(stats.final_cost))
    r = dict(what=what, C=prob.num_cameras, O=int(prob.obs_w.shape[0]), width=prob.cam_params.shape[-1],
             single_cost=float(s_stats.final_cost), sharded_cost=float(stats.final_cost),
             single_iterations=int(s_stats.iterations), sharded_iterations=int(stats.iterations),
             poses=pose_gaps(out.cam_params, single.cam_params, prob),
             single_s=single_s, sharded_s=sharded_s, plain_calls=sorted(set(plain)), launches=launches)
    r["cost_rel"] = abs(r["sharded_cost"] / r["single_cost"] - 1.0)
    if iterations is not None:
        r["costs_by_iteration"] = costs
    bad = []
    if not r["cost_rel"] <= DIST_COST_RTOL:
        bad.append("cost")
    if not max(r["poses"]["rotations"], r["poses"]["centres_aligned"]) <= DIST_CAMS_ATOL:
        bad.append("poses")
    if not (torch.equal(first.cam_params, again.cam_params) and torch.equal(first.points, again.points)):
        bad.append("rerun")
    if plain:
        bad.append("plain versions on the card")
    if iterations is not None and not all(b < a for a, b in zip(costs, costs[1:])):
        bad.append("cost by iteration")
    if bad:
        raise AssertionError(f"sharded BA ({what}): {bad} off: {r}")
    return r


def ne_sums_bytes_ops(prob, inv) -> tuple[int, int]:
    """What K3's sharded mode must move and compute: K3's reads (ne_bytes_ops
    without lam), W [3D, O] and the sums written once (Hcc, bc, the point
    sums [P, 9]); the packed camera rows are scratch. Operations: K3's per
    observation, 9 per observation for the point sums, D^2 + D per weighted
    observation for the camera sums."""
    O, C, P, D = prob.obs_w.shape[0], prob.num_cameras, prob.num_points, prob.cam_params.shape[-1]
    N, M = inv.cam_inv_perm.numel(), inv.cam_perm.numel()
    rows = D * D + D
    moved = 4 * (2 * N + 5 * N + N + 3 * P + (D + 6) * C + P + 1 + C + 1
                 + 3 * D * O + 9 * P + rows * C)
    return moved, (300 if D == 6 else 420) * N + 9 * N + rows * M


# check_big's bar for K4 against float64 on the merged model: there the
# world origin lies many depths from a camera's points, R p + t cancels, and
# any fp32 evaluation of a residual moves its IRLS weight by ~1e-4.
MERGED_NE_BAR = 1e-3


def check_sharded_kernels(prob, cfg, device, what: str, f64_bar: float | None = None) -> dict:
    """Phase 12 (f): K3's sharded mode and both halves of K11 on the rows a
    one-process group solves (sharded_local) at its first LM iteration,
    against their plain versions in float64 on the same fp32 inputs:
    - fused_ne_sums: Hcc and the point blocks sym(Jp^T Jp) within NE_BAR of
      each block's max |value|, bc and bp within NE_BAR of their term scale
      (rhs_scales), W within NE_PAYLOAD_BAR of its max (check_ba's bars; on
      the merged model every one within f64_bar, MERGED_NE_BAR there); and
      the bits of K3 (the same device code, undamped) wherever K3 writes
      the same sums: W, bc, bp (the point sums' last three columns) and
      Hcc off its diagonal;
    - coupling_point_half (a random v) and coupling_camera_half (a random
      h) within 1e-5 of the output's max (check_schur's K11 bar); composed
      through the damped, inverted point blocks, within 1e-5 of K11 itself;
    - identical bits on a rerun, for each.
    Each timed beside its plain version in fp32 and its bound. An 8-wide
    problem runs the `_w8` builds."""
    import torch

    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.kernels import ba_kernels as kb

    local = sharded_local(prob)
    inv = core.solve_invariants(local, core.near_plane_floor(local))
    O, C, P, D = local.obs_w.shape[0], local.num_cameras, local.num_points, local.cam_params.shape[-1]
    N, M = inv.cam_inv_perm.numel(), inv.cam_perm.numel()
    suffix = "" if D == 6 else "_w8"
    shape = f"{what}: O={O} ({N} in point segments) C={C} P={P}"
    loss = (cfg.robust_loss, cfg.robust_scale_px)
    f64 = lambda t: None if t is None else t.double()

    def ne_args(dt=lambda t: t):
        return (local.obs_cam, local.obs_point, dt(local.points), dt(inv.static_t),
                dt(local.cam_params.contiguous()), dt(local.intrinsics), inv.point_bounds, inv.cam_perm,
                inv.cam_bounds)

    ne = lambda: kb.fused_ne_sums(*ne_args(), inv.cam_inv_perm, inv.z_floor, *loss, plan=inv.pcg_plan)
    out = ne()
    ref = kb.fused_ne_sums_plain(*ne_args(f64), f64(inv.z_floor), *loss)
    cam_scale, pt_scale = rhs_scales(local, inv, local.points, inv.z_floor, loss)
    errs = {"Hcc": float(block_errors(out[0], ref[0], ref[0].abs()).max()),
            "W_t": float((out[1].double() - ref[1]).abs().max()) / max(float(ref[1].abs().max()), 1e-30),
            "bc": float(block_errors(out[2], ref[2], cam_scale).max()),
            "Hpp": float(block_errors(out[3][:, :6], ref[3][:, :6], ref[3][:, :6].abs()).max()),
            "bp": float(block_errors(out[3][:, 6:], ref[3][:, 6:], pt_scale).max())}
    bars = {"Hcc": NE_BAR, "W_t": NE_PAYLOAD_BAR, "bc": NE_BAR, "Hpp": NE_BAR, "bp": NE_BAR}
    off = [k for k, bar in bars.items() if not errs[k] <= (f64_bar or bar)]
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=device)
    k3 = kb.fused_ne_payloads(*ne_args(), inv.cam_inv_perm, lam, inv.z_floor, *loss, plan=inv.pcg_plan)
    off_diag = ~torch.eye(D, dtype=torch.bool, device=device)
    twin = {"W_t": torch.equal(out[1], k3[2]), "bc": torch.equal(out[2], k3[3]),
            "bp": torch.equal(out[3][:, 6:9], k3[4]), "Hcc": torch.equal(out[0][:, off_diag], k3[0][:, off_diag])}
    if off or not all(twin.values()) or not all(torch.equal(a, b) for a, b in zip(out, ne())):
        raise AssertionError(f"fused_ne_sums ({shape}): {off} off, bits of K3 {twin}, or a rerun "
                             f"differs; errors {errs}")
    moved, ops = ne_sums_bytes_ops(local, inv)
    results = {"fused_ne_sums" + suffix: dict(
        shape=shape, max_abs_err=float(max((a.double() - b).abs().max() for a, b in zip(out, ref))),
        ms=time_ms(ne, device),
        plain_ms=time_ms(lambda: kb.fused_ne_sums_plain(*ne_args(), inv.z_floor, *loss), device, PLAIN_RUNS),
        library_ms=None, **bound(moved, ops, FP32_OPS_PER_S), device_ms=device_ms(ne, device),
        note=f"{shape}: errors vs float64 " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
             + "; K3's bits (W, bc, bp, Hcc off its diagonal); deterministic")}

    W_t = out[1]
    gen = torch.Generator(device=device).manual_seed(11)
    v = torch.randn((C, D), generator=gen, device=device)
    h = torch.randn((P, 3), generator=gen, device=device)
    point = lambda: kb.coupling_point_half(W_t, local.obs_cam, inv.point_bounds, v)
    camera = lambda: kb.coupling_camera_half(W_t, local.obs_point, inv.point_bounds, inv.cam_perm,
                                             inv.cam_bounds, inv.cam_inv_perm, h)
    g, y = point(), camera()
    g_err, g_rel = max_rel(g, kb.coupling_point_half_plain(W_t.double(), local.obs_cam, inv.point_bounds,
                                                           v.double()))
    y_err, y_rel = max_rel(y, kb.coupling_camera_half_plain(W_t.double(), local.obs_point, inv.cam_perm,
                                                            inv.cam_bounds, h.double()))
    # The halves composed through the damped, inverted point blocks: K11.
    hinv = core._sym_solve3_big(core._damp_big(core._sym3_big(out[3][:, :6]), lam)).contiguous()
    hg = torch.einsum("pij,pj->pi", hinv, g).contiguous()
    composed = kb.coupling_camera_half(W_t, local.obs_point, inv.point_bounds, inv.cam_perm, inv.cam_bounds,
                                       inv.cam_inv_perm, hg)
    k11 = kb.schur_coupling_matvec(W_t, hinv, local.obs_cam, local.obs_point, inv.point_bounds,
                                   inv.cam_perm, inv.cam_bounds, v, inv.cam_inv_perm)
    k11_rel = max_rel(composed, k11)[1]
    if not (g_rel <= 1e-5 and y_rel <= 1e-5 and k11_rel <= 1e-5 and torch.equal(g, point())
            and torch.equal(y, camera())):
        raise AssertionError(f"K11 halves ({shape}): point half {g_rel:.2e}, camera half {y_rel:.2e}, "
                             f"composed vs K11 {k11_rel:.2e}, or a rerun differs")
    # Bytes: W's 3D rows of the N observations, their camera ids (point
    # half) or camera-sorted places (camera half), the point segments, v
    # and g (point half) or h, the camera segments and the output (camera
    # half). Operations: 6D multiply-adds and 3 adds per observation, or
    # 6D and D per weighted observation.
    results["coupling_point_half" + suffix] = dict(
        shape=shape, max_abs_err=g_err, ms=time_ms(point, device),
        plain_ms=time_ms(lambda: kb.coupling_point_half_plain(W_t, local.obs_cam, inv.point_bounds, v), device,
                         PLAIN_RUNS),
        library_ms=None, **bound(4 * (3 * D * N + N + P + 1 + D * C + 3 * P), 6 * D * N + 3 * N, FP32_OPS_PER_S),
        device_ms=device_ms(point, device),
        note=f"{shape}: rel err {g_rel:.2e} vs float64, deterministic; composed with the camera half "
             f"through Hpp^-1: {k11_rel:.2e} from K11")
    results["coupling_camera_half" + suffix] = dict(
        shape=shape, max_abs_err=y_err, ms=time_ms(camera, device),
        plain_ms=time_ms(lambda: kb.coupling_camera_half_plain(W_t, local.obs_point, inv.cam_perm,
                                                               inv.cam_bounds, h), device, PLAIN_RUNS),
        library_ms=None, **bound(4 * (3 * D * N + N + P + 1 + 3 * P + C + 1 + D * C), 6 * D * N + D * M,
                                 FP32_OPS_PER_S),
        device_ms=device_ms(camera, device),
        note=f"{shape}: rel err {y_rel:.2e} vs float64, deterministic")
    return results


def sharded_lm_report(prob, cfg, device, mesh) -> dict:
    """Phase 12 (g): the sharded LM's steps on the rows a one-process group
    solves, at the first LM iteration, as lm_report gives the single-card
    ones: the normal-equation build (K3's sharded mode, the all_reduce, the
    damping and inversions, K7 standalone and its all_reduce), the rhs and
    the PCG solve (pcg_loop over the halves of K11, two all_reduces a step),
    the candidate (K11's point half, its all_reduce, K5 in its cost mode and
    the all_reduce of its sums), each as device launches, device ms and
    event ms per call (the solve: one traced session, the median of 5
    timed calls); then bundle_adjust_sharded for DIST_TRACED_ITERATIONS
    iterations under torch.profiler (one session): device launches and
    device ms per LM iteration, device busy ms, wall ms, idle share."""
    import dataclasses

    import torch

    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.dist.sharded_ba import bundle_adjust_sharded, shard_problem_by_camera

    group = mesh.group
    local = sharded_local(prob)
    inv = core.solve_invariants(local, core.near_plane_floor(local, group))
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=device)
    cams, points = local.cam_params, local.points
    build = lambda: core.build_normal_equations(local, cams, points, lam, cfg, inv, group=group)
    ne = build()
    solve = lambda: core._pcg(ne, local, core._schur_rhs(ne, local, inv, group), cfg, inv, group)
    dc = solve()
    # The solve and the whole LM are ~2,900 launches an iteration: one traced
    # session each (three took ~60 s of phase 12 in the profiler's own host
    # work).
    launches, ms, top = per_call(traced(solve, sessions=1)[0], 1)
    rows = {"NE build": profile_calls(build, device, calls=5),
            "rhs + PCG": dict(launches=launches, device_ms=ms, event_ms=time_ms(solve, device, runs=5),
                              top=top[:4]),
            "candidate": profile_calls(lambda: core.lm_candidate(ne, local, dc, cams, points, cfg, inv, group),
                                       device, calls=5)}
    sharded = shard_problem_by_camera(prob, mesh.size)
    short = dataclasses.replace(cfg, max_iterations=DIST_TRACED_ITERATIONS)
    trace, wall, (_, stats) = traced(lambda: bundle_adjust_sharded(sharded, short, mesh), sessions=1)
    its = max(int(stats.iterations), 1)
    busy = device_time_ms(trace)[0]
    rows["bundle_adjust_sharded"] = dict(lm_iterations=its, launches_per_lm_iteration=device_launches(trace) / its,
                                         device_ms=busy, device_ms_per_lm_iteration=busy / its, wall_ms=wall,
                                         idle_share=1.0 - busy / wall)
    return rows


def run_sharded(imgs, ring_ba, polish_ba, device, refined_polish_ba=None) -> dict:
    """Phase 12: one process joins a one-process NCCL group on the card
    through dist.mesh and runs every multi-device route against the
    single-card one: (a)-(c) on the refined phase's 46 views, (d) on phase
    5's final global BA problem at 6 and 8 wide, (e) on phase 8's merged
    polish problem for DIST_POLISH_ITERATIONS iterations, and on phase 13's
    refined polish problem (8 wide, past 4,096 cameras: phase 13 (c)) as
    long, (f) the new kernel entries at (d)'s and (e)'s shapes, (g) the
    sharded LM iteration's launches, each logged as it is done. Returns the
    rows of the kernels' record and the launches of the sharded routes (one
    path)."""
    import torch.distributed as dist

    from sfm_tpu_torch.ba import build_problem

    mesh = join_group(device)
    try:
        launches = {}
        dp = check_dp_extract(imgs, device, mesh)
        add_launches(launches, dp["launches"])
        log("[dist] (a) DP extraction: " + json.dumps(
            {k: dp[k] for k in ("views", "keypoints", "single_s", "dp_s", "launches")}) + " identical")
        ring = check_ring(dp, device, mesh)
        add_launches(launches, ring["launches"])
        log("[dist] (b) ring matcher: " + json.dumps(
            {k: ring[k] for k in ("pairs", "exhaustive", "ring_s", "block_s", "launches")}) + " identical")
        ver = check_sharded_verify(dp, ring, device, mesh)
        add_launches(launches, ver["launches"])
        log("[dist] (c) pair-sharded verify: " + json.dumps(ver) + " identical")
        del dp, ring

        prob, cfg, rec = ring_ba
        prob8, _, _ = build_problem(rec, refine_intrinsics=True, device=device)
        cfg8 = refine_config(cfg)
        polish, polish_cfg = polish_ba
        cases = [(prob, cfg, "final global BA"), (prob8, cfg8, "final global BA, 8 wide"),
                 (polish, polish_cfg, "merged polish", DIST_POLISH_ITERATIONS)]
        if refined_polish_ba is not None:
            cases.append((*refined_polish_ba, "refined polish", DIST_POLISH_ITERATIONS))
        for args in cases:
            r = check_sharded_ba(args[0], args[1], device, mesh, *args[2:])
            add_launches(launches, r["launches"])
            tag = {"merged polish": "(e)", "refined polish": "(13c)"}.get(r["what"], "(d)")
            log(f"[dist] {tag} sharded BA: " + json.dumps(r))
        t0 = time.perf_counter()
        results = {**check_sharded_kernels(prob, cfg, device, "final global BA"),
                   **check_sharded_kernels(prob8, cfg8, device, "final global BA, 8 wide")}
        big = check_sharded_kernels(polish, polish_cfg, device, "merged polish", f64_bar=MERGED_NE_BAR)
        for k, r in big.items():
            results[k]["shapes"] = [dict(results[k]), r]
        log(f"[dist] (f) the three entries held and timed at three shapes in {time.perf_counter() - t0:.2f}s")
        t0 = time.perf_counter()
        for what, p, c in (("final global BA", prob, cfg), ("merged polish", polish, polish_cfg)):
            log(f"[lm] sharded LM, {what}: " + json.dumps(sharded_lm_report(p, c, device, mesh)))
        log(f"[dist] (g) profiled in {time.perf_counter() - t0:.2f}s")
        missing = [k for k in SHARDED_KERNELS + SHARDED_WIDE if not launches.get(k)]
        if device.type == "cuda" and missing:
            raise AssertionError(f"phase 12: never launched {missing}")
        return dict(results=results, launches=launches)
    finally:
        dist.destroy_process_group()


def phase_config4(device) -> tuple[dict, dict]:
    """Phase 14, config #4 from files: benchmarks/ladder.py's 1,000 views
    through the CLI with vocab pairs, partitioning, the clusters of the
    global engine on four threads, the pose-graph merge and the 1,000-camera
    polish (run_config4), its bars (check_config4), its kernels at the run's
    shapes (config4_kernels) and its idle shares (config4_idle). Runs first,
    on a fresh process and a clean card. Returns (the kernel rows of (c) by
    kernel, the run's launch counts)."""
    import gc

    import torch

    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_config4_")
    try:
        run = run_config4(workdir, verbose=False)
        c4 = config4_readings(run)
        log_bundle_adjustments("config4", [config4_polish(run), run["ba_log"][-1]])
        failed = check_config4(run, c4)
        if failed:
            raise AssertionError(f"config4: {failed}; {json.dumps(c4)}")
        rows = config4_kernels(run, device)
        idle = config4_idle(run, device)
        for k, v in rows.items():
            log_shapes(k, v)
        log("[config4] " + json.dumps({k: c4[k] for k in (
            "images", "registered", "mean_reproj_px", "camera_rmse_pct_radius", "wall_s", "render_s", "stage_s",
            "candidate_pairs", "verified_before_densify", "ladder_candidates", "ladder_pairs_added",
            "verified_edges", "artifact_save_s", "clusters_built", "clusters_reconstructed",
            "clusters_gated_in", "clusters_merged", "cluster_threads", "rescued", "bas", "pcg_bas",
            "colmap_bin_read_back", "launches")} | {"idle": idle, "phase_s": time.perf_counter() - t0}))
        return rows, run["launches"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        gc.collect()   # the run's garbage and cached blocks go before the next phase
        torch.cuda.empty_cache()


def prefetched_scenes() -> list:
    """The rendered scenes of the phases after phase 14 (render_pool's
    keywords, exactly as those phases ask for them): phase 5's ring, phase
    9's views and phase 11's ring rendered off its focal prior."""
    return [ring_scene(INC_IMAGES, INC_BLOBS, INC_ARC),
            ring_scene(VOCAB_SMOKE_IMAGES, INC_BLOBS, VOCAB_ARC * VOCAB_SMOKE_IMAGES / VOCAB_IMAGES),
            ring_scene(REFINED_IMAGES, INC_BLOBS, REFINED_ARC, (1.0 + REFINED_FOCAL_OFFSET) * INC_FOCAL)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from sfm_tpu_torch import kernels

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} | torch {torch.__version__} cuda {torch.version.cuda} | {smi}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off (sfm_tpu_torch/__init__.py)")

    kernels.library()
    log(f"[build] kernels built and loaded in {kernels.build_seconds:.2f}s")

    phase_s = {}
    with prefetch_renders(prefetched_scenes()):
        t0 = time.perf_counter()
        config4_rows, config4_launches = phase_config4(device)
        phase_s["config4"] = time.perf_counter() - t0
        record = phases(device, config4_rows, config4_launches, phase_s)
    log("[time] phase seconds " + json.dumps(phase_s))
    log(f"[done] chip_smoke wall {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phases(device, config4_rows: dict, config4_launches: dict, phase_s: dict) -> dict:
    """Phases 1-13 after phase 14 (main), then the kernels' record with
    phase 14's rows and launches merged in; each phase's wall seconds go
    into phase_s."""
    last = [time.perf_counter()]

    def mark(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = now - last[0]
        last[0] = now

    k2_first, k2_shapes = check_match(device, 4096)
    results = {"dog_extrema_scores": check_dog(device, SLICE_IMAGE), "match_topk2": k2_first}
    log_results("features", results)
    log_shapes("match_topk2", k2_shapes)

    rec, launches, ba_log, wall, scene = run_slice(device, SLICE_IMAGE, SLICE_BLOBS)
    log(f"[slice] reconstruct wall {wall:.2f}s | stages " +
        ", ".join(f"{k} {v:.3f}s" for k, v in rec.stage_seconds.items()))
    log(f"[slice] summary {json.dumps(rec.summary())}")
    log(f"[slice] launches {json.dumps(launches)}")
    log("[slice] relative pose error vs ground truth: %.4f deg rotation, %.4f deg translation"
        % pose_errors_deg(rec, scene))
    check_slice(rec, launches, scene)
    two_view_launches = launches
    log_results("two-view BA", {**check_ba(ba_log[-1]["problem"], ba_log[-1]["cfg"], device, "two-view BA"),
                                **check_k9(ba_log[-1]["problem"], ba_log[-1]["cfg"], device)})
    mark("kernels_two_view")

    t0 = time.perf_counter()
    ring, scene = render_ring(INC_IMAGES, INC_BLOBS, INC_ARC)
    log(f"[incremental] rendered {INC_IMAGES} x {SLICE_IMAGE}^2 images with {INC_BLOBS} blobs "
        f"(ring arc {INC_ARC}, focal {INC_FOCAL}, radius {INC_RADIUS}) in {time.perf_counter() - t0:.2f}s")
    with record_match_shapes() as match_shapes, record_dog_stacks() as dog_stacks:
        rec, launches, ba_log, _, wall = run_reconstruct(device, ring)
    log(f"[incremental] reconstruct wall {wall:.2f}s | stages " +
        ", ".join(f"{k} {v:.3f}s" for k, v in rec.stage_seconds.items()))
    log_bundle_adjustments("incremental", ba_log)
    log(f"[incremental] summary {json.dumps(rec.summary())}")
    log(f"[incremental] launches {json.dumps(launches)}")
    rmse = check_incremental(rec, launches, ba_log, scene)
    log(f"[incremental] camera-centre RMSE after Sim(3) alignment {rmse:.5f} "
        f"({100 * rmse / INC_RADIUS:.3f}% of the orbit radius)")
    inc_rec, inc_cfg = rec, ba_log[-1]["cfg"]   # phase 11 refines this model's final BA

    # The BA kernels are held and timed on the incremental slice's final
    # global BA problem (PCG), as that run handed it to bundle_adjust; K7 and
    # K11 once more on an orbit problem whose points each lie in ~100 views.
    final = ba_log[-1]
    incremental = {**check_ba(final["problem"], final["cfg"], device, "final global BA"),
                   **check_k9(final["problem"], final["cfg"], device),
                   **check_schur(final["problem"], final["cfg"], device)}
    log_results("final global BA", incremental)
    results.update(incremental)
    local = next(b for b in reversed(ba_log) if b["solver"] == "dense")
    log_results("last dense local BA", check_ba(local["problem"], local["cfg"], device, "last dense local BA"))
    # K3 and K5 beside the chains they replace, and the LM iteration's launches.
    lm = lm_report(final["problem"], final["cfg"], device, stand_in=True)
    log(f"[lm] final global BA (C={final['C']}, O={final['O']}): " + json.dumps(
        {**lm, "bounds_ms": {k: results[k]["bound_ms"] for k in ("fused_ne_payloads", "fused_cost_sums")}}))
    orbit = schur_problem(device)
    log_results("orbit", check_schur(orbit, final["cfg"], device))
    # The fused PCG solve on the same two problems, once more on the orbit
    # problem with W read from device memory every step; then on a wide orbit
    # whose cameras outnumber the grid (several cameras per block, and on a
    # grid of 8 blocks several lane-group passes per camera phase).
    pcg_rows = [check_pcg(final["problem"], final["cfg"], device, "final global BA"),
                check_pcg(orbit, final["cfg"], device, "orbit"),
                check_pcg(orbit, final["cfg"], device, "orbit", streaming=True)]
    del orbit
    wide = schur_problem(device, WIDE_CAMERAS, WIDE_POINTS)
    pcg_rows += [check_pcg(wide, final["cfg"], device, "wide orbit"),
                 check_pcg(wide, final["cfg"], device, "wide orbit", streaming=True),
                 check_pcg(wide, final["cfg"], device, "wide orbit", blocks=WIDE_BLOCKS)]
    for row in pcg_rows:
        log_results("", {"pcg_solve": row})
    results["pcg_solve"] = dict(pcg_rows[0])
    del wide
    # K2 once more at the shapes this run handed it (full and ragged blocks
    # of pairs at the run's keypoint bucket).
    done = {r["shape"] for r in k2_shapes}
    path_k2 = [check_match_shape(device, shape) for shape in sorted(set(match_shapes))
               if "%d x %d x %d" % shape not in done]
    log(f"[incremental] match_topk2 was handed {sorted(set(match_shapes))} (pairs, n1, n2)")
    log_shapes("match_topk2", path_k2)
    k2_shapes += path_k2
    # K1 at every shape the feature stage handed it (each octave of full and
    # last chunks), on the stacks it was handed; the feature stage with and
    # without K1 on one chunk.
    log("[incremental] dog_extrema_scores was handed " + json.dumps(
        {"x".join(map(str, k)): v["calls"] for k, v in dog_stacks.items()}) + " (shape: calls)")
    path_k1 = check_dog_path(device, dog_stacks)
    del dog_stacks
    log_shapes("dog_extrema_scores", path_k1)
    results["dog_extrema_scores"]["shapes"] = [dict(results["dog_extrema_scores"])] + path_k1
    images, sift_cfg, valid_hw = ring_chunk(device, ring)
    n_kp = check_features_route(images, sift_cfg, valid_hw)
    log(f"[features] {SLICE_IMAGE}^2 chunk of {images.shape[0]}: identical Features with use_pallas "
        f"True and False ({n_kp} valid keypoints)")
    k12_rows = check_descriptors(device, images, sift_cfg, valid_hw)
    log_shapes("sift_descriptors", k12_rows)
    log("[descriptors] K12 one launch per octave call, max abs gap to the plain version "
        f"{max(r['max_abs_err'] for r in k12_rows):.3e} (bar {DESC_GAP}); device us per call "
        + ", ".join(f"{r['shape']}: {1e3 * r['device_ms']:.1f} (bound {1e3 * r['bound_ms']:.1f})"
                    for r in k12_rows if r["device_ms"] is not None)
        + "; untimed " + ", ".join(f"{what}: {gap:.3e}" for what, gap in k12_rows[0]["untimed"]))
    results["sift_descriptors"] = dict(k12_rows[0], note="one launch per octave call", shapes=k12_rows)
    k13_rows = check_blur(device, images)
    log_shapes("blur_levels", k13_rows)
    log("[blur] K13 one launch per octave call, max abs gap to the plain version "
        f"{max(r['max_abs_err'] for r in k13_rows):.3e} (bar {BLUR_GAP}), bit-exact in "
        f"{sum(r['exact'] for r in k13_rows)} of {len(k13_rows)} calls; device us per call (bound us, "
        "library ms) " + ", ".join(
            f"{r['shape']}: {1e3 * r['device_ms']:.1f} ({1e3 * r['bound_ms']:.1f}, {r['library_ms']:.3f})"
            for r in k13_rows if r["device_ms"] is not None))
    results["blur_levels"] = dict(k13_rows[0], note="one launch per octave call", shapes=k13_rows)
    k14_rows = check_refine(device, images, sift_cfg, valid_hw, ring)
    log_shapes("subpixel_refine", k14_rows)
    log("[refine] K14 one launch per octave call; candidates that differ from the plain version (valid, "
        f"> {REFINE_POS_GAP} px / level, > {REFINE_REL_GAP} relative; at most {REFINE_FLIPS} of the live ones) "
        + ", ".join(f"{r['shape']}: {r['differ']} of {r['live']} live ({r['identical']} of {r['candidates']} "
                    f"identical)" for r in k14_rows)
        + f"; largest gaps of the rest {max(r['pos_gap'] for r in k14_rows):.3e} px / level, "
        f"{max(r['rel_gap'] for r in k14_rows):.3e} relative; device us per call (bound us, plain ms) "
        + ", ".join(f"{r['shape']}: {1e3 * r['device_ms']:.1f} ({1e3 * r['bound_ms']:.1f}, {r['plain_ms']:.3f})"
                    for r in k14_rows if r["device_ms"] is not None))
    results["subpixel_refine"] = dict(k14_rows[0], note="one launch per octave call", shapes=k14_rows)
    k15_rows = check_select(device, images, sift_cfg, valid_hw, ring)
    log_shapes("select_keys", k15_rows)
    log(f"[select] K15 one launch per octave call; selection equal to top_k_stable's and keys to the plain "
        f"version's in all {len(k15_rows)} calls (fewest positives a map "
        + ", ".join(f"{r['shape']}: {r['positives']}" for r in k15_rows)
        + "); device us per call (bound us, plain ms, full sort ms) "
        + ", ".join(f"{r['shape']}: {1e3 * r['device_ms']:.1f} ({1e3 * r['bound_ms']:.1f}, {r['plain_ms']:.3f}, "
                    f"{r['library_ms']:.3f})" for r in k15_rows if r["device_ms"] is not None))
    results["select_keys"] = dict(k15_rows[0], note="one launch per octave call", shapes=k15_rows)
    del images, valid_hw
    mark("incremental")
    paths = {"two_view": two_view_launches, "incremental": launches}
    ring_ba = (final["problem"], final["cfg"], inc_rec)   # phase 12 shards this BA
    del ba_log, final

    # Divide and conquer on the same views: clusters reconstructed by the
    # incremental engine, merged, rescued, polished.
    rec, launches, ba_log, merges, wall = run_reconstruct(
        device, ring, **{"partition.enabled": True, "partition.target_cluster_size": PART_CLUSTER,
                         "partition.overlap_cameras": PART_OVERLAP})
    log(f"[partition] reconstruct wall {wall:.2f}s | stages " +
        ", ".join(f"{k} {v:.3f}s" for k, v in rec.stage_seconds.items()))
    log(f"[partition] {len(ba_log)} BAs, {sum(b['solver'] == 'pcg' for b in ba_log)} by PCG; "
        f"clusters merged: {merges}; the last:")
    log_bundle_adjustments("partition", ba_log[-1:])
    log(f"[partition] summary {json.dumps(rec.summary())}")
    log(f"[partition] launches {json.dumps(launches)}")
    rmse = check_partition(rec, launches, ba_log, merges, scene)
    log(f"[partition] camera-centre RMSE after Sim(3) alignment {rmse:.5f} "
        f"({100 * rmse / INC_RADIUS:.3f}% of the orbit radius)")
    paths["partition"] = launches
    first_polish = next(b for b in ba_log if b["solver"] == "pcg" and b["C"] >= 0.95 * len(rec.registered))
    pcg_rows.append(check_pcg(first_polish["problem"], first_polish["cfg"], device, "first merged polish",
                              x_steps=PCG_X_STEPS))
    log_results("", {"pcg_solve": pcg_rows[-1]})
    results["pcg_solve"]["shapes"] = pcg_rows
    del ba_log, first_polish
    mark("partition")

    # The global engine on the first views of the ring.
    rec, launches, ba_log, _, wall = run_reconstruct(device, ring[:GLOBAL_IMAGES], engine_mode="global")
    log(f"[global] reconstruct of {GLOBAL_IMAGES} views wall {wall:.2f}s | stages " +
        ", ".join(f"{k} {v:.3f}s" for k, v in rec.stage_seconds.items()))
    log_bundle_adjustments("global", ba_log)
    log(f"[global] summary {json.dumps(rec.summary())}")
    log(f"[global] launches {json.dumps(launches)}")
    rmse = check_global(rec, launches, scene, INC_RADIUS)
    log(f"[global] camera-centre RMSE after Sim(3) alignment {rmse:.5f} "
        f"({100 * rmse / INC_RADIUS:.3f}% of the orbit radius)")
    paths["global"] = launches
    del ba_log, ring
    mark("global")

    # Config #3 from files: the incremental ring's scene at 96 views as PGM
    # files through the CLI with vocab-tree pairs and densify; then the same
    # command again, which must resume every stage from the artifacts.
    workdir = tempfile.mkdtemp(prefix="chip_smoke_vocab_")
    try:
        run = run_vocab(workdir, images=VOCAB_SMOKE_IMAGES)
        rec = run["rec"]
        log(f"[vocab] reconstruct (cli) wall {run['wall']:.2f}s | stages " +
            ", ".join(f"{k} {v:.3f}s" for k, v in rec.stage_seconds.items()))
        log_bundle_adjustments("vocab", run["ba_log"][-1:])
        rmse, read_back = check_vocab(run)
        resume_wall = rerun_vocab(run)
        idle = vocab_idle(device, run["out"])
        s = rec.summary()
        log("[vocab] " + json.dumps({
            "images": run["images"], "stage_s": rec.stage_seconds,
            "vocab_build_s": run["build_s"], "vocab_quantize_score_s": run["vocab_s"] - run["build_s"],
            "candidate_pairs": run["candidate_pairs"], "exhaustive_pairs": run["images"] * (run["images"] - 1) // 2,
            "verified_before_densify": run["verified_before_densify"],
            "ladder_candidates": run.get("ladder_candidates", 0), "ladder_pairs_added": run["ladder_pairs_added"],
            "verified_edges": run["verified_edges"], "artifact_save_s": run["artifact_save_s"],
            "registered": s["num_registered"],
            "points": s["num_points"], "mean_reproj_px": s["mean_reproj_error_px"],
            "camera_rmse": rmse, "camera_rmse_pct_radius": 100 * rmse / INC_RADIUS,
            "colmap_bin_read_back": dict(zip(("cameras", "images", "points"), read_back)),
            "wall_s": run["wall"], "resume_wall_s": resume_wall, "idle": idle,
            "launches": run["launches"]}))
        paths["vocab"] = run["launches"]
        del run, rec
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    mark("vocab")

    # The off-by-default paths on the two-view slice's views: first-octave
    # upsampling (K1 on the 2048^2 octave), guided matching, F-RANSAC.
    rec, launches, wall, scene, k1_options, k1_noise = run_options(device)
    log(f"[options] reconstruct wall {wall:.2f}s | stages " +
        ", ".join(f"{k} {v:.3f}s" for k, v in rec.stage_seconds.items()))
    log(f"[options] {json.dumps(OPTIONS)} summary {json.dumps(rec.summary())}")
    log(f"[options] launches {json.dumps(launches)}")
    log("[options] relative pose error vs ground truth: %.4f deg rotation, %.4f deg translation"
        % pose_errors_deg(rec, scene))
    log_shapes("dog_extrema_scores", k1_options)
    log(f"[options] dog_extrema_scores bit-exact on the upsampled {k1_noise['shape']} octave "
        f"({k1_noise['extrema']} extrema)")
    results["dog_extrema_scores"]["shapes"] += [{**r, "shape": "options " + r["shape"]} for r in k1_options]
    paths["options"] = launches
    mark("options")

    # The merged-model polish at full width, then the large-camera-count
    # kernels on its first solve's problem, each beside its small-C twin.
    polish = run_polish(device)
    dropped_out, dropped_in = check_polish(polish)
    log(f"[polish] dropped {100 * dropped_out:.2f}% of the gross outliers and "
        f"{100 * dropped_in:.3f}% of the other observations")
    paths["merged_polish"] = polish["launches"]
    first = polish["ba_log"][0]
    big, twins, k9_big = check_big(first["problem"], first["cfg"], device)
    log_results("merged polish", big)
    log_shapes("cam_segment_sum", k9_big)
    results.update(big)
    # The polish's CG solve in one launch (K10's code inside) beside the
    # loop over K10 and K9 it replaced, and the polish's LM iteration.
    results["pcg_solve_big"] = check_pcg(first["problem"], first["cfg"], device, "merged polish",
                                         x_steps=PCG_X_STEPS)
    log_results("", {"pcg_solve_big": results["pcg_solve_big"]})
    lm_big = lm_report(first["problem"], first["cfg"], device)
    log(f"[lm] merged polish, first solve (C={first['C']}, O={first['O']}): {json.dumps(lm_big)}")
    results["match_topk2"]["shapes"] = k2_shapes
    results["cam_segment_sum"]["shapes"] = results["cam_segment_sum"]["shapes"] + k9_big
    log(f"[kernel] twins on the merged polish's problem (ms): {json.dumps(twins)}")
    polish_ba = (first["problem"], first["cfg"])   # phase 12 shards this BA
    refined_model = (polish["model"], polish["truth"])   # phase 13 refines this model
    del polish, first
    mark("merged_polish")

    # Intrinsics refinement at full width, the only path of 8-wide camera
    # blocks: the 8-wide builds on the incremental slice's final global BA
    # problem, the refined BA that recovers a 4% focal error on it, and a
    # reconstruction whose focal prior is off.
    wide, k9_wide = check_refined_kernels(inc_rec, inc_cfg, device)
    log_results("refined global BA", wide)
    log_shapes("cam_segment_sum", k9_wide)
    results.update(wide)
    results["cam_segment_sum"]["shapes"] += k9_wide
    refined_ba = run_refined_ba(inc_rec, inc_cfg, device, INC_FOCAL, recover=False)
    log("[refined] ring BA from focal " + f"{REFINED_BA_FOCAL * INC_FOCAL:g} (rendered {INC_FOCAL:g}), k1 0: "
        + json.dumps(refined_ba))
    paths["refined_ba"] = refined_ba["launches"]
    orbit_ba = run_refined_ba(orbit_reconstruction(*REFINED_ORBIT, outliers=0.0), inc_cfg, device,
                              SLICE_FOCAL, recover=True)
    log("[refined] orbit BA from focal " + f"{REFINED_BA_FOCAL * SLICE_FOCAL:g} (rendered {SLICE_FOCAL:g}), "
        "k1 0: " + json.dumps(orbit_ba))
    paths["refined_orbit_ba"] = orbit_ba["launches"]
    refined = run_refined_reconstruct(device)
    rr = check_refined_reconstruct(refined)
    log_bundle_adjustments("refined", refined["ba_log"])
    log(f"[refined] {REFINED_IMAGES} views rendered at focal {refined['focal']:g} in "
        f"{refined['render_s']:.2f}s, prior {INC_FOCAL:g}: " + json.dumps(rr))
    log(f"[refined] launches {json.dumps(refined['launches'])}")
    if rr["failed"]:
        raise AssertionError(f"refined reconstruction: {rr['failed']} off: {rr}")
    paths["refined"] = refined["launches"]
    ring_views = refined["imgs"]
    del refined, inc_rec
    mark("refined")

    # The refined polish (phase 13, before phase 12, which shards its
    # problem): phase 8's merged model from a focal 4% off through the
    # engine's global BA with focal and k1 refined, the 8-wide large-camera
    # kernels on its problem, each beside its 6-wide twin of phase 8.
    t0 = time.perf_counter()
    rp = run_refined_polish(*refined_model, device)
    del refined_model
    log("[refined polish] (a) " + json.dumps(rp["readings"]))
    check_refined_polish(rp["readings"])
    paths["refined_polish"] = rp["readings"]["launches"]
    big8, twins8, k9_big8 = check_big(rp["problem"], rp["cfg"], device)
    log_results("refined polish", big8)
    log_shapes("cam_segment_sum", k9_big8)
    results.update(big8)
    results["cam_segment_sum"]["shapes"] += k9_big8
    results["pcg_solve_big_w8"] = check_pcg(rp["problem"], rp["cfg"], device, "refined polish",
                                            x_steps=PCG_X_STEPS)
    log_results("", {"pcg_solve_big_w8": results["pcg_solve_big_w8"]})
    log(f"[kernel] twins on the refined polish's problem (ms): {json.dumps(twins8)}")
    log("[refined polish] (b) 8 wide beside 6 wide (kernel ms, device ms): " + json.dumps(
        {k: {w: [results[k + s][f] for f in ("ms", "device_ms")] for w, s in (("6", ""), ("8", "_w8"))}
         for k in BIG_KERNELS}))
    refined_polish_ba = (rp["problem"], rp["cfg"])   # phase 12 shards this BA too
    del rp
    log(f"[refined polish] phase 13 (a), (b) wall {time.perf_counter() - t0:.2f}s")
    mark("refined_polish")

    # Several devices: the multi-device routes in a one-process NCCL group
    # on the card, each against the single-card route.
    t0 = time.perf_counter()
    sharded = run_sharded(ring_views, ring_ba, polish_ba, device, refined_polish_ba)
    del ring_views, ring_ba, polish_ba, refined_polish_ba
    log_results("sharded BA", sharded["results"])
    for k in SHARDED_KERNELS:
        log_shapes(k, sharded["results"][k]["shapes"])
    results.update(sharded["results"])
    paths["sharded"] = sharded["launches"]
    log(f"[dist] phase 12 wall {time.perf_counter() - t0:.2f}s; launches {json.dumps(sharded['launches'])}")
    mark("sharded")
    paths["config4"] = config4_launches
    for k, v in config4_rows.items():
        results[k]["shapes"] = results[k].get("shapes", [dict(results[k])]) + v
    log("[lm] launches by path: " + json.dumps(
        {k: {name: p.get(k, 0) for name, p in paths.items()}
         for k in ("dog_extrema_scores", "match_topk2", "fused_ne_payloads", "fused_cost_sums", "whw_cam_reduce",
                   "pcg_solve", "pcg_solve_big") + WIDE_KERNELS + SHARDED_KERNELS + SHARDED_WIDE
         + BIG_WIDE_KERNELS}))

    # K10's and K11's rows count the launches that run their code (INSIDE).
    by_path = {k: {name: p.get(INSIDE.get(k, k), 0) for name, p in paths.items()} for k in KERNELS}
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
         "launches": max(by_path[k].values()),
         "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"], "bound_by": results[k]["bound_by"],
         "library_ms": results[k]["library_ms"],
         **{f: results[k][f] for f in ("loop_ms", "loop_device_ms", "device_ms", "k3_ms", "k3_device_ms")
            if f in results[k]},
         "launches_by_path": by_path[k],
         **({"shapes": [{f: r[f] for f in SHAPE_FIELDS + PCG_FIELDS if f in r}
                        for r in results[k]["shapes"]]}
            if "shapes" in results[k] else {})}
        for k in KERNELS]}
    never = [k["name"] for k in record["kernels"] if k["launches"] == 0]
    if never:
        raise AssertionError(f"kernels launched by no path: {never}")
    # K1, K13, K14 and K15 each launch once per octave call of the feature stage.
    octave_kernels = ("dog_extrema_scores", "blur_levels", "subpixel_refine", "select_keys")
    octave_off = {name: [p.get(k, 0) for k in octave_kernels] for name, p in paths.items()
                  if len({p.get(k, 0) for k in octave_kernels}) > 1}
    if octave_off:
        raise AssertionError(f"launches of {octave_kernels} differ (octave calls): {octave_off}")
    log(f"[profile] {TRACE_SESSIONS['short']} of {TRACE_SESSIONS['all']} traced sessions recorded fewer "
        f"device launches than another session of the same calls ({TRACE_SESSIONS['empty']} none); they "
        f"missed {TRACE_SESSIONS['missing']} of the {TRACE_SESSIONS['launches']} launches that the fullest "
        f"session of each measurement implies")
    return record


if __name__ == "__main__":
    sys.exit(main())
