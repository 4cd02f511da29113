"""Configuration system: nested frozen dataclasses.

The same dataclasses, field names and defaults as sfm_tpu/config.py, so a
``config_to_dict`` from one package loads in the other. ``use_pallas`` keeps
its name for that reason; in this package it means "use the hand-written
kernel": True takes the kernel wrapper (the CUDA kernel for tensors on the
GPU, its plain PyTorch version for tensors on the CPU), False the plain
reference path of the stage.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class SiftConfig:
    """SIFT-style feature extraction (SURVEY.md §2.2)."""

    num_octaves: int = 4
    scales_per_octave: int = 3          # s; each octave has s+3 gaussian levels
    sigma0: float = 1.6                 # base blur of octave level 0
    assumed_blur: float = 0.5           # blur of the raw input image
    upsample_first_octave: bool = False # 2x upsampled octave -1
    contrast_threshold: float = 0.04    # DoG peak threshold (Lowe), scaled by s
    edge_threshold: float = 10.0        # Hessian eigenvalue ratio r
    max_keypoints: int = 4096           # static keypoint budget per image
    max_candidates: int = 16384         # static extremum-candidate budget
    desc_per_octave: int = 1024         # candidates kept per octave for
                                        # orientation/descriptor compute
    refine_iters: int = 3               # subpixel quadratic-fit iterations
    num_orientation_bins: int = 36
    orientation_peak_ratio: float = 0.8
    multi_orientation: bool = True      # duplicate keypoints at secondary peaks
    descriptor_patch_radius: int = 8    # half-width of sampling lattice (4x4 cells)
    root_sift: bool = False
    image_max_dim: int = 1024           # resize cap on the long side
    use_pallas: bool = True             # hand-written DoG/extrema kernel (K1)


@dataclass(frozen=True)
class MatchConfig:
    """Pairwise descriptor matching (SURVEY.md §2.3)."""

    ratio_threshold: float = 0.8        # Lowe ratio test on L2 distances
    mutual_check: bool = True           # cross-check both directions
    max_matches: int = 2048             # static per-pair correspondence budget
    min_matches: int = 16               # pairs below this are dropped
    block_pairs: int = 32               # pairs per device batch
    use_bf16_matmul: bool = True        # descriptors in bf16 on the MXU
    use_pallas: bool = True             # hand-written match+top2 kernel (K2)
    guided: bool = False                # epipolar-gated re-match after verification
    guided_ratio: float = 0.9           # relaxed ratio inside the epipolar band
    guided_band_px: float = 3.0         # epipolar gate half-width
    # Match-graph densification (pruned pair modes only): propose candidate
    # pairs along a power-of-2 GRAPH-DISTANCE ladder over the verified graph
    # and verify them. Vocab-tree top-k retrieval spends its whole budget on
    # nearest neighbors (10k-orbit ladder: every verified edge within +-8
    # ring images -> ~1250 relative-pose hops around the loop -> an
    # unremovable low-frequency bend, RMSE 30% of orbit radius); the ladder
    # probes the graph's own connectivity outward, capture-order-free, and
    # recovered edges out to +-400 images (25 hops) on the same scene.
    densify_scales: int = 8             # ladder depth (2^1..2^scales hops); 0 off
    densify_per_node: int = 2           # frontier samples per node per scale


@dataclass(frozen=True)
class VocabConfig:
    """Vocabulary-tree pair pruning (SURVEY.md §2.3)."""

    branching: int = 8
    depth: int = 4
    num_neighbors: int = 20             # candidate pairs retained per image
    kmeans_iters: int = 8
    training_desc_per_image: int = 256
    retrieval_spread_scales: int = 8    # stratified top-k: half the neighbor
                                        # budget takes the top similarity
                                        # ranks, the rest spreads
                                        # geometrically over ranks up to
                                        # ~(k/2)·2^scales. Pure nearest-rank
                                        # retrieval (0 = off) starves large
                                        # sequential captures of long-range
                                        # edges — at 10k images every
                                        # verified edge landed within ±8 ring
                                        # neighbors and the pose chain drifted
                                        # (NOTES.md round-3 root cause #3);
                                        # band tops reach far-but-overlapping
                                        # views at the SAME pair budget.


@dataclass(frozen=True)
class RansacConfig:
    """Batched fixed-size RANSAC (SURVEY.md §2.4, §7 hard part 4)."""

    num_hypotheses: int = 1024          # static hypothesis batch (replaces adaptive loop)
    error_threshold_px: float = 4.0     # Sampson / reprojection error gate
    min_inliers: int = 15               # edges below this are rejected
    confidence: float = 0.9999          # documents the sizing of num_hypotheses
    refine_iters: int = 5               # Gauss-Newton polish on inliers
    degenerate_h_ratio: float = 0.8     # H-inliers/E-inliers at/above this =>
                                        # planar-degenerate (COLMAP-class gate)
    model: str = "essential"            # "essential" (calibrated) | "fundamental"
                                        # (uncalibrated: F-RANSAC in pixels, pose
                                        # upgraded through the focal prior)


@dataclass(frozen=True)
class BAConfig:
    """Schur-complement Levenberg-Marquardt bundle adjustment (SURVEY.md §2.6)."""

    max_iterations: int = 50
    initial_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 2.0
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    function_tolerance: float = 1e-8    # relative cost decrease convergence test
    cg_iterations: int = 64             # PCG steps on the reduced camera system
    cg_tolerance: float = 1e-6
    dense_schur_max_cameras: int = 384  # below this, dense Cholesky on S
    refine_focal: bool = False
    refine_distortion: bool = False
    robust_loss: str = "huber"          # "none" | "huber" | "cauchy"
    robust_scale_px: float = 4.0


@dataclass(frozen=True)
class EngineConfig:
    """Incremental reconstruction engine (SURVEY.md §2.5)."""

    init_min_inliers: int = 60
    init_max_h_ratio: float = 0.85      # initial pair must not be homography-degenerate
    init_candidates: int = 16           # ranked bootstrap edges tried before giving up
    abs_pose_min_inliers: int = 12
    abs_pose_error_px: float = 8.0
    min_triangulation_angle_deg: float = 1.5
    # Bootstrap-only parallax floor. On dense (video-like) capture EVERY
    # nearby pair sits below the map-quality triangulation gate; the seed
    # pair only needs enough parallax to be distinguishable from a pure
    # rotation (a few times the noise-level apparent parallax) — map quality
    # then comes from multi-view tracks spanning wide baselines. Gating the
    # seed at the full angle rejects honest poses and selects for wrongly
    # estimated ones whose error inflates apparent parallax.
    init_min_triangulation_angle_deg: float = 0.3
    max_reprojection_error_px: float = 6.0
    local_ba_window: int = 8            # most recent cameras optimized in local BA
    local_ba_max_cameras: int = 64      # window + top co-observing cameras in the local problem
    global_ba_every: int = 10           # global BA at least every k registrations...
    global_ba_growth: float = 1.25      # ...stretched to every 25% model growth at scale
                                        # (COLMAP-style geometric schedule)
    max_images: int = 4096              # static capacity of the scene state
    max_points: int = 262144
    max_observations: int = 1048576
    filter_every: int = 1
    retriangulate_every: int = 10
    checkpoint_every: int = 25          # SceneState snapshots (SURVEY.md §5.3)
    # Global engine (engine_mode="global", SURVEY.md §0.1[K]): track
    # fuse -> reposition -> retriangulate -> BA rounds after the first
    # polish. Fragmented union-find tracks carry no long-range constraint;
    # these rounds consolidate them and re-solve centers+points against the
    # longer tracks (pipeline/global_engine.py).
    global_refine_rounds: int = 3
    # Geometric track SPLITTING inside the consolidation rounds (0 disables):
    # observations breaking consensus with their track's current point by
    # more than this many px detach into new candidate points instead of
    # being dropped. The round-4 study measured ~54% of union-find tracks
    # gluing fragments of DIFFERENT physical points (no conflict evidence
    # exists at union time); only geometry can separate them, and with
    # clean tracks the same polish reaches 0.27% vs 1.58% center RMSE
    # (NOTES.md round-4).
    split_tracks_px: float = 4.0


@dataclass(frozen=True)
class ShardConfig:
    """Multi-device execution (SURVEY.md §2.7, §5.7-5.8). Kept for config
    compatibility with sfm_tpu; the port runs one device and refuses
    num_devices > 1 and multihost until dist/ is ported."""

    num_devices: int = 1                # 1 => single-chip, no collectives
    mesh_axis: str = "shard"
    ring_matching: bool = True          # ppermute descriptor-shard ring for all-pairs
    shard_ba: bool = True               # camera-block-sharded BA with psum reductions

    # Multi-host (SURVEY.md §5.8): one process per host; this block only
    # controls the runtime handshake (coordinator address, process count and
    # rank, e.g. shard.coordinator_address=10.0.0.1:8476
    # shard.num_processes=4 shard.process_id=$SLURM_PROCID).
    multihost: bool = False             # join a multi-process group at startup
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None


@dataclass(frozen=True)
class PartitionConfig:
    """Divide-and-conquer at pod scale (SURVEY.md §2.7)."""

    enabled: bool = False
    target_cluster_size: int = 250
    overlap_cameras: int = 10           # boundary cameras duplicated between clusters
    merge_global_ba: bool = True
    parallel_clusters: int = 1          # threaded per-cluster dispatch (EP analog)
    merge_tracks_min_votes: int = 2     # cross-cluster track consolidation:
                                        # correspondence votes required to fuse
                                        # two merged points (0 disables)
    merge_tracks_dist_frac: float = 0.15  # ... and max 3D separation as a
                                          # fraction of the RMS scene scale.
                                          # Adjacent-arc duplicate copies sit
                                          # at 2-7% on a bent pre-polish
                                          # model (10k postmortem); the old
                                          # 0.05 gate blocked exactly the
                                          # boundary fusions that carry
                                          # long-range rigidity. >=2 votes
                                          # from geometrically verified
                                          # edges carry the discrimination;
                                          # BA->filter->BA cleans the rare
                                          # false fusion.
    polish_ba_iterations: int = 40      # LM budget for the merged-model global
                                        # polish (0 = inherit ba.max_iterations);
                                        # the final unbend needs more iterations
                                        # than the incremental loop's solves and
                                        # exits early on convergence anyway
    refine_rounds: int = 8              # iterative global refinement: rounds of
                                        # proximity track-merge -> global BA
                                        # (COLMAP IterativeGlobalRefinement
                                        # analog; 0 disables). Stops early when
                                        # a round fuses no tracks.
    straighten_pose_graph: bool = True  # before the merged-model polish, replace
                                        # poses with rotation+translation-averaged
                                        # pose-graph poses (sim3-aligned) and
                                        # retriangulate — removes the low-frequency
                                        # cluster-chain bend that reprojection-only
                                        # BA cannot see (10k postmortem)
    id_merge: bool = True               # transitive-identity consolidation in the
                                        # refine rounds (merge_tracks_by_track_id):
                                        # fuse merged points whose observations
                                        # share a majority FULL-graph union-find
                                        # track id. Closes the cross-cluster
                                        # fragmentation that direct correspondence
                                        # votes cannot (single-digit voted pairs vs
                                        # ~15x-short tracks at 512, r5 study).
    id_merge_rel_factor: float = 4.0    # union-reprojection gate for id merges:
    id_merge_floor_px: float = 3.0      # generous relative to the proximity gate
    id_merge_max_px: float = 16.0       # — 2D identity evidence is strong; the
                                        # gate still rejects contaminated links
                                        # (512 study: 623/714 id pairs fail even
                                        # at 16px — those glue distinct blobs).
    id_merge_anneal: float = 0.75       # per-refine-round cap decay (graduated
    id_merge_min_px: float = 6.0        # non-convexity: permissive while bent,
                                        # tight once straightened; floor at the
                                        # proximity gate's cap).


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline configuration."""

    sift: SiftConfig = field(default_factory=SiftConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    vocab: VocabConfig = field(default_factory=VocabConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    shard: ShardConfig = field(default_factory=ShardConfig)
    partition: PartitionConfig = field(default_factory=PartitionConfig)
    pair_mode: str = "exhaustive"       # "exhaustive" | "vocab_tree"
    engine_mode: str = "incremental"    # "incremental" (register one image at
                                        # a time; robust default) | "global"
                                        # (rotation+translation averaging over
                                        # the whole pose graph, then one
                                        # batched triangulation + global BA —
                                        # a few device programs instead of
                                        # O(images) sequential PnP rounds)
    seed: int = 0
    artifact_dir: str | None = None     # stage artifacts + resume (SURVEY.md §5.4)
    profile_dir: str | None = None      # torch.profiler trace output per stage
    verbose: bool = True


def config_to_dict(cfg: Any) -> Any:
    """Recursively convert a (possibly nested) config dataclass to plain dicts."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    return cfg


def config_from_dict(cls: type, data: dict) -> Any:
    """Build a config dataclass from nested dicts (inverse of config_to_dict)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[f.name] = config_from_dict(f.type, v)
        elif isinstance(v, dict):
            sub = _FIELD_TYPES.get((cls, f.name))
            kwargs[f.name] = config_from_dict(sub, v) if sub else v
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_FIELD_TYPES = {
    (PipelineConfig, "sift"): SiftConfig,
    (PipelineConfig, "match"): MatchConfig,
    (PipelineConfig, "vocab"): VocabConfig,
    (PipelineConfig, "ransac"): RansacConfig,
    (PipelineConfig, "ba"): BAConfig,
    (PipelineConfig, "engine"): EngineConfig,
    (PipelineConfig, "shard"): ShardConfig,
    (PipelineConfig, "partition"): PartitionConfig,
}


def config_hash(cfg: Any) -> str:
    """Stable hash of a config — keys the stage-artifact cache (SURVEY.md §5.4)."""
    blob = json.dumps(config_to_dict(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# Which sub-configs each pipeline stage's output depends on. Artifact keys
# scoped this way mean an engine/BA/partition tweak does NOT invalidate the
# ~25-min feature stage or the match graph at 10k-image scale — iterating on
# the reconstruction resumes from "matches". Cosmetic fields (verbose,
# artifact_dir, profile_dir) and ShardConfig are excluded everywhere: the
# sharded paths are parity-tested equal to the single-device ones, so their
# artifacts are interchangeable.
_STAGE_CONFIG_SCOPE = {
    "features": ("sift",),
    "matches": ("sift", "match", "vocab", "ransac", "pair_mode", "seed"),
    "reconstruction": ("sift", "match", "vocab", "ransac", "ba", "engine",
                       "partition", "pair_mode", "engine_mode", "seed"),
}


def stage_config_hash(cfg: Any, stage: str) -> str:
    """Config hash restricted to the sub-configs `stage` actually consumes."""
    fields = _STAGE_CONFIG_SCOPE.get(stage, _STAGE_CONFIG_SCOPE["reconstruction"])
    d = config_to_dict(cfg)
    blob = json.dumps({k: d[k] for k in fields if k in d}, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def load_config(path: str, overrides: dict[str, Any] | None = None) -> PipelineConfig:
    """PipelineConfig from a YAML (or JSON) file + optional dotted overrides
    (SURVEY.md §5.6)."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml

        data = yaml.safe_load(text) or {}
    except ImportError:
        data = json.loads(text)
    cfg = config_from_dict(PipelineConfig, data)
    return apply_overrides(cfg, overrides) if overrides else cfg


def save_config(cfg: PipelineConfig, path: str) -> None:
    data = config_to_dict(cfg)
    try:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(data, f, sort_keys=False)
    except ImportError:
        with open(path, "w") as f:
            json.dump(data, f, indent=2)


def apply_overrides(cfg: PipelineConfig, overrides: dict[str, Any]) -> PipelineConfig:
    """Apply dotted-path overrides, e.g. {"sift.max_keypoints": 8192}."""
    data = config_to_dict(cfg)
    for key, value in overrides.items():
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key: {key}")
        node[parts[-1]] = value
    return config_from_dict(PipelineConfig, data)
