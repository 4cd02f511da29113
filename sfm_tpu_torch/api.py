"""Public API: image list in -> cameras, poses, points out."""

from __future__ import annotations

from typing import Sequence

import torch

from sfm_tpu_torch.config import PipelineConfig


def resolve_device(device) -> torch.device:
    """torch.device for the device stages; "cuda" without a visible GPU
    raises: nothing moves to the CPU silently. Under a launcher that sets
    LOCAL_RANK (torchrun: one process per card), "cuda" is cuda:LOCAL_RANK."""
    from sfm_tpu_torch.dist.mesh import local_device

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    return local_device(device)


def reconstruct(images: Sequence, config: PipelineConfig | None = None, device="cuda", **overrides):
    """Run the SfM pipeline (the port of sfm_tpu.reconstruct).

    Args:
      images: a directory path, a list of image file paths, or a list/array of
        grayscale float32 arrays.
      config: optional PipelineConfig; kwargs are dotted-path overrides
        (e.g. ``reconstruct(imgs, **{"sift.max_keypoints": 8192})``).
      device: torch device for the device stages. "cuda" without a visible
        GPU raises; nothing moves to the CPU silently.

    Returns:
      A ``Reconstruction`` (sfm_tpu_torch.scene.state) with per-image
      intrinsics, world->camera poses, the sparse point cloud and tracks.
    """
    from sfm_tpu_torch.config import apply_overrides
    from sfm_tpu_torch.pipeline.run import run_pipeline

    device = resolve_device(device)
    cfg = config or PipelineConfig()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return run_pipeline(images, cfg, device)
