"""Bundle adjustment (port of sfm_tpu/ba): Schur-complement LM with the
normal equations kept in segment-sum form, built by kernels K3 and K9, and
the robust cost by kernel K5."""

from sfm_tpu_torch.ba.core import bundle_adjust  # noqa: F401
from sfm_tpu_torch.ba.problem import BAProblem, build_problem, writeback  # noqa: F401


def dispatch_bundle_adjust(prob, cfg):
    """One BA solve on the problem's device. cfg is the full PipelineConfig;
    the camera-sharded multi-device path is not ported yet."""
    if cfg.shard.num_devices > 1 and cfg.shard.shard_ba:
        raise NotImplementedError(
            "shard.num_devices > 1 (sharded BA) is not ported yet (ROADMAP.md queue 1 item 6: dist/)")
    return bundle_adjust(prob, cfg.ba)
