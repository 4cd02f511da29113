"""Bundle adjustment (port of sfm_tpu/ba): Schur-complement LM with the
normal equations kept in segment-sum form, built by kernels K3 and K9, and
the robust cost by kernel K5."""

from sfm_tpu_torch.ba.core import ba_cost, bundle_adjust  # noqa: F401
from sfm_tpu_torch.ba.problem import BAProblem, build_problem, writeback  # noqa: F401


def dispatch_bundle_adjust(prob, cfg):
    """Route one BA solve to the single-device or the camera-sharded path.

    cfg is the full PipelineConfig: when cfg.shard asks for multi-device BA
    (shard.num_devices > 1 and shard.shard_ba), the observations are
    balanced across the process group by camera and the LM runs with
    all-reduce-completed normal equations; otherwise the single-device LM
    runs. Returns (problem, stats) with the parameters the same on every
    process. Divergence: without a process group of shard.num_devices
    processes this raises a ValueError (dist.mesh.make_mesh), where sfm_tpu
    falls back to one chip."""
    shard = cfg.shard
    if shard.num_devices > 1 and shard.shard_ba:
        from sfm_tpu_torch.dist.mesh import make_mesh
        from sfm_tpu_torch.dist.sharded_ba import bundle_adjust_sharded, shard_problem_by_camera

        mesh = make_mesh(shard.num_devices, prob.cam_params.device)
        return bundle_adjust_sharded(shard_problem_by_camera(prob, mesh.size), cfg.ba, mesh)
    return bundle_adjust(prob, cfg.ba)
