"""dist.mesh: joining the process group, the Mesh record, the collectives'
helpers, run_pipeline's refusal of threaded clusters in a group, and the
divergence from sfm_tpu's fallback: shard.num_devices > 1
without a process group of that size raises a ValueError (sfm_tpu runs one
chip then), from make_mesh, dispatch_bundle_adjust and reconstruct alike.

A group made in this process is destroyed in the test that made it; the
two-process cases run on spawned gloo processes with their own time limit.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sfm_tpu_torch.config import PartitionConfig, PipelineConfig, ShardConfig
from sfm_tpu_torch.dist.launch import run_ranks
from sfm_tpu_torch.dist.mesh import (
    all_gather_rows, initialize_multihost, local_device, local_rank, make_mesh, mesh_for, ring_shift,
)

TIMEOUT = 60.0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tiny_problem():
    from sfm_tpu_torch.ba import build_problem
    from sfm_tpu_torch.scene.state import Reconstruction
    from sfm_tpu_torch.utils.synthetic import make_orbit_scene

    scene = make_orbit_scene(num_cameras=3, num_points=20, seed=0)
    obs = np.argwhere(scene.visible)
    rec = Reconstruction(
        intrinsics=scene.intrinsics.copy(), rvecs=scene.rvecs.copy(), tvecs=scene.tvecs.copy(),
        registered=np.ones(3, bool), points=scene.points.copy(), point_errors=np.zeros(20, np.float32),
        point_valid=np.ones(20, bool), obs_point=obs[:, 1].astype(np.int32), obs_image=obs[:, 0].astype(np.int32),
        obs_kp=obs[:, 1].astype(np.int32), obs_uv=scene.pixels[obs[:, 0], obs[:, 1]].astype(np.float32))
    return build_problem(rec, device="cpu")[0]


def test_num_devices_without_a_group_raises():
    import sfm_tpu_torch
    from sfm_tpu_torch.ba import dispatch_bundle_adjust
    from sfm_tpu_torch.utils.synthetic import render_blob_scene

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="process group"):
        mesh_for(ShardConfig(num_devices=2), "cpu")
    assert mesh_for(ShardConfig(num_devices=1), "cpu") is None
    with pytest.raises(ValueError, match="process group"):
        dispatch_bundle_adjust(tiny_problem(), PipelineConfig(shard=ShardConfig(num_devices=2)))
    imgs, _ = render_blob_scene(image_size=(64, 64), num_images=3, num_blobs=10)
    with pytest.raises(ValueError, match="process group"):
        sfm_tpu_torch.reconstruct(list(imgs), device="cpu", **{"shard.num_devices": 2})


def test_initialize_multihost_not_asked():
    assert initialize_multihost(ShardConfig(num_devices=2), "cpu") is False
    assert not dist.is_initialized()


def test_initialize_multihost_joins_once():
    cfg = ShardConfig(multihost=True, coordinator_address=f"localhost:{free_port()}", num_processes=1,
                      process_id=0)
    try:
        assert initialize_multihost(cfg, "cpu") is True
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        group = dist.group.WORLD
        assert initialize_multihost(cfg, "cpu") is True           # idempotent: no second init
        assert dist.group.WORLD is group
        mesh = make_mesh(1, "cpu")
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
        with pytest.raises(ValueError, match="2"):
            make_mesh(2, "cpu")
    finally:
        dist.destroy_process_group()


def test_local_rank_and_device(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert local_rank() == 3
    assert local_device("cpu") == torch.device("cpu")


def _group_worker(mesh):
    """In a group the launcher made: initialize_multihost accepts it, the
    mesh sees it, and the helpers move data as sfm_tpu's collectives do."""
    joined = initialize_multihost(ShardConfig(multihost=True, num_processes=7, process_id=5), "cpu")
    try:
        make_mesh(mesh.size + 1, "cpu")
        wrong_size = False
    except ValueError:
        wrong_size = True
    from sfm_tpu_torch.pipeline.run import run_pipeline

    try:
        cfg = PipelineConfig(shard=ShardConfig(num_devices=mesh.size),
                             partition=PartitionConfig(enabled=True, parallel_clusters=2))
        run_pipeline([], cfg, torch.device("cpu"))
        threads_refused = False
    except ValueError as e:
        threads_refused = "parallel_clusters" in str(e)
    t = torch.arange(3, dtype=torch.float32) + 10 * mesh.rank
    flags = torch.tensor([mesh.rank % 2 == 0, True])
    shifted, shifted_flags = ring_shift((t, flags), mesh)
    return dict(joined=joined, world=dist.get_world_size(), wrong_size=wrong_size, rank=mesh.rank,
                threads_refused=threads_refused,
                gathered=all_gather_rows(t[None], mesh).numpy(), gathered_flags=all_gather_rows(flags[None], mesh).numpy(),
                shifted=shifted.numpy(), shifted_flags=shifted_flags.numpy())


@pytest.mark.parametrize("D", [2, 3])
def test_callers_group_and_collectives(tmp_path, D):
    out = run_ranks(_group_worker, D, init_file=str(tmp_path / "init"), timeout=TIMEOUT)
    for r, o in enumerate(out):
        assert o["joined"] and o["world"] == D and o["wrong_size"] and o["rank"] == r and o["threads_refused"]
        np.testing.assert_array_equal(o["gathered"], np.arange(3)[None] + 10 * np.arange(D)[:, None])
        np.testing.assert_array_equal(o["gathered_flags"], np.stack([[k % 2 == 0, True] for k in range(D)]))
        src = (r - 1) % D
        np.testing.assert_array_equal(o["shifted"], np.arange(3) + 10 * src)
        assert o["shifted_flags"].dtype == bool and o["shifted_flags"].tolist() == [src % 2 == 0, True]


def _fails(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    return mesh.rank


def _hangs(mesh):
    import time

    if mesh.rank == 0:
        dist.barrier()          # rank 1 does not arrive in time
    else:
        time.sleep(120)
    return mesh.rank


def test_run_ranks_reports_failures_and_deadlocks(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        run_ranks(_fails, 2, init_file=str(tmp_path / "a"), timeout=TIMEOUT)
    with pytest.raises(TimeoutError):
        run_ranks(_hangs, 2, init_file=str(tmp_path / "b"), timeout=6.0)
