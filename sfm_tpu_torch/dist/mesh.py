"""Process groups (port of sfm_tpu/dist/mesh.py).

sfm_tpu's Mesh of devices becomes a Mesh record of the torch.distributed
process group this process belongs to: one process per device, `rank` its
place in the group, `device` its card (cuda:LOCAL_RANK) or the CPU. psum
becomes all_reduce(SUM) (ba/core.py), the ppermute ring send/recv to
rank + 1 from rank - 1 (ring_shift), and a sharded output read as one
global array an all_gather into the same layout on every rank
(all_gather_rows).

Divergence: sfm_tpu falls back to one chip when the backend has fewer
devices than shard.num_devices; make_mesh raises instead when no process
group of exactly that size exists (tests/test_torch_dist_mesh.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The process group of a multi-device run, as seen by one process."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    local_rank: int = 0    # the process's place on its host (LOCAL_RANK under torchrun)


def local_rank() -> int:
    """LOCAL_RANK where a launcher sets it (torchrun), else the group rank
    (0 without a group)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device) -> torch.device:
    """The card of this process for a device without an index: "cuda" means
    cuda:LOCAL_RANK under a launcher that sets LOCAL_RANK (one process per
    card), made the current device so that NCCL and "cuda" tensors land on
    it; any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", local_rank())
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device


def initialize_multihost(shard_cfg, device="cuda") -> bool:
    """Join the process group per ShardConfig (sfm_tpu's
    jax.distributed.initialize). Initializes torch.distributed once per
    process: from shard.coordinator_address ("host:port"),
    shard.num_processes and shard.process_id where given, else from the
    env:// variables a launcher sets (torchrun: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). The backend is nccl for a CUDA device, gloo for the
    CPU. Idempotent; a group the caller made already is accepted.

    Returns True if the group exists after the call, False when the config
    does not ask for multi-host."""
    if not getattr(shard_cfg, "multihost", False):
        return False
    if dist.is_initialized():
        return True
    device = local_device(device)
    kwargs = {}
    if shard_cfg.num_processes is not None:
        kwargs["world_size"] = shard_cfg.num_processes
    if shard_cfg.process_id is not None:
        kwargs["rank"] = shard_cfg.process_id
    init = f"tcp://{shard_cfg.coordinator_address}" if shard_cfg.coordinator_address else "env://"
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init, **kwargs)
    return True


def make_mesh(num_devices: int | None = None, device="cuda") -> Mesh:
    """The Mesh of this process's group (the default group): one process per
    device, num_devices of them (default: the group's size). Raises a
    ValueError when no group is initialized or its size is not num_devices."""
    if not dist.is_initialized():
        raise ValueError(
            f"shard.num_devices = {num_devices} needs a torch.distributed process group of "
            f"{num_devices} processes, one per device, and none is initialized: start the "
            "processes with a launcher (torchrun) and set shard.multihost, or call "
            "torch.distributed.init_process_group first")
    size = dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"shard.num_devices = {num_devices}, but the process group has {size} processes")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size,
                device=local_device(device), local_rank=local_rank())


def mesh_for(shard_cfg, device) -> Mesh | None:
    """The Mesh shard_cfg asks for on `device`: None for one device
    (shard.num_devices <= 1), else make_mesh's (which raises without a
    group of that size)."""
    if shard_cfg.num_devices <= 1:
        return None
    return make_mesh(shard_cfg.num_devices, device)


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's t [n, ...] stacked in rank order -> [size * n, ...]
    on every process: a sharded output read as the global array."""
    if t.dtype == torch.bool:
        return all_gather_rows(t.to(torch.uint8), mesh).bool()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts)


def ring_shift(tensors: tuple, mesh: Mesh) -> tuple:
    """sfm_tpu's ppermute ring (d -> d + 1): each tensor sent to rank + 1,
    its twin received from rank - 1. Bool tensors travel as uint8."""
    if mesh.size == 1:
        return tensors
    dst, src = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    send = [t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for s, r in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, s, dst, group=mesh.group))
        ops.append(dist.P2POp(dist.irecv, r, src, group=mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(r.bool() if t.dtype == torch.bool else r for t, r in zip(tensors, recv))
