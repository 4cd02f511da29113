"""Multi-device execution (port of sfm_tpu/dist): one process per device
under torch.distributed, where sfm_tpu runs shard_map over a device mesh.

  - DP feature extraction: each process extracts its share of every image
    chunk, then all_gather (pipeline/stages.py);
  - ring matching: each process keeps a resident block of descriptors and
    passes the visiting block to the next process with send/recv, so every
    block pair meets on some process (ring_match.py);
  - pair-sharded verification: each process verifies its contiguous share of
    every pair block, then all_gather (pipeline/stages.py);
  - camera-sharded BA: observations sharded by camera, every
    observation-indexed sum completed by an all_reduce (sharded_ba.py,
    ba/core.py's `group` argument).

Every process runs the whole pipeline; the host stages are deterministic,
and every value they read from a collective is the same on every process.
"""

from sfm_tpu_torch.dist.mesh import Mesh, initialize_multihost, make_mesh, mesh_for  # noqa: F401
