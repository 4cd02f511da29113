"""The divide-and-conquer pipeline of sfm_tpu_torch with the global engine
inside its clusters, against sfm_tpu (CPU), on the ring24 fixture of
tests/integration/test_partition.py with both packages fed the same features
and graph. Bars as tests/test_torch_partition.py's for the incremental mode:
registered count equal +-1, mean reprojection error within 5%, camera-centre
RMSE after Sim(3) under 0.08 (2% of the orbit radius) for both, point counts
within 5%.
"""

import pytest
import torch

from sfm_tpu.pipeline import partition as jpartition
from sfm_tpu_torch.pipeline import partition
from sfm_tpu_torch.utils.interop import from_numpy_feature_set, from_numpy_graph
from tests.test_torch_partition import assert_slice_matches, ring24_config, ring24_inputs, tcfg

torch.set_num_threads(2)


def test_partitioned_reconstruct_global_mode_matches_jax():
    """Clusters reconstructed by the global engine, merged through the
    full-graph pose graph, then the shared rescue and polish."""
    scene, feats, graph = ring24_inputs()
    cfg = ring24_config("global")
    ref = jpartition.partitioned_reconstruct(feats, graph, scene.intrinsics.copy(), cfg)
    rec = partition.partitioned_reconstruct(from_numpy_feature_set(feats), from_numpy_graph(graph),
                                            scene.intrinsics.copy(), tcfg(cfg), "cpu")
    assert_slice_matches(rec, ref, scene)
    assert rec.num_points == pytest.approx(ref.num_points, rel=0.05)
    assert {"partition.clusters", "partition.merge", "partition.polish"} <= set(rec.stage_seconds)
