"""The ring matcher (dist/ring_match.py) and the pipeline's streamed ring
route (stages.ring_match_pairs) on gloo processes on the CPU.

Descriptors are tests/distributed/test_sharding.py's: 8 images of 128
unit-norm descriptors around one base set (planted correspondences), the
last 16 of each invalid; MatchConfig(max_matches=128), which keeps every
valid match (test_sharding.py's 64 keeps the nearest 64 of ~110, and the
two packages' fp32 distances order those near-ties differently). Bars, all
exact:
- ring_match_all at D = 2 and 4 equals the port's unsharded
  ring_match_reference (every array) and sfm_tpu's ring_match_all (on
  make_mesh(2) at D = 2; at D = 4 its unsharded ring_match_reference,
  which tests/distributed/test_sharding.py holds ring_match_all to on 8
  devices: compiling sfm_tpu's 4-step ring alone takes ~20 s here): the
  same masks and, per image pair, the same set of
  matches (sfm_tpu's ring runs its match_pair, whose matches come in
  another order than its block matcher's, which the port's matcher
  mirrors; tests/distributed/test_pipeline_sharded.py compares sets too);
  every process holds the same table;
- ring_match_pairs on 10 images (padded to a multiple of D) in one row
  block and in blocks of D rows gives the same pairs and matches on every
  process, at D = 4 those of D = 2, and at D = 2 sfm_tpu's ring_match_pairs
  the same pairs, masks and match sets.

Processes are spawned and never import JAX; each run has its own time
limit.
"""

import numpy as np
import pytest
import torch

from sfm_tpu_torch.config import MatchConfig, PipelineConfig, ShardConfig
from sfm_tpu_torch.dist.launch import run_ranks
from sfm_tpu_torch.dist.ring_match import ring_match_all, ring_match_reference
from sfm_tpu_torch.pipeline import stages

TIMEOUT = 120.0
M = 128


def synth_descriptors(B=8, N=128, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(N, 128)).astype(np.float32)
    desc = []
    for _ in range(B):
        d = base + 0.1 * rng.normal(size=(N, 128)).astype(np.float32)
        desc.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    valid = np.ones((B, N), bool)
    valid[:, N - 16:] = False
    return np.stack(desc), valid


def feature_set(B=10, seed=1) -> stages.FeatureSet:
    desc, valid = synth_descriptors(B, seed=seed)
    N = desc.shape[1]
    rng = np.random.default_rng(seed)
    return stages.FeatureSet(xy=rng.uniform(0, 128, (B, N, 2)).astype(np.float32),
                             sigma=np.ones((B, N), np.float32), angle=np.zeros((B, N), np.float32),
                             response=np.ones((B, N), np.float32), desc=desc, valid=valid)


def config(D=1) -> PipelineConfig:
    return PipelineConfig(match=MatchConfig(max_matches=M, min_matches=8), shard=ShardConfig(num_devices=D),
                          verbose=False)


def match_sets(ii, jj, ok) -> list:
    """Per leading index (an image pair), the set of its valid matches."""
    ii, jj, ok = (a.reshape(-1, a.shape[-1]) for a in (ii, jj, ok))
    return [set(zip(i[o].tolist(), j[o].tolist())) for i, j, o in zip(ii, jj, ok)]


def _worker(mesh, desc, valid, feats):
    cfg = config(mesh.size)
    table = [t.numpy() for t in ring_match_all(torch.from_numpy(desc), torch.from_numpy(valid), cfg.match, mesh)]
    whole = stages.ring_match_pairs(feats, cfg, torch.device("cpu"), mesh)
    padB = -(-len(feats.xy) // mesh.size) * mesh.size
    stages._RING_BLOCK_BYTES = padB * M * 9 * mesh.size    # row blocks of D rows
    blocks = stages.ring_match_pairs(feats, cfg, torch.device("cpu"), mesh)
    return table, whole, blocks


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    cache = {}

    def get(D):
        if D not in cache:
            desc, valid = synth_descriptors()
            cache[D] = run_ranks(_worker, D, (desc, valid, feature_set()),
                                 init_file=str(tmp_path_factory.mktemp(f"ring{D}") / "init"), timeout=TIMEOUT)
        return cache[D]

    return get


@pytest.mark.parametrize("D", [2, 4])
def test_ring_match_all_equals_reference(ring, D):
    desc, valid = synth_descriptors()
    ref = ring_match_reference(torch.from_numpy(desc), torch.from_numpy(valid), config().match)
    for rank in ring(D):
        for a, b in zip(rank[0], ref):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("D", [2, 4])
def test_ring_match_all_equals_sfm_tpu(ring, D):
    import jax.numpy as jnp

    from sfm_tpu.config import MatchConfig as JMatchConfig
    from sfm_tpu.dist.mesh import make_mesh
    from sfm_tpu.dist.ring_match import ring_match_all as jring
    from sfm_tpu.dist.ring_match import ring_match_reference as jref

    desc, valid = synth_descriptors()
    args = (jnp.asarray(desc), jnp.asarray(valid), JMatchConfig(max_matches=M))
    ii, jj, ok = (np.asarray(t) for t in (jring(*args, make_mesh(D)) if D == 2 else jref(*args)))
    t_ii, t_jj, t_ok = ring(D)[0][0]
    np.testing.assert_array_equal(t_ok, ok)
    assert match_sets(t_ii, t_jj, t_ok) == match_sets(ii, jj, ok)


@pytest.mark.parametrize("D", [2, 4])
def test_ring_match_pairs_row_blocks_and_sfm_tpu(ring, D):
    from sfm_tpu.config import MatchConfig as JMatchConfig
    from sfm_tpu.config import PipelineConfig as JPipelineConfig
    from sfm_tpu.config import ShardConfig as JShardConfig
    from sfm_tpu.pipeline import stages as jstages

    ranks = ring(D)
    whole, blocks = ranks[0][1], ranks[0][2]
    for a, b in zip(whole, blocks):
        np.testing.assert_array_equal(a, b)
    for r in ranks[1:]:
        for a, b in zip(r[1], whole):
            np.testing.assert_array_equal(a, b)
    if D != 2:
        for a, b in zip(whole, ring(2)[0][1]):
            np.testing.assert_array_equal(a, b)
        return
    f = feature_set()
    jcfg = JPipelineConfig(match=JMatchConfig(max_matches=M, min_matches=8), shard=JShardConfig(num_devices=D),
                           verbose=False)
    jf = jstages.FeatureSet(xy=f.xy, sigma=f.sigma, angle=f.angle, response=f.response, desc=f.desc, valid=f.valid)
    pairs, pi, pj, pv = jstages.ring_match_pairs(jf, jcfg)
    assert len(pairs) == 45 and pv.any()
    np.testing.assert_array_equal(whole[0], pairs)
    np.testing.assert_array_equal(whole[3], pv)
    assert match_sets(*whole[1:]) == match_sets(pi, pj, pv)
