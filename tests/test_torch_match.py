"""Matching: kernel K2's plain version and match_pair against sfm_tpu.

Tolerances:
- K2 plain version vs sfm_tpu match_topk2 (Pallas, interpret mode) on
  [512, 128]: argmin equal on every row whose two nearest distances are more
  than 1e-3 apart (closer pairs are near-ties whose order depends on the
  summation order of the bf16 Gram); d1/d2 rtol 1e-5, atol 1e-6.
- match_pair (both paths of the port) vs sfm_tpu match_pair and
  match_pair_pallas: the same match SETS; order within the budget may differ
  because d1 from bf16 norms differs from d1 from fp32 norms by ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import MatchConfig as JMatchConfig
from sfm_tpu.kernels.match_topk import match_pair_pallas, match_topk2 as jtopk2
from sfm_tpu.ops.match import match_pair as jmatch_pair
from sfm_tpu_torch.config import MatchConfig
from sfm_tpu_torch.kernels.match_topk import match_topk2
from sfm_tpu_torch.ops.match import match_block, match_pair, match_pair_kernel

torch.set_num_threads(2)


def synth_desc(n, seed, n_valid=None):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v = np.zeros(n, bool)
    v[: (n_valid if n_valid is not None else n)] = True
    d[~v] = 0.0
    return d, v


def test_topk2_plain_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    db, _ = synth_desc(512, 1)
    perm = rng.permutation(512)
    da = db[perm] + 0.05 * rng.normal(size=(512, 128)).astype(np.float32)
    da /= np.linalg.norm(da, axis=-1, keepdims=True)
    da[:16] = rng.normal(size=(16, 128)).astype(np.float32) * 0.05   # unplanted rows
    vb = np.arange(512) < 480
    db[480:] = np.nan                                               # padding must not leak
    j1, j2, jidx = (np.asarray(a) for a in jtopk2(jnp.asarray(da), jnp.asarray(db), jnp.asarray(vb),
                                                     interpret=True))
    t1, t2, tidx = match_topk2(torch.from_numpy(da)[None], torch.from_numpy(db)[None],
                               torch.from_numpy(vb)[None])
    t1, t2, tidx = t1[0].numpy(), t2[0].numpy(), tidx[0].numpy()
    clear = (j2 - j1) > 1e-3
    assert clear.sum() > 400
    np.testing.assert_array_equal(tidx[clear], jidx[clear])
    np.testing.assert_allclose(t1, j1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t2, j2, rtol=1e-5, atol=1e-6)
    assert tidx.dtype == np.int32 and (tidx < 480).all()


def _pair():
    da, va = synth_desc(512, 2, 480)
    db, vb = synth_desc(512, 3, 460)
    da[:100] = db[:100] + 0.02 * np.random.default_rng(4).normal(size=(100, 128)).astype(np.float32)
    da /= np.maximum(np.linalg.norm(da, axis=-1, keepdims=True), 1e-8)
    return da, va, db, vb


def _set(ia, ib, ok):
    ia, ib, ok = (np.asarray(a).reshape(-1) for a in (ia, ib, ok))
    return set(zip(ia[ok].tolist(), ib[ok].tolist()))


@pytest.mark.parametrize("mutual", [True, False])
def test_match_pair_sets_match_jax(mutual):
    da, va, db, vb = _pair()
    jcfg = JMatchConfig(max_matches=128, mutual_check=mutual)
    tcfg = MatchConfig(max_matches=128, mutual_check=mutual)
    J = [jnp.asarray(a) for a in (da, va, db, vb)]
    T = [torch.from_numpy(a)[None] for a in (da, va, db, vb)]
    ref = _set(*jmatch_pair(*J, jcfg))
    ref_pallas = _set(*match_pair_pallas(*J, jcfg, interpret=True))
    dense = _set(*match_pair(*T, tcfg))
    fused = _set(*match_pair_kernel(*T, tcfg))
    assert len(ref) >= 90
    assert dense == ref
    assert fused == ref_pallas == ref


def test_match_block_padding_contract():
    da, va, db, vb = _pair()
    T = [torch.from_numpy(a)[None].repeat(3, *([1] * a.ndim)) for a in (da, va, db, vb)]
    pm = match_block(*T, MatchConfig(max_matches=1024))
    assert pm.idx_i.shape == (3, 1024) and pm.idx_i.dtype == torch.int32
    assert pm.valid[:, 512:].sum() == 0 and pm.valid.sum(1).min() >= 90
    assert torch.equal(pm.idx_i[0], pm.idx_i[2])
