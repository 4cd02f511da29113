"""Candidate selection (ops/detect.py select_candidates: each map's k
largest (score, lower index) keys, kernel K15's radix select or its plain
version, then a sort of the k) against the full sort it replaced,
top_k_stable, and extract_features at COLMAP's default settings scaled
down (portbench/configs/colmap-sift3200.json: upsampled first octave, a
4:3 photo in a square canvas, four candidates per descriptor slot).

Tolerances:
- the selection against top_k_stable: equal indices and values (torch.equal),
  on every case;
- extract_features against the benchmark's plain reference
  (portbench/reference/sift.py): every field equal (torch.equal), as
  portbench/tests/test_portbench_reference.py holds the port's defaults;
- against sfm_tpu: test_torch_sift.py's tolerances (>= 98% of sfm_tpu's
  valid keypoints within 0.01 px and 1e-4 rad, descriptors 1e-3).
"""

import ctypes
import dataclasses
import importlib.util
import re
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench.reference import sift as ref_sift
from sfm_tpu.config import SiftConfig as JSiftConfig
from sfm_tpu.ops.sift import extract_features as jextract
from sfm_tpu.utils.synthetic import render_blob_scene
from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels import _SIGNATURES
from sfm_tpu_torch.kernels import select_candidates as k15
from sfm_tpu_torch.ops.pyramid import pyramid_gradients
from sfm_tpu_torch.ops.detect import select_candidates, top_k_stable
from sfm_tpu_torch.ops.sift import extract_features

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "sfm_tpu_torch" / "csrc" / "select_candidates.cu"


def _map(B, N, density, seed, levels=0):
    """Sparse score maps [B, N]: positives at `density`, 0 elsewhere; with
    `levels` the positives take that many values only (ties)."""
    g = torch.Generator().manual_seed(seed)
    vals = 0.01 + torch.rand(B, N, generator=g)
    if levels:
        vals = 0.01 + torch.floor(vals * levels) / levels
    return torch.where(torch.rand(B, N, generator=g) < density, vals, torch.zeros(()))


def _last_index():
    s = _map(2, 300, 0.01, 4)
    s[:, -1] = 5.0
    return s


def _crowded_kth():
    """More entries share the k-th score than twice k: the index bits
    settle the selection."""
    s = _map(2, 500, 0.1, 9)
    s[:, 100:350:10] = 2.0    # 25 a map at the top, k = 10
    return s


def _extremes():
    """Subnormal and huge positives beside ordinary ones: the keys order by
    the floats' bits."""
    s = _map(2, 2000, 0.05, 8)
    s[0, 10:40] = torch.tensor(1e-40) * torch.arange(1, 31)
    s[1, 500:520] = torch.tensor(1e30) * torch.arange(1, 21)
    return s


CASES = {
    "sparse": (lambda: _map(3, 4000, 0.02, 1), 40),
    "ties": (lambda: _map(3, 4000, 0.05, 2, levels=3), 64),
    "all_zero_image": (lambda: torch.cat([_map(1, 500, 0.1, 3), torch.zeros(1, 500)]), 20),
    "fewer_positives_than_k": (lambda: _map(2, 1000, 0.01, 5), 100),
    "k_is_the_map": (lambda: _map(2, 97, 0.3, 6, levels=2), 97),
    "positive_at_the_last_index": (_last_index, 10),
    "maps_of_levels": (lambda: _map(2, 5 * 16 * 16, 0.05, 7, levels=4).reshape(2, 5, 16, 16), 50),
    "subnormal_and_huge": (_extremes, 120),
    "crowded_kth": (_crowded_kth, 10),
}


def _mismatch(select, score, k) -> bool:
    idx, vals = select(score, k)
    want_vals, want_idx = top_k_stable(score.reshape(score.shape[0], -1), k)
    return not (torch.equal(idx, want_idx) and torch.equal(vals, want_vals))


@pytest.mark.parametrize("case", list(CASES))
def test_selection_is_the_full_sorts(case):
    make, k = CASES[case]
    score = make()
    assert not _mismatch(select_candidates, score, k)
    idx, vals = select_candidates(score, k)
    assert idx.shape == vals.shape == (score.shape[0], k)
    assert idx.dtype == torch.int64 and vals.dtype == torch.float32
    assert idx.is_contiguous() and vals.is_contiguous()
    assert idx.untyped_storage().nbytes() == idx.numel() * 8   # not a slice of a whole map's sort


def test_several_batches_at_once():
    """An extraction chunk's octaves one after another, as extract_features
    selects them: batches of three map sizes and two k, each batch's
    candidates equal to top_k_stable's."""
    scores = [_map(3, 4000, 0.02, 11, levels=3), _map(3, 500, 0.1, 12).reshape(3, 5, 10, 10),
              _map(3, 48, 0.5, 13)]
    for score, k in zip(scores, [64, 64, 40]):
        idx, vals = select_candidates(score, k)
        want_vals, want_idx = top_k_stable(score.reshape(3, -1), k)
        assert torch.equal(idx, want_idx) and torch.equal(vals, want_vals) and idx.is_contiguous()


def test_plain_keys_are_each_maps_largest():
    """K15's plain version: each row the map's k smallest 2^62 - 1 - key of
    its positive entries, then those of the first k's 0 entries, in
    ascending order, EMPTY in the rest; the key (bits(score) << 31) |
    (2^31 - 1 - index)."""
    score = _map(3, 600, 0.05, 14, levels=5)
    score[2, 100:] = 0.0      # fewer positive entries than k
    k = 70
    keys = torch.empty(3, 3 * k, dtype=torch.int64)
    k15.select_keys_plain(score, k, keys)
    flat = torch.arange(600)
    for b in range(3):
        pos = score[b] > 0
        key = k15.KEY_MAX - (score[b].view(torch.int32).to(torch.int64) * 2**31 + (k15.INDEX_MASK - flat))
        want = torch.cat([torch.sort(key[pos]).values[:k], key[:k][~pos[:k]]])
        assert torch.equal(keys[b, :want.numel()], want)
        assert bool((keys[b, want.numel():] == k15.EMPTY).all())


@pytest.mark.parametrize("k", [0, 601])
def test_k_outside_the_map_is_refused(k):
    with pytest.raises(ValueError):
        k15.select_keys_plain(torch.zeros(2, 600), k, torch.empty(2, max(k, 1), dtype=torch.int64))


@pytest.fixture(scope="module")
def host_library(tmp_path_factory) -> ctypes.CDLL:
    """csrc/select_candidates.cu built for the host against the CUDA shim of
    tools/cuda_syntax_check.py: each launch runs its blocks and threads one
    after another (the kernels share no memory but device memory, and the
    find's last thread, which reads the others' sums, runs last)."""
    tmp = tmp_path_factory.mktemp("k15")
    spec = importlib.util.spec_from_file_location("cuda_syntax_check", REPO / "tools" / "cuda_syntax_check.py")
    shim = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(shim)
    (tmp / "include").mkdir()
    (tmp / "include" / "cuda_runtime.h").write_text(shim.CUDA_RUNTIME_SHIM + r"""
template <class F> void sfm_host_launch(F body, dim3 grid, int threads, ...) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (blockIdx.y = 0; blockIdx.y < grid.y; ++blockIdx.y)
    for (blockIdx.x = 0; blockIdx.x < grid.x; ++blockIdx.x)
      for (threadIdx.x = 0; threadIdx.x < (unsigned)threads; ++threadIdx.x) body();
}
""")
    text = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"sfm_host_launch([&] { \1(\3); }, \2);", SOURCE.read_text(),
                  flags=re.S)
    (tmp / "k15.cpp").write_text(text + "\nuint3 threadIdx, blockIdx;\ndim3 blockDim, gridDim;\n")
    so = tmp / "libk15.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(tmp / "include"),
                    "-o", str(so), str(tmp / "k15.cpp")], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.sfm_select_keys.argtypes = list(_SIGNATURES["sfm_select_keys"])
    lib.sfm_select_keys.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("case", ["sparse", "ties", "all_zero_image", "fewer_positives_than_k", "k_is_the_map",
                                  "positive_at_the_last_index", "maps_of_levels", "subnormal_and_huge",
                                  "crowded_kth"])
def test_kernel_source_on_the_host_selects_as_the_full_sort(case, host_library):
    """K15 run thread by thread: every map settled within the four passes,
    min(k, positive entries) to 2k positive keys written a map besides the
    first k's 0 entries, the first k of a row's sort the plain version's,
    and the selection decoded from them equal to top_k_stable's."""
    make, k = CASES[case]
    score = make().contiguous()
    B, n = score.shape[0], score[0].numel()
    grid_x = k15.select_launch_plan(B, n)[0]
    work = torch.zeros(k15.work_words(B), dtype=torch.int64)
    keys = torch.full((B, 3 * k), k15.EMPTY, dtype=torch.int64)
    assert host_library.sfm_select_keys(score.data_ptr(), B, n, k, grid_x, work.data_ptr(), keys.data_ptr(),
                                        None) == 0
    state = work[:B * k15.STATE_WORDS].reshape(B, k15.STATE_WORDS)
    positive = score.reshape(B, -1) > 0
    zeros = (~positive[:, :k]).sum(1)
    written = (keys != k15.EMPTY).sum(1)
    assert state[:, 3].tolist() == [1] * B and torch.equal(state[:, 4], written)   # done; the cursor
    assert bool((written >= positive.sum(1).clamp_max(k) + zeros).all() and (written <= 2 * k + zeros).all())
    want = torch.empty(B, 3 * k, dtype=torch.int64)
    k15.select_keys_plain(score, k, want)
    want = want[:, :k]
    assert torch.equal(torch.sort(keys, 1).values[:, :k], want)
    idx = torch.bitwise_and(want, k15.INDEX_MASK)
    vals = (k15.INDEX_MASK - torch.bitwise_right_shift(want, 31)).to(torch.int32).view(torch.float32)
    want_vals, want_idx = top_k_stable(score.reshape(B, -1), k)
    assert torch.equal(idx, want_idx) and torch.equal(vals, want_vals)


@pytest.mark.parametrize("maps,n", [(1, 1), (8, 255), (8, 5 * 1024 * 1024), (1, 5 * 6400 * 6400), (64, 300)])
def test_launch_plan_covers_each_map(maps, n):
    blocks, threads = k15.select_launch_plan(maps, n)
    assert threads == 256 and 1 <= blocks and (blocks - 1) * threads < n
    assert maps * blocks <= max(k15.TARGET_BLOCKS + maps, maps)


def test_kernel_source_parses():
    """csrc/select_candidates.cu parses with g++ against the CUDA shim
    (tools/cuda_syntax_check.py); compiling it for the card and running it
    there is chip_smoke.py's and the benchmark's."""
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "cuda_syntax_check.py"), "select_candidates.cu"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_a_planted_fault_fails():
    """Ties broken toward the higher index: the same values, other indices."""
    def toward_higher(score, k):
        flat = score.reshape(score.shape[0], -1)
        idx, vals = select_candidates(flat.flip(-1), k)
        return flat.shape[1] - 1 - idx, vals

    make, k = CASES["ties"]
    assert _mismatch(toward_higher, make(), k)
    make, _ = CASES["sparse"]    # no ties among the positives: only the zero tail differs
    assert _mismatch(toward_higher, make(), 200)   # 80 positives a map: 120 zeros in the tail


@pytest.mark.parametrize("shape", [(2, 6, 17, 24), (1, 4, 3, 5), (1, 2, 2, 7), (1, 1, 6, 1)])
def test_gradients_are_the_rolled_differences(shape):
    """pyramid_gradients forms 0.5 * (roll(-1) - roll(1)) without the rolled
    copies: the same bits, wrapped ends and tiny sides included."""
    stack = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    stack.view(-1)[::5] *= 1e-39   # subnormals, which 0.5 * rounds
    want = [0.5 * (torch.roll(stack, -1, dims=d) - torch.roll(stack, 1, dims=d)) for d in (-1, -2)]
    assert all(torch.equal(a, b) for a, b in zip(pyramid_gradients(stack), want))


# COLMAP's settings (portbench/configs/colmap-sift3200.json) at 160 px: a
# 160 x 120 photo in a 160^2 canvas, 512 keypoints, 512 candidates and 128
# descriptors an octave.
SMALL = dict(upsample_first_octave=True, num_octaves=4, scales_per_octave=3, contrast_threshold=0.02,
             edge_threshold=10.0, multi_orientation=True, root_sift=True, image_max_dim=160,
             max_keypoints=512, max_candidates=2048, desc_per_octave=128)


@pytest.fixture(scope="module")
def photos():
    imgs, _ = render_blob_scene(image_size=(160, 160), num_images=2, num_blobs=160, focal=190.0)
    imgs[:, 120:] = 0.0
    return imgs, np.array([[120, 160], [120, 160]], np.int32)


@pytest.fixture(scope="module")
def ours(photos):
    imgs, hw = photos
    return extract_features(torch.from_numpy(imgs), SiftConfig(**SMALL), torch.from_numpy(hw))


def test_colmap_settings_match_the_plain_reference(photos, ours):
    imgs, hw = photos
    cfg = types.SimpleNamespace(**dataclasses.asdict(SiftConfig(**SMALL)))
    want = ref_sift.extract_features(torch.from_numpy(imgs), cfg, torch.from_numpy(hw))
    assert int(want.valid.sum()) > 100
    assert all(torch.equal(a, b) for a, b in zip(ours, want))
    assert bool((ours.xy[..., 1][ours.valid] < 119).all())


def test_colmap_settings_match_sfm_tpu(photos, ours):
    imgs, hw = photos
    fj = [np.asarray(a) for a in jextract(jnp.asarray(imgs), JSiftConfig(**SMALL), jnp.asarray(hw))]
    xy_j, _, ang_j, _, desc_j, val_j = fj
    xy_t, _, ang_t, _, desc_t, val_t = (a.numpy() for a in ours)
    for b in range(2):
        vj, vt = val_j[b], val_t[b]
        assert vj.sum() > 50 and abs(int(vj.sum()) - int(vt.sum())) <= 0.02 * vj.sum()
        d = np.linalg.norm(xy_j[b][vj][:, None] - xy_t[b][vt][None], axis=-1)
        da = np.abs(ang_j[b][vj][:, None] - ang_t[b][vt][None])
        close = (d < 0.01) & (np.minimum(da, 2 * np.pi - da) < 1e-4)
        hit = close.any(1)
        assert hit.mean() >= 0.98, hit.mean()
        nn = close.argmax(1)
        np.testing.assert_allclose(desc_t[b][vt][nn[hit]], desc_j[b][vj][hit], atol=1e-3)
