"""K13 (blur_levels): the band tables the CUDA kernel reads, its tiling plan,
the wrapper's route and refusals.

The kernel reads each level's operator T as band tables built from T itself
(kernels/blur_levels.py band_tables); scattered back they must give T to the
bit, at every size the feature paths use, the small octaves where the
single reflection of _toeplitz_blur wraps included. The kernel's tiling
(tile windows, group windows, the float4-aligned vertical pass) is replayed
here in float64 (_tiled64) against the dense float64 product; that the
kernel runs it on the card to the bit of the plain version is
chip_smoke.py's [blur] line.
"""

import math
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sfm_tpu_torch import kernels
from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels import _SIGNATURES
from sfm_tpu_torch.kernels import blur_levels as k13
from sfm_tpu_torch.ops.pyramid import build_pyramid

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _deltas(cfg: SiftConfig, from_sigma: float) -> tuple[float, ...]:
    """build_pyramid's level blurs over a base of blur from_sigma."""
    s = cfg.scales_per_octave
    k = 2.0 ** (1.0 / s)
    return tuple(math.sqrt(max((cfg.sigma0 * k**i) ** 2 - from_sigma**2, 0.0)) for i in range(s + 3))


CFG = SiftConfig()
# The default pyramid's first octave and later octaves, and the upsampled
# first octave's (twice the assumed blur).
SIGMA_SETS = {"first": _deltas(CFG, CFG.assumed_blur), "later": _deltas(CFG, CFG.sigma0),
              "upsampled": _deltas(CFG, 2.0 * CFG.assumed_blur)}


def _operator(n: int, q):
    return np.eye(n, dtype=np.float32) if q is None else k13._toeplitz_blur(n, q)


def _band_operator(starts, weights) -> np.ndarray:
    """band_rows' band scattered back to [n, n]."""
    n = starts.shape[0]
    T = np.zeros((n, n), np.float32)
    np.put_along_axis(T, starts[:, None] + np.arange(weights.shape[1]), weights, 1)
    return T


def _group_operator(tables, level: int, n: int) -> np.ndarray:
    """A level's group tables scattered back to [n, n]."""
    g, group_w = k13.GROUP, tables.group_w
    T = np.zeros((n + g, n + group_w), np.float32)
    for i, (lo, hi) in enumerate(tables.group_windows[level]):
        if lo < hi:
            T[i * g:(i + 1) * g, lo:lo + group_w] = tables.group_taps[level, i].T
    return T[:n, :n]


@pytest.mark.parametrize("n", [16, 24, 32, 64, 128, 256, 1024])
def test_band_tables_scatter_back_to_the_operators_bit_for_bit(n):
    """Every level of the default pyramid's first and later octaves and of
    the upsampled first octave: the band of each row and the kernel's group
    tables give the plain version's operator to the bit."""
    for sigmas in SIGMA_SETS.values():
        keys = k13.sigma_keys(sigmas)
        tables = k13.band_tables(n, keys)
        for level, q in enumerate(keys):
            T = _operator(n, q)
            starts, weights = k13.band_rows(T)
            assert starts.min() >= 0 and starts.max() + weights.shape[1] <= n
            assert weights.shape[1] == tables.widths[level]
            assert np.array_equal(_band_operator(starts, weights), T), (n, level, q)
            assert np.array_equal(_group_operator(tables, level, n), T), (n, level, q)
    # The identity level (later octaves) is one tap of weight 1.
    starts, weights = k13.band_rows(np.eye(n, dtype=np.float32))
    assert np.array_equal(starts, np.arange(n)) and np.array_equal(weights, np.ones((n, 1), np.float32))


def test_small_octaves_wrap_and_take_the_whole_row():
    """Where n <= 2r the reflected taps of _toeplitz_blur wrap; the widest
    levels then read every column, as the dense operator does."""
    keys = k13.sigma_keys(SIGMA_SETS["first"])
    starts, weights = k13.band_rows(k13._toeplitz_blur(32, keys[-1]))
    assert weights.shape[1] == 32 and not starts.any()
    assert k13.band_tables(1024, keys).widths.tolist() == [2 * math.ceil(4 * s) + 1 for s in SIGMA_SETS["first"]]


def _tiled64(base: np.ndarray, tables) -> np.ndarray:
    """csrc/blur_levels.cu's plan replayed in float64: per tile the base
    window of tile_rows / tile_cols (zeros past its last column), per level
    the tile's group windows and taps, the vertical pass from a multiple of
    4 over the columns the horizontal windows read, the horizontal pass."""
    n = base.shape[0]
    L, groups, group_w, g = tables.group_taps.shape
    th, tw = k13.TILE_H, k13.TILE_W
    pitch = (tables.span_w + 6) // 4 * 4
    assert groups == -(-n // tw) * (tw // g)
    out = np.full((L, n, n), np.nan)
    for by, (ry0, ry1) in enumerate(tables.tile_rows):
        for bx, (rx0, rx1) in enumerate(tables.tile_cols):
            y0, x0 = by * th, bx * tw
            assert ry1 - ry0 <= tables.span_h and rx1 - rx0 <= tables.span_w
            S = np.zeros((ry1 - ry0, pitch))
            S[:, :rx1 - rx0] = base[ry0:ry1, rx0:rx1]
            for lev in range(L):
                win, taps = tables.group_windows[lev], tables.group_taps[lev]
                rows = range(y0 // g, y0 // g + th // g)
                cols = range(x0 // g, x0 // g + tw // g)
                live = [win[c] for c in cols if win[c, 0] < win[c, 1]]
                cx0, cx1 = min(lo for lo, _ in live), max(hi for _, hi in live)
                ca = rx0 + ((cx0 - rx0) & ~3)
                quads = (cx1 - ca + 3) // 4
                assert cx1 <= rx1 and 4 * quads <= pitch - (ca - rx0)
                tmp = np.zeros((th, 4 * quads))
                for i, r in enumerate(rows):
                    vs, ve = win[r]
                    if vs < ve:
                        assert ry0 <= vs and ve <= ry1
                        cols_read = S[vs - ry0:ve - ry0, ca - rx0:ca - rx0 + 4 * quads]
                        tmp[i * g:(i + 1) * g] = taps[r, :ve - vs].T.astype(np.float64) @ cols_read
                for j, c in enumerate(cols):
                    hs, he = win[c]
                    x = x0 + j * g
                    if hs < he:
                        blk = tmp[:, hs - ca:he - ca] @ taps[c, :he - hs].astype(np.float64)
                        nr = min(th, n - y0)
                        out[lev, y0:y0 + nr, x:min(x + g, n)] = blk[:nr, :min(g, n - x)]
    return out


@pytest.mark.parametrize("n, sigmas", [(24, "first"), (32, "later"), (64, "upsampled"), (100, "first"),
                                       (130, "later"), (257, "first")])
def test_kernel_plan_in_float64_equals_the_dense_product(n, sigmas):
    """The table applied in float64 (the kernel's windows and order of
    passes) equals the float64 dense product T (T x)^T within 1e-12."""
    keys = k13.sigma_keys(SIGMA_SETS[sigmas])
    tables = k13.band_tables(n, keys)
    x = np.random.default_rng(n).uniform(0, 1, (n, n))
    got = _tiled64(x, tables)
    for level, q in enumerate(keys):
        T = _operator(n, q).astype(np.float64)
        np.testing.assert_allclose(got[level], T @ x @ T.T, rtol=0, atol=1e-12)


def test_cpu_route_is_the_plain_version():
    img = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 64, 64)).astype(np.float32))
    for sigmas in SIGMA_SETS.values():
        assert torch.equal(k13.blur_levels(img, sigmas), k13.blur_levels_plain(img, sigmas))
        view = img[:, ::2, ::2]
        assert torch.equal(k13.blur_levels(view, sigmas), k13.blur_levels_plain(view, sigmas))
    before = dict(kernels.LAUNCHES)
    build_pyramid(img, SiftConfig(image_max_dim=64, num_octaves=3))
    assert kernels.LAUNCHES == before


def test_wrapper_passes_the_tables_and_the_strides(monkeypatch):
    """On the card route the wrapper hands sfm_blur_levels the base with its
    strides (a decimated view uncopied), the tables on the base's device, a
    fresh [B, L, n, n] output and the sizes; one launch a call."""
    passed = []
    monkeypatch.setattr(k13, "on_cuda", lambda t: True)
    monkeypatch.setattr(k13, "launch", lambda entry, name, *a: passed.append((entry, name, a)))
    stack = torch.zeros((3, 6, 64, 64))
    base = stack[:, 3, ::2, ::2]
    sigmas = SIGMA_SETS["later"]
    out = k13.blur_levels(base, sigmas)
    (entry, name, args), = passed
    assert (entry, name) == ("sfm_blur_levels", "blur_levels")
    assert len(_SIGNATURES[entry]) == len(args) + 1
    assert args[0] == base.data_ptr() and args[1:4] == (6 * 64 * 64, 128, 2)
    tables, arrays = k13.device_tables(32, k13.sigma_keys(sigmas), base.device)
    assert [a.numpy().tobytes() for a in arrays] == [a.tobytes() for a in tables.device_arrays()]
    assert args[4:8] == tuple(a.data_ptr() for a in arrays)
    assert args[8] == out.data_ptr() and out.shape == (3, 6, 32, 32) and out.dtype == torch.float32
    assert args[9:] == (3, 6, 32, tables.span_h, tables.span_w, tables.group_w)
    assert k13.blur_levels(torch.zeros((0, 32, 32)), sigmas).shape == (0, 6, 32, 32)
    assert len(passed) == 1


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(k13, "on_cuda", lambda t: True)
    monkeypatch.setattr(k13, "launch", lambda *a: None)
    sigmas = SIGMA_SETS["first"]
    with pytest.raises(ValueError):
        k13.blur_levels(torch.zeros((2, 32, 48)), sigmas)
    with pytest.raises(ValueError):
        k13.blur_levels(torch.zeros((2, 32, 32), dtype=torch.float64), sigmas)
    with pytest.raises(ValueError):
        k13.blur_levels(torch.zeros((32, 32)), sigmas)
    with pytest.raises(ValueError):
        k13.blur_levels(torch.zeros((2, 32, 32)), ())


def test_card_route_without_the_library_raises(monkeypatch):
    """A CUDA tensor with no kernel library raises; nothing falls back to
    the plain version and nothing counts as a launch."""
    def no_library():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")

    def plain(*a):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(k13, "on_cuda", lambda t: True)
    monkeypatch.setattr(k13, "blur_levels_plain", plain)
    monkeypatch.setattr(kernels, "library", no_library)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    before = kernels.LAUNCHES["blur_levels"]
    with pytest.raises(RuntimeError, match="nvcc"):
        k13.blur_levels(torch.zeros((2, 32, 32)), SIGMA_SETS["first"])
    assert kernels.LAUNCHES["blur_levels"] == before


def test_kernel_source_parses():
    """csrc/blur_levels.cu parses with g++ against the CUDA shim
    (tools/cuda_syntax_check.py); compiling and running it takes the card
    (chip_smoke.py's [blur] line)."""
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "cuda_syntax_check.py"), "blur_levels.cu"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
