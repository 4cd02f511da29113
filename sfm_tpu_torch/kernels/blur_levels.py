"""K13: an octave's Gaussian levels from its base in one launch
(csrc/blur_levels.cu).

Replaces no TPU kernel: sfm_tpu/ops/pyramid.py blurs with two dense
banded-Toeplitz products a level. The plain version below is the port's
pyramid code as it ran before the kernel: blurred = T @ img @ T^T with a
dense [n, n] operator T a level (reflect boundaries baked into the band),
stacked on the host and copied to the device at every call. The CPU runs
and the tests against sfm_tpu take it; chip_smoke holds the kernel to it on
the card.

The kernel reads T's band instead (band_rows): for each row of T, the first
column of a window of W consecutive columns that holds every nonzero of the
row, and T's entries over that window, zeros inside it included; laid out
for the kernel by groups of GROUP rows over their common window
(BandTables.group_taps). The tables of an (n, sigmas) pair are built from T
itself on the host and uploaded once per device (device_tables); only that
miss opens the span sift.pyramid.constants. The kernel sums, for every
output, T's entries in ascending column order from 0 with fmaf, as the
dense fp32 product does (its other terms are exact zeros), vertical pass
first.

A strided base (downsample2's view of the previous octave's level) is read
through its strides by the kernel: no copy.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from sfm_tpu_torch.kernels import launch, on_cuda, ptr
from sfm_tpu_torch.utils.logging import span

# Output tile of one block and the outputs that share a window of taps
# (csrc kTileH, kTileW, kGroup).
TILE_H = 32
TILE_W = 64
GROUP = 4


def gaussian_kernel1d(sigma: float) -> np.ndarray:
    """Odd-width normalized Gaussian; width = 2*ceil(4*sigma)+1."""
    radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _toeplitz_blur(n: int, sigma_q: int) -> np.ndarray:
    """Banded blur operator [n, n] with reflect boundaries; sigma is
    quantized to 1e-4 (sigma_q = round(sigma * 1e4))."""
    sigma = sigma_q / 1e4
    k = gaussian_kernel1d(sigma)
    r = (len(k) - 1) // 2
    idx = np.arange(n)
    T = np.zeros((n, n), np.float32)
    for o, w in zip(range(-r, r + 1), k):
        j = idx + o
        j = np.where(j < 0, -j, j)
        j = np.where(j >= n, 2 * (n - 1) - j, j)
        np.add.at(T, (idx, j), w)
    return T


def blur_levels_plain(base: torch.Tensor, sigmas: tuple[float, ...]) -> torch.Tensor:
    """All octave levels from the base: base [B, S, S] -> [B, L, S, S]."""
    B, H, W = base.shape
    if H != W:
        raise ValueError("ingest pads to square canvases")
    with span("sift.pyramid.constants", h2d_bytes=len(sigmas) * H * H * 4):
        Ts = np.stack([
            np.eye(H, dtype=np.float32) if s <= 0 else _toeplitz_blur(H, int(round(s * 1e4)))
            for s in sigmas
        ])
        T = torch.from_numpy(Ts).to(base.device)
    return torch.matmul(torch.matmul(T[None], base[:, None]), T.transpose(1, 2)[None])


def sigma_keys(sigmas: tuple[float, ...]) -> tuple[int | None, ...]:
    """The plain version's operator of each level: None for the identity
    (sigma <= 0), else the quantized sigma of _toeplitz_blur."""
    return tuple(None if s <= 0 else int(round(s * 1e4)) for s in sigmas)


def band_rows(T: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts [n] int32, weights [n, W] float32) of an [n, n] operator: W
    is the widest span from a row's first to its last nonzero column, row
    i's window is columns starts[i] .. starts[i] + W - 1 (inside [0, n)),
    and weights[i, t] = T[i, starts[i] + t]."""
    n = T.shape[0]
    nz = T != 0
    lo = nz.argmax(1)
    hi = n - 1 - nz[:, ::-1].argmax(1)
    width = int((hi - lo).max()) + 1
    starts = np.minimum(lo, n - width).astype(np.int32)
    cols = starts[:, None] + np.arange(width)
    return starts, np.take_along_axis(T, cols, 1).astype(np.float32)


def _windows(starts: np.ndarray, widths: np.ndarray, size: int) -> np.ndarray:
    """[ceil(n / size), 2] (first, end) of the columns that the rows of each
    block of `size` rows read, over every level."""
    n = starts.shape[1]
    out = []
    for r0 in range(0, n, size):
        s = starts[:, r0:r0 + size]
        out.append((int(s.min()), int((s + widths[:, None]).max())))
    return np.asarray(out, np.int32).reshape(-1, 2)


@dataclass(frozen=True)
class BandTables:
    """The kernel's tables of one (n, sigmas) pair (host arrays): for each
    GROUP aligned rows of a level, the window from their least start to
    their last end (band_rows) and the rows' entries over it, zeros outside
    a row's own window; the groups padded with empty ones to whole column
    tiles."""

    widths: np.ndarray         # [L] int32: each level's band (band_rows' W)
    group_windows: np.ndarray  # [L, groups, 2] int32: (first, end); (n, n) is empty
    group_taps: np.ndarray     # [L, groups, group_w, GROUP] float32
    tile_rows: np.ndarray      # [ceil(n / TILE_H), 2] int32: base rows a tile reads
    tile_cols: np.ndarray      # [ceil(n / TILE_W), 2] int32: base columns a tile reads
    span_h: int                # the most rows of tile_rows
    span_w: int                # the most columns of tile_cols

    @property
    def group_w(self) -> int:
        return self.group_taps.shape[2]

    def device_arrays(self) -> tuple[np.ndarray, ...]:
        """What the kernel reads, in its argument order."""
        return self.group_windows, self.group_taps, self.tile_rows, self.tile_cols


@functools.lru_cache(maxsize=64)
def band_tables(n: int, keys: tuple[int | None, ...]) -> BandTables:
    """Tables of the levels `keys` (sigma_keys) at size n, from the plain
    version's own operators."""
    rows = [band_rows(np.eye(n, dtype=np.float32) if q is None else _toeplitz_blur(n, q)) for q in keys]
    L = len(rows)
    widths = np.asarray([w.shape[1] for _, w in rows], np.int32)
    starts = np.stack([s for s, _ in rows])
    groups = -(-n // TILE_W) * (TILE_W // GROUP)
    windows = np.full((L, groups, 2), n, np.int32)
    for lev in range(L):
        for g in range(-(-n // GROUP)):
            s = starts[lev, g * GROUP:(g + 1) * GROUP]
            windows[lev, g] = s.min(), s.max() + widths[lev]
    group_w = int((windows[..., 1] - windows[..., 0]).max())
    taps = np.zeros((L, groups, group_w, GROUP), np.float32)
    for lev, (_, weights) in enumerate(rows):
        for p in range(n):
            t0 = starts[lev, p] - windows[lev, p // GROUP, 0]
            taps[lev, p // GROUP, t0:t0 + widths[lev], p % GROUP] = weights[p]
    tile_rows, tile_cols = _windows(starts, widths, TILE_H), _windows(starts, widths, TILE_W)
    return BandTables(widths, windows, taps, tile_rows, tile_cols,
                      span_h=int((tile_rows[:, 1] - tile_rows[:, 0]).max()),
                      span_w=int((tile_cols[:, 1] - tile_cols[:, 0]).max()))


@functools.lru_cache(maxsize=64)
def device_tables(n: int, keys: tuple[int | None, ...], device: torch.device):
    """(BandTables, the kernel's arrays on `device`), uploaded at the first
    call for (n, keys, device) inside the span sift.pyramid.constants."""
    tables = band_tables(n, keys)
    arrays = tables.device_arrays()
    with span("sift.pyramid.constants", h2d_bytes=sum(a.nbytes for a in arrays)):
        return tables, tuple(torch.from_numpy(a).to(device) for a in arrays)


def blur_levels(base: torch.Tensor, sigmas: tuple[float, ...]) -> torch.Tensor:
    """All octave levels from the base: base [B, n, n] float32 (any
    strides) -> [B, L, n, n], level l blurred by sigmas[l] (none where
    sigmas[l] <= 0)."""
    if not on_cuda(base):
        return blur_levels_plain(base, sigmas)
    if base.dim() != 3 or base.shape[1] != base.shape[2]:
        raise ValueError(f"base: expected square [B, n, n], got {tuple(base.shape)}")
    if base.dtype != torch.float32:
        raise ValueError(f"base: expected torch.float32, got {base.dtype}")
    B, n, _ = base.shape
    L = len(sigmas)
    if L < 1 or n < 1 or B > 65535 or min(base.stride()) < 0:
        raise ValueError(f"blur_levels: no launch for {L} levels of {tuple(base.shape)}, "
                         f"strides {base.stride()}")
    out = torch.empty((B, L, n, n), dtype=torch.float32, device=base.device)
    if B == 0:
        return out
    tables, arrays = device_tables(n, sigma_keys(sigmas), base.device)
    launch("sfm_blur_levels", "blur_levels", ptr(base), *base.stride(), *map(ptr, arrays), ptr(out),
           B, L, n, tables.span_h, tables.span_w, tables.group_w)
    return out
