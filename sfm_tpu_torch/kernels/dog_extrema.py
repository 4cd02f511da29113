"""K1: fused DoG + 26-neighbour extremum scores (csrc/dog_extrema.cu).

Replaces sfm_tpu/kernels/dog_extrema.py dog_extrema_scores_batch. The plain
version below is the reference the kernel is held to bit for bit; it is also
what ops/detect.extrema_score_map runs. The launch plan (the tile a block
owns, and whether rows move as 16-byte chunks) is plain Python, so that the
CPU tests reach it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sfm_tpu_torch.kernels import check, launch, on_cuda, ptr

_MARGIN = 5

# Tiles the kernel is built for, (rows, columns), largest first. A thread
# owns 4 columns x ROWS_PER_THREAD rows of its block's tile; the block
# stages STAGES Gaussian tiles and one DoG plane in shared memory, each
# (rows + 2) x (columns + 8) floats.
TILES = ((16, 64), (16, 32))
ROWS_PER_THREAD = 2
STAGES = 3
# The smallest grid the plan accepts before it takes a smaller tile: two
# blocks for every SM of an H100 (132 SMs).
FILL_BLOCKS = 2 * 132


def tile_threads(tile: tuple[int, int]) -> int:
    th, tw = tile
    return (tw // 4) * (th // ROWS_PER_THREAD)


def tile_smem_bytes(tile: tuple[int, int]) -> int:
    """Dynamic shared memory of one block (csrc Tile::kSmemBytes)."""
    th, tw = tile
    return (STAGES + 1) * (th + 2) * (tw + 8) * 4


def tile_grid(tile: tuple[int, int], H: int, W: int) -> tuple[int, int]:
    """(blocks along x, blocks along y) of one image."""
    th, tw = tile
    return -(-W // tw), -(-H // th)


def dog_launch_plan(B: int, H: int, W: int) -> tuple[int, int]:
    """The largest tile whose grid over B images of H x W still gives
    FILL_BLOCKS blocks, else the smallest: octaves of 256^2 and up of a
    chunk of 8 images take (16, 64), its 128^2 octave (16, 32)."""
    for tile in TILES:
        gx, gy = tile_grid(tile, H, W)
        if B * gx * gy >= FILL_BLOCKS:
            return tile
    return TILES[-1]


def vector_route(gauss: torch.Tensor) -> bool:
    """16-byte copies and stores: W % 4 == 0 and a 16-byte aligned stack
    (the output, fresh from the allocator, is aligned)."""
    return gauss.shape[-1] % 4 == 0 and gauss.data_ptr() % 16 == 0


def scores_from_dog(dog: torch.Tensor, pre_thresh: float) -> torch.Tensor:
    """Plain score map from DoG volumes [B, Ld, H, W]: |dog| where a voxel is
    the max or min of its 3x3x3 neighbourhood and clears +-pre_thresh, and
    lies in levels [1, Ld-2] at least 5 px from every border; else 0."""
    B, Ld, H, W = dog.shape
    vol = dog[:, None]
    wmax = F.max_pool3d(vol, 3, stride=1, padding=1)[:, 0]
    wmin = -F.max_pool3d(-vol, 3, stride=1, padding=1)[:, 0]
    is_ext = ((dog >= wmax) & (dog > pre_thresh)) | ((dog <= wmin) & (dog < -pre_thresh))
    dev = dog.device
    lev = torch.arange(Ld, device=dev).view(Ld, 1, 1)
    yy = torch.arange(H, device=dev).view(1, H, 1)
    xx = torch.arange(W, device=dev).view(1, 1, W)
    interior = ((lev >= 1) & (lev <= Ld - 2)
                & (yy >= _MARGIN) & (yy < H - _MARGIN)
                & (xx >= _MARGIN) & (xx < W - _MARGIN))
    return torch.where(is_ext & interior, dog.abs(), torch.zeros((), device=dev))


def dog_extrema_scores_plain(gauss: torch.Tensor, pre_thresh: float) -> torch.Tensor:
    """Gaussian stacks [B, L, H, W] -> score maps [B, L-1, H, W]."""
    return scores_from_dog(gauss[:, 1:] - gauss[:, :-1], pre_thresh)


def dog_extrema_scores(gauss: torch.Tensor, pre_thresh: float) -> torch.Tensor:
    """Gaussian stacks [B, L, H, W] float32 -> score maps [B, L-1, H, W]."""
    if not on_cuda(gauss):
        return dog_extrema_scores_plain(gauss, pre_thresh)
    B, L, H, W = gauss.shape
    check(gauss, "gauss", torch.float32, (B, L, H, W), gauss.device)
    if B < 1 or L < 2 or H < 1 or W < 1:
        raise ValueError(f"gauss: expected B, H, W >= 1 and L >= 2, got {tuple(gauss.shape)}")
    out = torch.empty((B, L - 1, H, W), dtype=torch.float32, device=gauss.device)
    th, tw = dog_launch_plan(B, H, W)
    launch("sfm_dog_extrema", "dog_extrema_scores",
           ptr(gauss), ptr(out), B, L, H, W, float(pre_thresh), th, tw, int(vector_route(gauss)))
    return out
