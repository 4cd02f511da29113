"""K15: exact top-k candidate selection over a batch of score maps
(csrc/select_candidates.cu), in memory that follows k, not the maps
(ops/detect.py select_candidates).

Replaces no TPU kernel: sfm_tpu/ops/detect.py select_candidates is
jax.lax.top_k over each whole map. Each entry i of a map has the key
(bits(score) << 31) | (2^31 - 1 - i), which orders as top_k_stable does
(score, then the lower index) and is unique within a map. The selection is
each map's k largest positive keys, then the 0 entries of its first k in
index order. select_keys writes them as 2^62 - 1 - key into the map's row of
[B, 3k], with the first k's 0 entries and EMPTY in the rest. On the card
(a radix select, then atomics) a row holds, in no particular order, up to
2k positive keys that include the k largest; the plain version below,
which the CPU runs, writes the k largest alone, in ascending order. The
caller sorts each row and keeps its first k, so both give the same
selection. No host sync. The launch plan and the scratch size are
plain Python, so that the CPU tests reach them.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.kernels import check, launch, on_cuda, ptr

# A block of 256 threads reads 256 consecutive float4 (or floats) a step
# (csrc kThreads).
THREADS = 256
# Blocks in all, about eight per SM of an H100 (132 SMs): enough loads in
# flight to stream the maps.
TARGET_BLOCKS = 1056
# The radix select's passes, bins a pass and map, and the find's groups of
# bins (csrc kPasses, kBins, kGroups); a map's state words (kStateWords).
PASSES = 4
BINS = 1 << 16
GROUPS = 256
STATE_WORDS = 8
# Keys: 31 bits of score, 31 of flat index (csrc kIndexMask, kKeyMax); an
# unused slot holds EMPTY.
INDEX_MASK = 2**31 - 1
KEY_MAX = 2**62 - 1
EMPTY = 2**63 - 1


def select_launch_plan(maps: int, n: int) -> tuple[int, int]:
    """(blocks a map, threads a block) for `maps` maps of n entries: about
    TARGET_BLOCKS in all, and no more than one per 256 entries."""
    if maps < 1 or n < 1:
        raise ValueError(f"maps and entries: expected >= 1, got {maps}, {n}")
    return max(1, min(-(-TARGET_BLOCKS // maps), -(-n // THREADS))), THREADS


def work_words(maps: int) -> int:
    """int64 words of select_keys' zeroed scratch: the maps' states, a bin
    array a pass and map (uint32), the find's group sums (uint32)."""
    return maps * STATE_WORDS + (PASSES * maps * BINS + maps * GROUPS + 1) // 2


def _maps(score: torch.Tensor, k: int) -> tuple[int, int]:
    B = score.shape[0]
    n = score[0].numel() if B else 0
    if B < 1 or n < 1 or n > INDEX_MASK or not 1 <= k <= n:
        raise ValueError(f"score {tuple(score.shape)}, k {k}: expected [B >= 1, ...] with 1 <= k <= "
                         f"entries a map < 2^31")
    return B, n


def select_keys_plain(score: torch.Tensor, k: int, keys: torch.Tensor) -> None:
    B, n = _maps(score, k)
    flat = score.reshape(B, n)
    head = torch.arange(k, device=score.device)
    for b in range(B):
        pos = torch.nonzero(flat[b] > 0)[:, 0]
        bits = flat[b, pos].view(torch.int32).to(torch.int64)
        taken = torch.topk(KEY_MAX - (bits * 2**31 + (INDEX_MASK - pos)), min(k, pos.numel()), largest=False,
                           sorted=True).values
        zeros = KEY_MAX - (INDEX_MASK - head[~(flat[b, :k] > 0)])
        keys[b] = EMPTY
        keys[b, :taken.numel() + zeros.numel()] = torch.cat([taken, zeros])


def select_keys(score: torch.Tensor, k: int, keys: torch.Tensor) -> None:
    """Write each map's selected keys of score [B, ...] float32 (entries >= 0,
    k <= entries a map < 2^31) into keys [B, 3k] int64, filled with EMPTY by
    the caller, as 2^62 - 1 - key: the first k of a row's ascending sort are
    the map's top_k_stable order."""
    if not on_cuda(score):
        return select_keys_plain(score, k, keys)
    B, n = _maps(score, k)
    dev = score.device
    check(score, "score", torch.float32, tuple(score.shape), dev)
    check(keys, "keys", torch.int64, (B, 3 * k), dev)
    work = torch.zeros(work_words(B), dtype=torch.int64, device=dev)
    grid_x, _ = select_launch_plan(B, n)
    launch("sfm_select_keys", "select_keys", ptr(score), B, n, k, grid_x, ptr(work), ptr(keys))
