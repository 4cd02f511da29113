"""Ring-sharded all-pairs matching (port of sfm_tpu/dist/ring_match.py):
the structural twin of ring attention.

Images [B] are split into D contiguous shards of b = B / D, one per process.
At ring step s process d holds its resident shard d and the visiting shard
(d - s) mod D, and matches every resident x visiting image pair (kernel K2
through ops/match.match_block); the visiting shard then moves to process
d + 1 (send/recv: sfm_tpu's ppermute). After D steps every ordered pair
(i, j) with i in shard d has met on process d. The per-process row block is
all_gather-ed, so every process holds what sfm_tpu's global array holds.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.config import MatchConfig
from sfm_tpu_torch.dist.mesh import Mesh, all_gather_rows, ring_shift
from sfm_tpu_torch.ops.match import match_block


def _match_grid(dr, vr, dc, vc, cfg: MatchConfig):
    """Every pair (resident i, visiting j) in blocks of cfg.block_pairs
    pairs -> (idx_i, idx_j, ok) [br, b, M]."""
    br, b = dr.shape[0], dc.shape[0]
    ri = torch.arange(br, device=dr.device).repeat_interleave(b)
    cj = torch.arange(b, device=dr.device).repeat(br)
    outs = []
    for s in range(0, br * b, cfg.block_pairs):
        i, j = ri[s:s + cfg.block_pairs], cj[s:s + cfg.block_pairs]
        outs.append(match_block(dr[i], vr[i], dc[j], vc[j], cfg))
    return tuple(torch.cat(t).reshape(br, b, -1) for t in zip(*outs))


def _ring(dr, vr, desc_all, valid_all, cfg: MatchConfig, mesh: Mesh, mask_self: bool):
    D, r = mesh.size, mesh.rank
    B = desc_all.shape[0]
    b = B // D
    br = dr.shape[0]
    M = cfg.max_matches
    dev = dr.device
    out_ii = torch.zeros((br, B, M), dtype=torch.int32, device=dev)
    out_jj = torch.zeros((br, B, M), dtype=torch.int32, device=dev)
    out_ok = torch.zeros((br, B, M), dtype=torch.bool, device=dev)
    visiting = (desc_all[r * b:(r + 1) * b], valid_all[r * b:(r + 1) * b])
    for step in range(D):
        src = (r - step) % D
        ii, jj, ok = _match_grid(dr, vr, *visiting, cfg)
        if mask_self and step == 0:   # the diagonal of the resident shard
            ok = ok & ~torch.eye(br, dtype=torch.bool, device=dev)[:, :, None]
        out_ii[:, src * b:(src + 1) * b] = ii
        out_jj[:, src * b:(src + 1) * b] = jj
        out_ok[:, src * b:(src + 1) * b] = ok
        if step + 1 < D:
            visiting = ring_shift(visiting, mesh)
    return all_gather_rows(out_ii, mesh), all_gather_rows(out_jj, mesh), all_gather_rows(out_ok, mesh)


def ring_match_all(desc: torch.Tensor, valid: torch.Tensor, cfg: MatchConfig, mesh: Mesh):
    """All ordered pairs (i, j != i) of desc [B, N, 128], valid [B, N] (B
    divisible by the group's size; every process passes the same arrays):
    (idx_i, idx_j, ok) [B, B, M], row i holding image i's matches against
    every j, on every process."""
    D, B = mesh.size, desc.shape[0]
    if B % D:
        raise ValueError(f"B = {B} must be divisible by the group's size {D}")
    b = B // D
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return _ring(desc[rows], valid[rows], desc, valid, cfg, mesh, mask_self=True)


def ring_match_rows(desc_rows: torch.Tensor, valid_rows: torch.Tensor, desc_all: torch.Tensor,
                    valid_all: torch.Tensor, cfg: MatchConfig, mesh: Mesh):
    """A row block against every image: desc_rows [Br, N, 128] (Br divisible
    by the group's size, each process keeping its Br / D rows) against
    desc_all [B, N, 128] (B divisible by it) -> (idx_i, idx_j, ok)
    [Br, B, M] on every process. The building block of the pipeline's
    streamed ring matching: the full [B, B, M] table is O(B^2 M)."""
    D, B, Br = mesh.size, desc_all.shape[0], desc_rows.shape[0]
    if B % D or Br % D:
        raise ValueError(f"B = {B} and Br = {Br} must be divisible by the group's size {D}")
    br = Br // D
    rows = slice(mesh.rank * br, (mesh.rank + 1) * br)
    return _ring(desc_rows[rows], valid_rows[rows], desc_all, valid_all, cfg, mesh, mask_self=False)


def ring_match_reference(desc: torch.Tensor, valid: torch.Tensor, cfg: MatchConfig):
    """Unsharded reference with ring_match_all's semantics (for equality
    tests): every ordered pair, the diagonal masked."""
    B = desc.shape[0]
    ii, jj, ok = _match_grid(desc, valid, desc, valid, cfg)
    return ii, jj, ok & ~torch.eye(B, dtype=torch.bool, device=desc.device)[:, :, None]
