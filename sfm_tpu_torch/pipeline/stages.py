"""Stage drivers (port of sfm_tpu/pipeline/stages.py): feature extraction
over image chunks (eager, or streamed from a path list while a decode
thread prepares the next chunk), exhaustive pairs, the ring matcher's
all-pairs route, match + verification over pair blocks (with the guided
re-match under the verified E), and the graph-distance-ladder
densification of pruned pair graphs. Stages return plain numpy for the
host bookkeeping between them.

Given a dist.mesh.Mesh (shard.num_devices > 1: one process per device,
every process calling the stage with the same inputs) the device work is
shared and the outputs gathered, so every process returns the
single-device result:
  - extraction: chunks of 8 images per process; process r extracts images
    [8 r, 8 r + 8) of each chunk (K1), then all_gather;
  - ring_match_pairs: the ring matcher (dist/ring_match.py) over row blocks
    of the all-pairs table, compacted to the pairs i < j with at least
    match.min_matches matches;
  - match + verify: each pair block (its size rounded up to a multiple of
    the process count) split into contiguous shares, one per process, then
    all_gather; the RANSAC draws are keyed by the global pair index.

Divergences from the JAX package: on one device the last image chunk and
the last pair block are not padded to a fixed size (that padding only
fixed jit shapes); outputs are the same per image and per pair. The guided
re-match runs its [P, N1, N2] matrices in slices of pairs
(ops/match.guided_match_block); each pair's result is its own. The ring
matcher works on the match stage's keypoint bucket (sfm_tpu matches the
whole budget there); the matches are the same, the tail being invalid
slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.dist.mesh import Mesh, all_gather_rows
from sfm_tpu_torch.ops.match import PairMatches, guided_match_block, match_block
from sfm_tpu_torch.ops.sift import extract_features
from sfm_tpu_torch.ops.verify import verify_block
from sfm_tpu_torch.pipeline.ingest import ImageBatch, iter_image_chunks
from sfm_tpu_torch.utils.logging import span

_FEATURE_CHUNK = 8  # images per device batch in the feature stage
# The match stage keeps the descriptors and keypoints of every image on the
# device below this size (sfm_tpu's _DEVICE_FEATURE_CACHE_BYTES): 6 GiB holds
# about 3,000 images of 4,096 keypoints in fp32.
_DEVICE_FEATURE_CACHE_BYTES = 6 << 30


@dataclass
class FeatureSet:
    """Host-side features for all images (canvas pixel coords)."""

    xy: np.ndarray        # [B, N, 2]
    sigma: np.ndarray     # [B, N]
    angle: np.ndarray     # [B, N]
    response: np.ndarray  # [B, N]
    desc: np.ndarray      # [B, N, 128]
    valid: np.ndarray     # [B, N]


@dataclass
class MatchGraph:
    """Verified match graph: edges + two-view geometry."""

    pairs: np.ndarray          # [E, 2] image indices (i < j)
    idx_i: np.ndarray          # [E, M] keypoint indices in image i
    idx_j: np.ndarray          # [E, M]
    inlier: np.ndarray         # [E, M] bool (geometric inliers)
    num_inliers: np.ndarray    # [E]
    num_h_inliers: np.ndarray  # [E]
    rvec: np.ndarray           # [E, 3] relative pose i->j
    tvec: np.ndarray           # [E, 3]
    ok: np.ndarray             # [E] bool
    pose_ok: np.ndarray | None = None  # [E] bool; False = correspondence-only edge


def _extract_chunk(canvases: np.ndarray, valid_hw: np.ndarray, cfg: PipelineConfig,
                   device: torch.device, mesh: Mesh | None = None) -> list:
    """Features of a chunk of images. With a mesh the chunk holds up to
    8 x mesh.size images: this process extracts its 8 (the share padded
    with empty canvases, as sfm_tpu pads a chunk), then every share is
    gathered."""
    n = canvases.shape[0]
    with span("features.chunk"):
        if mesh is not None:
            share = slice(mesh.rank * _FEATURE_CHUNK, (mesh.rank + 1) * _FEATURE_CHUNK)
            canvases, valid_hw = canvases[share], valid_hw[share]
            pad = _FEATURE_CHUNK - canvases.shape[0]
            if pad:
                canvases = np.concatenate([canvases, np.zeros((pad, *canvases.shape[1:]), canvases.dtype)])
                valid_hw = np.concatenate([valid_hw, np.zeros((pad, 2), valid_hw.dtype)])
        with span("features.upload", h2d_bytes=canvases.nbytes + valid_hw.nbytes):
            images = torch.from_numpy(np.ascontiguousarray(canvases)).to(device)
            hw = torch.from_numpy(np.ascontiguousarray(valid_hw)).to(device)
        f = extract_features(images, cfg.sift, hw)
        if mesh is not None:
            with span("features.gather"):
                f = [all_gather_rows(a, mesh)[:n] for a in f]
        with span("features.download", d2h_bytes=sum(a.nbytes for a in f)):
            return [a.cpu().numpy() for a in f]


def _chunk_size(mesh: Mesh | None) -> int:
    return _FEATURE_CHUNK * (mesh.size if mesh is not None else 1)


def _feature_set(outs: list) -> FeatureSet:
    return FeatureSet(*(np.concatenate([o[k] for o in outs]) for k in range(6)))


def extract_stage(batch: ImageBatch, cfg: PipelineConfig, device: torch.device,
                  mesh: Mesh | None = None) -> FeatureSet:
    B = batch.canvases.shape[0]
    chunk = _chunk_size(mesh)
    with span("features.extract"):
        return _feature_set([
            _extract_chunk(batch.canvases[s:s + chunk], batch.valid_hw[s:s + chunk], cfg, device, mesh)
            for s in range(0, B, chunk)])


def extract_stage_streaming(paths: list, cfg: PipelineConfig, device: torch.device,
                            mesh: Mesh | None = None):
    """Feature extraction over a path list without holding every canvas:
    the decode thread prepares the next chunk while the device extracts
    this one. Returns (FeatureSet, intrinsics [B, 6], valid_hw [B, 2], names)."""
    outs, intr, hw, names = [], [], [], []
    with span("features.extract"):
        chunks = iter_image_chunks(paths, cfg.sift, _chunk_size(mesh))
        while True:
            with span("features.decode_wait"):
                batch = next(chunks, None)
            if batch is None:
                break
            outs.append(_extract_chunk(batch.canvases, batch.valid_hw, cfg, device, mesh))
            intr.append(batch.intrinsics)
            hw.append(batch.valid_hw)
            names.extend(batch.names)
        return _feature_set(outs), np.concatenate(intr), np.concatenate(hw), names


def _bucket_keypoints(n: int, cap: int) -> int:
    """Power-of-2 keypoint-axis bucket in [512, cap] covering n."""
    b = 512
    while b < n:
        b *= 2
    return min(b, cap)


def exhaustive_pairs(num_images: int) -> np.ndarray:
    """All N(N-1)/2 pairs (i < j)."""
    ii, jj = np.triu_indices(num_images, k=1)
    return np.stack([ii, jj], axis=1).astype(np.int32)


# Host budget of one streamed ring row block ([Br, B, M] x 3 arrays).
_RING_BLOCK_BYTES = 1 << 30


def ring_match_pairs(feats: FeatureSet, cfg: PipelineConfig, device: torch.device, mesh: Mesh):
    """All-pairs matching through the ring matcher (dist/ring_match.py):
    (pairs [E, 2] with i < j, idx_i, idx_j, valid [E, M]) in the block
    matcher's layout, for match_and_verify_stage's `prematched`; the pairs
    are those with at least cfg.match.min_matches matches ((pairs, None,
    None, None) with no pair left). The [B, B, M] table is streamed in row
    blocks (ring_match_rows), each compacted to its surviving pairs before
    the next is computed: host memory stays within _RING_BLOCK_BYTES."""
    from sfm_tpu_torch.dist.ring_match import ring_match_rows

    B = len(feats.xy)
    D = mesh.size
    M = cfg.match.max_matches
    N_eff = _bucket_keypoints(int(feats.valid.sum(axis=1).max()), feats.valid.shape[1])
    padB = -(-B // D) * D
    desc = np.zeros((padB, N_eff, feats.desc.shape[2]), feats.desc.dtype)
    valid = np.zeros((padB, N_eff), bool)
    desc[:B] = feats.desc[:, :N_eff]
    valid[:B] = feats.valid[:, :N_eff]
    desc_d, valid_d = torch.from_numpy(desc).to(device), torch.from_numpy(valid).to(device)

    # Row blocks: 3 x [Br, padB, M] int32 / bool within the budget, Br a
    # multiple of D; the tail block is padded with wrapped rows.
    per_row = padB * M * (4 + 4 + 1)
    chunk = max(D, min(padB, (_RING_BLOCK_BYTES // max(per_row, 1)) // D * D))
    pairs_l, pi_l, pj_l, pv_l = [], [], [], []
    for r0 in range(0, padB, chunk):
        rows = torch.arange(r0, r0 + chunk, device=device) % padB
        ii, jj, ok = (t.cpu().numpy() for t in ring_match_rows(desc_d[rows], valid_d[rows], desc_d,
                                                               valid_d, cfg.match, mesh))
        gi = r0 + np.arange(chunk)[:, None]
        gj = np.arange(padB)[None, :]
        keep = (gi < gj) & (gi < B) & (gj < B) & (ok.sum(-1) >= cfg.match.min_matches)
        a, b = np.nonzero(keep)
        if len(a) == 0:
            continue
        pairs_l.append(np.stack([a + r0, b], 1).astype(np.int32))
        pi_l.append(ii[a, b])
        pj_l.append(jj[a, b])
        pv_l.append(ok[a, b])
    if not pairs_l:
        return np.zeros((0, 2), np.int32), None, None, None
    return (np.concatenate(pairs_l), np.concatenate(pi_l), np.concatenate(pj_l),
            np.concatenate(pv_l))


def match_and_verify_stage(feats: FeatureSet, pairs: np.ndarray, intrinsics: np.ndarray,
                           cfg: PipelineConfig, device: torch.device, seed: int = 0,
                           prematched: tuple | None = None, mesh: Mesh | None = None) -> MatchGraph:
    """Match + geometric verification over pair blocks. Each pair's RANSAC
    draws are keyed by its global pair index, so results do not depend on
    the block size. With cfg.match.guided, each verified pair with a usable
    pose is re-matched inside the epipolar band of its E; those matches are
    its inliers. prematched: (idx_i, idx_j, valid) [E, M] from the ring
    matcher, verified in place of the block matcher's matches. With a mesh
    each process verifies its contiguous share of each block (the block
    size rounded up to a multiple of the process count), then all_gather."""
    E = len(pairs)
    P = cfg.match.block_pairs
    M = cfg.match.max_matches
    if mesh is not None:
        P = -(-P // mesh.size) * mesh.size
    out_idx_i = np.zeros((E, M), np.int32)
    out_idx_j = np.zeros((E, M), np.int32)
    out_inlier = np.zeros((E, M), bool)
    out_ninl = np.zeros(E, np.int32)
    out_nh = np.zeros(E, np.int32)
    out_rvec = np.zeros((E, 3), np.float32)
    out_tvec = np.zeros((E, 3), np.float32)
    out_ok = np.zeros(E, bool)
    out_pose_ok = np.zeros(E, bool)

    # Keypoints are response-sorted with validity masks: bucket the keypoint
    # axis down to the occupancy (power of 2, floor 512); indices are
    # prefix-stable.
    N_eff = _bucket_keypoints(int(feats.valid.sum(axis=1).max()), feats.valid.shape[1])
    desc, valid, xy = feats.desc[:, :N_eff], feats.valid[:, :N_eff], feats.xy[:, :N_eff]
    intr = intrinsics.astype(np.float32)
    # Each image takes part in O(N) pairs: below _DEVICE_FEATURE_CACHE_BYTES
    # its features go to the device once and each pair block gathers them
    # there; above it each pair block is sliced on the host and moved.
    on_device = desc.nbytes + xy.nbytes <= _DEVICE_FEATURE_CACHE_BYTES
    if on_device:
        desc_all, valid_all, xy_all, intr_all = (
            torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (desc, valid, xy, intr))

    for s in range(0, E, P):
        e = min(s + P, E)
        lo, rows = s, np.arange(s, e)
        if mesh is not None:
            # This process's share of the block; a short or empty share is
            # padded with the block's last pair (its rows are dropped).
            share = -(-(e - s) // mesh.size)
            lo = s + mesh.rank * share
            rows = np.minimum(np.arange(lo, lo + share), e - 1)
        if on_device:
            bi = torch.from_numpy(pairs[rows, 0].astype(np.int64)).to(device)
            bj = torch.from_numpy(pairs[rows, 1].astype(np.int64)).to(device)
            di, vi, dj, vj = desc_all[bi], valid_all[bi], desc_all[bj], valid_all[bj]
            xy_i, xy_j, intr_i, intr_j = xy_all[bi], xy_all[bj], intr_all[bi], intr_all[bj]
        else:
            bi, bj = pairs[rows, 0], pairs[rows, 1]
            di, vi, dj, vj, xy_i, xy_j, intr_i, intr_j = (
                torch.from_numpy(a).to(device)
                for a in (desc[bi], valid[bi], desc[bj], valid[bj], xy[bi], xy[bj], intr[bi], intr[bj]))
        if prematched is not None:
            pm = PairMatches(*(torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)
                               for a in prematched))
        else:
            pm = match_block(di, vi, dj, vj, cfg.match)
        uv_i = torch.gather(xy_i, 1, pm.idx_i.long()[..., None].expand(-1, -1, 2))
        uv_j = torch.gather(xy_j, 1, pm.idx_j.long()[..., None].expand(-1, -1, 2))
        geom = verify_block(lo, uv_i, uv_j, pm.valid, intr_i, intr_j, cfg.ransac, seed)
        idx_i, idx_j, inliers, ninl = pm.idx_i, pm.idx_j, geom.inliers, geom.num_inliers
        if cfg.match.guided:
            pm_g = guided_match_block(di, vi, xy_i, dj, vj, xy_j, geom.E, intr_i, intr_j, cfg.match)
            # Rotation-degenerate edges (pose_ok False) carry a meaningless E.
            use = geom.ok & geom.pose_ok
            idx_i = torch.where(use[:, None], pm_g.idx_i, idx_i)
            idx_j = torch.where(use[:, None], pm_g.idx_j, idx_j)
            inliers = torch.where(use[:, None], pm_g.valid, inliers)
            ninl = torch.where(use, pm_g.valid.sum(-1).to(ninl.dtype), ninl)

        outs = (idx_i, idx_j, inliers, ninl, geom.num_h_inliers, geom.rvec, geom.tvec, geom.ok,
                geom.pose_ok)
        if mesh is not None:   # the shares in rank order: pairs [s, e) then padding
            outs = tuple(all_gather_rows(t, mesh) for t in outs)
        for dst, t in zip((out_idx_i, out_idx_j, out_inlier, out_ninl, out_nh, out_rvec, out_tvec,
                           out_ok, out_pose_ok), outs):
            dst[s:e] = t[:e - s].cpu().numpy()

    enough = out_ninl >= cfg.ransac.min_inliers
    return MatchGraph(
        pairs=pairs, idx_i=out_idx_i, idx_j=out_idx_j, inlier=out_inlier,
        num_inliers=out_ninl, num_h_inliers=out_nh,
        rvec=out_rvec, tvec=out_tvec, ok=out_ok & enough,
        pose_ok=out_pose_ok & enough,
    )


_DENSIFY_REACH_BUDGET = 50_000_000  # nnz cap on the reachability matrix


def densify_candidate_pairs(
    pairs_ok: np.ndarray, num_images: int, max_scale: int = 8, per_node: int = 2,
) -> np.ndarray:
    """Candidate pairs along a power-of-2 graph-distance ladder (copy of
    sfm_tpu's; scipy.sparse on the host).

    Top-k retrieval (vocab tree) spends its whole candidate budget on an
    image's nearest appearance neighbours, so a sequential or orbit capture
    gets a narrow band graph whose drift no downstream solver can see. For
    scale s = 1..max_scale each node proposes its frontier extremes at graph
    distance (2^(s-1), 2^s] of the VERIFIED graph (for a band graph, the two
    ring directions); verification keeps what the matcher can certify.
    Capture-order-free: only graph structure is used.

    Returns deduped [K, 2] (i < j) candidates excluding existing pairs.
    """
    import scipy.sparse as sp

    if len(pairs_ok) == 0 or max_scale <= 0:
        return np.zeros((0, 2), np.int64)
    n = num_images
    A = sp.csr_matrix(
        (np.ones(len(pairs_ok) * 2, np.bool_),
         (np.concatenate([pairs_ok[:, 0], pairs_ok[:, 1]]),
          np.concatenate([pairs_ok[:, 1], pairs_ok[:, 0]]))),
        shape=(n, n), dtype=np.bool_)
    reach = (A + sp.identity(n, dtype=np.bool_, format="csr")).astype(np.bool_)
    out = []
    for _ in range(max_scale):
        new = (reach @ reach).astype(np.bool_)
        # Frontier = reachable at <= 2^s hops but not <= 2^(s-1) (new is a
        # superset of reach because reach includes the identity).
        fr = (new.astype(np.int8) - reach.astype(np.int8)).tocsr()
        fr.eliminate_zeros()
        ptr, cols = fr.indptr, fr.indices
        counts = np.diff(ptr)
        rows = np.where(counts > 0)[0]
        if len(rows) == 0:
            break
        first = cols[ptr[rows]]
        out.append(np.stack([rows, first], 1))
        if per_node >= 2:
            last = cols[ptr[rows + 1] - 1]
            out.append(np.stack([rows, last], 1))
        reach = new
        if reach.nnz > _DENSIFY_REACH_BUDGET:
            break
    if not out:
        return np.zeros((0, 2), np.int64)
    cand = np.concatenate(out).astype(np.int64)
    cand = cand[cand[:, 0] != cand[:, 1]]
    cand = np.unique(np.stack([cand.min(1), cand.max(1)], 1), axis=0)
    have = (pairs_ok.astype(np.int64).min(1) << 32) | pairs_ok.astype(np.int64).max(1)
    key = (cand[:, 0] << 32) | cand[:, 1]
    return cand[~np.isin(key, have)]


def append_match_graph(g: MatchGraph, g_new: MatchGraph) -> tuple[MatchGraph, int]:
    """Append g_new's verified edges to g, conforming the correspondence
    width (columns beyond g's budget are truncated; narrower blocks are
    zero-padded with inlier=False)."""
    keep = g_new.ok
    if not keep.any():
        return g, 0

    def cat(a, b):
        b = b[keep]
        if a.ndim == 2 and b.shape[1] != a.shape[1]:
            if b.shape[1] > a.shape[1]:
                b = b[:, :a.shape[1]]
            else:
                out = np.zeros((b.shape[0], a.shape[1]), b.dtype)
                out[:, :b.shape[1]] = b
                b = out
        return np.concatenate([a, b], axis=0)

    pose_ok = g.pose_ok if g.pose_ok is not None else np.ones(len(g.pairs), bool)
    new_pose_ok = (g_new.pose_ok if g_new.pose_ok is not None
                   else np.ones(len(g_new.pairs), bool))
    merged = MatchGraph(
        pairs=cat(g.pairs, g_new.pairs), idx_i=cat(g.idx_i, g_new.idx_i),
        idx_j=cat(g.idx_j, g_new.idx_j), inlier=cat(g.inlier, g_new.inlier),
        num_inliers=cat(g.num_inliers, g_new.num_inliers),
        num_h_inliers=cat(g.num_h_inliers, g_new.num_h_inliers),
        rvec=cat(g.rvec, g_new.rvec), tvec=cat(g.tvec, g_new.tvec),
        ok=cat(g.ok, g_new.ok), pose_ok=cat(pose_ok, new_pose_ok),
    )
    return merged, int(keep.sum())


def densify_graph(
    feats: FeatureSet, graph: MatchGraph, intrinsics: np.ndarray,
    cfg: PipelineConfig, num_images: int, device: torch.device, seed: int = 1,
    mesh: Mesh | None = None,
) -> MatchGraph:
    """Graph-distance-ladder densification pass: propose, verify, append.
    See densify_candidate_pairs for why pruned pair modes need this."""
    cand = densify_candidate_pairs(
        graph.pairs[graph.ok], num_images,
        max_scale=cfg.match.densify_scales, per_node=cfg.match.densify_per_node,
    )
    if len(cand) == 0:
        return graph
    g_new = match_and_verify_stage(feats, cand, intrinsics, cfg, device, seed=seed, mesh=mesh)
    graph, added = append_match_graph(graph, g_new)
    if cfg.verbose:
        print(f"[sfm_tpu_torch] densify: {added}/{len(cand)} ladder pairs verified "
              f"-> {int(graph.ok.sum())} edges")
    return graph
