"""Vocabulary-tree pair pruning (port of sfm_tpu/ops/vocab.py).

Every level of the tree is a batched spherical k-means whose assignment is
a Gram product (descriptors and centers are unit-norm, so argmax dot ==
argmin L2); quantization descends all descriptors of all images with one
[rows, centers] product per level; TF-IDF scoring is one [B, words] x
[words, B] product. The output is, per image, the top-k most similar
images: the pruned pair list that replaces the O(N^2) exhaustive sweep.

None of this is a Pallas kernel in the JAX package: the products are
``torch.matmul`` (fp32 where sfm_tpu computes at full precision; where it
computes in bf16, the operands are rounded to bf16 and the products summed
in fp32).

Divergences from the JAX package:
- k-means seeding draws its uniforms from a CPU ``torch.Generator`` keyed
  by (seed, level, node), where sfm_tpu splits a jax.random key per node
  group: same algorithm, other random centers (tests feed sfm_tpu's tree
  to the port where they compare words);
- the nodes of a level run as one batch over a padded node axis (in slices
  of _GROUP_BYTES), and quantization and reassignment in chunks of fixed
  row counts; there is no power-of-2 bucketing of chunk, node or group
  sizes (it only shared TPU compiles);
- term frequencies are counted with ``index_add_`` (integer counts, exact
  in fp32); top-k takes ops.detect.top_k_stable (jax.lax.top_k's tie order).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from sfm_tpu_torch.config import VocabConfig
from sfm_tpu_torch.ops.detect import top_k_stable


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 values of x rounded to bf16: a product of two such operands in
    fp32 is a bf16-input product with fp32 accumulation."""
    return x.to(torch.bfloat16).float()


def _kmeans_step(centers: torch.Tensor, data: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One weighted spherical k-means step for a batch of nodes.

    centers [G, k, D], data [G, N, D], w [G, N] (0 = padding row) -> new
    centers [G, k, D]: assignment by argmax of data @ centers^T, update by
    the weighted mean, empty clusters re-seeded from the valid points
    farthest from their center, then renormalized."""
    k = centers.shape[1]
    sim = torch.bmm(data, centers.transpose(1, 2))                        # [G, N, k]
    assign = torch.argmax(sim, dim=2)
    onehot = torch.nn.functional.one_hot(assign, k).to(data.dtype) * w[..., None]
    sums = torch.bmm(onehot.transpose(1, 2), data)                        # [G, k, D]
    counts = onehot.sum(1)                                                # [G, k]
    new = sums / counts.clamp_min(1e-8)[..., None]
    far_scores = torch.where(w > 0, -sim.max(dim=2).values, torch.full((), -torch.inf, device=data.device))
    far_idx = top_k_stable(far_scores, k)[1]
    far = torch.gather(data, 1, far_idx[..., None].expand(-1, -1, data.shape[2]))
    new = torch.where(counts[..., None] > 0, new, far)
    return new / torch.linalg.vector_norm(new, dim=2, keepdim=True).clamp_min(1e-8)


def _kmeans(u: torch.Tensor, data: torch.Tensor, w: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """Weighted spherical k-means of a batch of nodes: data [G, N, D], w
    [G, N], u [G, N] seeding uniforms -> centers [G, k, D]. Seeds are the
    valid rows with the k largest uniforms (Gumbel-max over the weight
    mask), as in sfm_tpu."""
    seed_scores = torch.where(w > 0, u, torch.full((), -1.0, device=u.device))
    idx = top_k_stable(seed_scores, k)[1]
    centers = torch.gather(data, 1, idx[..., None].expand(-1, -1, data.shape[2]))
    for _ in range(iters):
        centers = _kmeans_step(centers, data, w)
    return centers


def _node_generator(seed: int, level: int, node: int) -> torch.Generator:
    blob = f"{seed}:{level}:{node}:vocab".encode()
    gen = torch.Generator()
    gen.manual_seed(int.from_bytes(hashlib.sha256(blob).digest()[:8], "little") & ((1 << 63) - 1))
    return gen


def _reassign_level(ctrs: torch.Tensor, desc: torch.Tensor, node: torch.Tensor, branching: int) -> torch.Tensor:
    """Advance assignments one level: each row compares only against its
    current node's children."""
    cand = node[:, None] * branching + torch.arange(branching, device=desc.device)[None, :]   # [N, b]
    sim = torch.bmm(ctrs[cand], desc[:, :, None])[..., 0]                                   # [N, b]
    return torch.gather(cand, 1, torch.argmax(sim, dim=1, keepdim=True))[:, 0]


def _descend_chunk(centers: list, desc: torch.Tensor, branching: int) -> torch.Tensor:
    """Tree descent of one chunk: per level, the similarities against all of
    the level's centers in one product (bf16 operands, fp32 sums, as in
    sfm_tpu: they only feed an argmax over the b children), each row then
    takes its node's child window."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    b = branching
    desc_bf = _bf16(desc)
    for ctrs in centers:
        ctrs_bf = _bf16(ctrs)
        cand = node[:, None] * b + torch.arange(b, device=desc.device)[None, :]       # [N, b]
        if ctrs.shape[0] <= 8192:
            sim = torch.gather(desc_bf @ ctrs_bf.T, 1, cand)                          # [N, b]
        else:
            sim = torch.bmm(ctrs_bf[cand], desc_bf[:, :, None])[..., 0]
        node = torch.gather(cand, 1, torch.argmax(sim, dim=1, keepdim=True))[:, 0]
    return node


class VocabTree:
    """Flat-array hierarchical k-means tree.

    centers[level] has shape [branching^level * branching, D] laid out so the
    children of node n at level l are rows n*branching:(n+1)*branching of
    centers[l]. Leaves = branching^depth visual words.
    """

    _CHUNK = 65536  # descent rows per chunk: the [chunk, words] similarities stay ~1 GB

    def __init__(self, centers: list, branching: int, depth: int):
        self.centers = centers
        self.branching = branching
        self.depth = depth
        self.num_words = branching**depth
        self.train_words = None

    def quantize(self, desc: torch.Tensor) -> torch.Tensor:
        """desc [N, D] -> leaf/word id [N] (int64), in chunks of _CHUNK rows."""
        return torch.cat([_descend_chunk(self.centers, desc[s:s + self._CHUNK], self.branching)
                          for s in range(0, desc.shape[0], self._CHUNK)])


_MAX_NODE_TRAIN = 8192   # per-node k-means training row cap
_REASSIGN_CHUNK = 262144  # rows per reassignment ([chunk, b, D] gathered centers)
_GROUP_BYTES = 1 << 30   # padded [nodes, rows, D] fp32 training data of one k-means batch


def build_vocab_tree(seed: int, training_desc: torch.Tensor, cfg: VocabConfig,
                     train_w: np.ndarray | None = None, verbose: bool = False) -> VocabTree:
    """Hierarchical spherical k-means over training descriptors [N, D] (on
    their device). train_w: optional [N] 0/1 weights, zero rows are padding.
    Node n of level l seeds its k-means from the generator keyed (seed, l, n)."""
    b, depth = cfg.branching, cfg.depth
    device = training_desc.device
    N_train, D = training_desc.shape
    if train_w is None:
        train_w = np.ones(N_train, np.float32)
    valid_rows = np.where(train_w > 0)[0]
    centers: list = []
    assignments = torch.zeros(N_train, dtype=torch.int64, device=device)
    num_nodes = 1
    for lvl in range(depth):
        t0 = time.perf_counter()
        assign_np = assignments.cpu().numpy()
        order = np.argsort(assign_np, kind="stable")
        order = order[train_w[order] > 0]
        bounds = np.searchsorted(assign_np[order], np.arange(num_nodes + 1))
        node_rows = []
        for n in range(num_nodes):
            rows = order[bounds[n]:bounds[n + 1]]
            if len(rows) < b:
                # Sparse node: pad the training set with other VALID rows only
                # (zero-weight padding rows must never enter k-means).
                rows = valid_rows[: max(b, len(rows))]
            if len(rows) > _MAX_NODE_TRAIN:
                # An evenly strided subsample bounds the per-node k-means.
                rows = rows[:: (len(rows) + _MAX_NODE_TRAIN - 1) // _MAX_NODE_TRAIN]
            node_rows.append(rows)
        t1 = time.perf_counter()
        lvl_centers = []
        cap = max(len(r) for r in node_rows)
        step = max(1, _GROUP_BYTES // (cap * D * 4))
        for g0 in range(0, num_nodes, step):
            group = range(g0, min(g0 + step, num_nodes))
            idx = np.zeros((len(group), cap), np.int64)
            wts = np.zeros((len(group), cap), np.float32)
            u = torch.zeros((len(group), cap))
            for gi, n in enumerate(group):
                rows = node_rows[n]
                idx[gi, :len(rows)] = rows
                wts[gi, :len(rows)] = 1.0
                u[gi, :len(rows)] = torch.rand(len(rows), generator=_node_generator(seed, lvl, n))
            data = training_desc[torch.from_numpy(idx).to(device)]
            lvl_centers.append(_kmeans(u.to(device), data, torch.from_numpy(wts).to(device),
                                       b, cfg.kmeans_iters).reshape(-1, D))
        ctrs = torch.cat(lvl_centers)                                      # [num_nodes * b, D]
        centers.append(ctrs)
        t2 = time.perf_counter()
        # Re-assign every training row to the new level's nodes, in chunks.
        assignments = torch.cat([
            _reassign_level(ctrs, training_desc[s:s + _REASSIGN_CHUNK], assignments[s:s + _REASSIGN_CHUNK], b)
            for s in range(0, N_train, _REASSIGN_CHUNK)])
        if verbose:
            print(f"[sfm_tpu_torch]     vocab lvl {lvl}: group {t1 - t0:.2f}s, fit {t2 - t1:.2f}s, "
                  f"reassign {time.perf_counter() - t2:.2f}s ({num_nodes} nodes)")
        num_nodes *= b
    tree = VocabTree(centers, b, depth)
    # The last reassignment already placed every training row at its leaf:
    # those are the word ids a full descent would recompute.
    tree.train_words = assignments
    return tree


def bow_vectors(tree: VocabTree, desc: torch.Tensor, valid: torch.Tensor,
                words: torch.Tensor | None = None) -> torch.Tensor:
    """TF-IDF bag-of-words vectors: desc [B, N, D], valid [B, N] ->
    L2-normalized [B, num_words]. words: optional precomputed [B, N] word ids."""
    B, N, D = desc.shape
    W = tree.num_words
    if words is None:
        words = tree.quantize(desc.reshape(B * N, D)).reshape(B, N)
    seg = (torch.arange(B, device=desc.device)[:, None] * W + words).reshape(-1)
    tf = torch.zeros(B * W, device=desc.device).index_add_(0, seg, valid.reshape(-1).float()).reshape(B, W)
    # IDF from this corpus (reference-class trees bake IDF from training).
    df = (tf > 0).sum(0).float()
    idf = torch.log(B / df.clamp_min(1.0) + 1.0)
    v = tf * idf[None, :]
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp_min(1e-8)


def _topk_neighbors(bow: torch.Tensor, k: int) -> torch.Tensor:
    """Per-image top-k most similar images by TF-IDF dot product (bf16
    operands, fp32 sums). [B, k]."""
    bf = _bf16(bow)
    sim = bf @ bf.T
    sim = sim - 2.0 * torch.eye(sim.shape[0], dtype=sim.dtype, device=sim.device)   # no self-match
    return top_k_stable(sim, k)[1]


def spread_ranks(k: int, num_candidates: int, scales: int) -> list[int]:
    """Stratified retrieval budget: k distinct similarity ranks in
    [0, num_candidates) (copy of sfm_tpu's).

    The first ceil(k/2) ranks are the plain nearest ranks; the rest are the
    tops of geometric rank bands out to ~(k/2)·2^scales, so the budget buys
    long-range edges that overlap instead of random far pairs.
    """
    n = num_candidates
    if k >= n or scales <= 0:
        return list(range(min(k, n)))
    k_near = max(1, (k + 1) // 2)
    ranks = list(range(min(k_near, n)))
    k_far = k - len(ranks)
    if k_far > 0:
        lo = float(max(len(ranks), 1))
        hi = float(min(n - 1, max(lo * (2.0 ** scales), lo + 1)))
        taken = set(ranks)
        for i in range(k_far):
            r = int(round(lo * (hi / lo) ** ((i + 1) / k_far)))
            r = min(max(r, 0), n - 1)
            while r in taken and r < n - 1:   # collisions walk outward
                r += 1
            while r in taken and r > 0:       # ...or inward at the boundary
                r -= 1
            taken.add(r)
            ranks.append(r)
    return sorted(set(ranks))[:k]


def vocab_tree_pairs(feats, cfg: VocabConfig, device, seed: int = 0,
                     verbose: bool = False) -> np.ndarray:
    """Candidate pair list via vocab-tree retrieval (replaces exhaustive).

    feats: pipeline FeatureSet (host numpy). Returns [E, 2] image pairs (i < j).
    """
    device = torch.device(device)
    # Descriptors rounded to fp16 as sfm_tpu ships them (unit-norm histograms
    # in [0, ~0.5] keep ~3 decimal digits), on the device, then fp32.
    desc = torch.from_numpy(np.ascontiguousarray(feats.desc)).to(device).half().float()
    valid = torch.from_numpy(np.ascontiguousarray(feats.valid)).to(device)
    B, N, D = desc.shape

    # Training sample: the first descriptors of every image; invalid slots
    # are zero-weight padding.
    per = min(cfg.training_desc_per_image, N)
    train = desc[:, :per].reshape(B * per, D)
    train_w = np.asarray(feats.valid[:, :per]).reshape(-1).astype(np.float32)

    t0 = time.perf_counter()
    tree = build_vocab_tree(seed, train, cfg, train_w=train_w, verbose=verbose)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    k = min(cfg.num_neighbors, B - 1)
    # The training slice was quantized by the build itself; only the other
    # columns descend the tree.
    words = torch.zeros((B, N), dtype=torch.int64, device=device)
    words[:, :per] = tree.train_words.reshape(B, per)
    if per < N:
        words[:, per:] = tree.quantize(desc[:, per:].reshape(B * (N - per), D)).reshape(B, N - per)
    bow = bow_vectors(tree, desc, valid, words=words)
    # Stratified retrieval (spread_ranks): the device ranks the top m, the
    # budget keeps the band tops; only the [B, k] neighbour ids come back.
    ranks = spread_ranks(k, B - 1, cfg.retrieval_spread_scales)
    m = (ranks[-1] + 1) if ranks else k
    nbrs = _topk_neighbors(bow, m)[:, ranks].cpu().numpy()
    t2 = time.perf_counter()
    if verbose:
        print(f"[sfm_tpu_torch]   vocab: build {t1 - t0:.2f}s, "
              f"quantize+score {t2 - t1:.2f}s (B={B}, {tree.num_words} words)")

    ii = np.repeat(np.arange(B), k)
    jj = nbrs.reshape(-1)
    keep = ii != jj
    a = np.minimum(ii, jj)[keep]
    b_ = np.maximum(ii, jj)[keep]
    pairs = np.unique(np.stack([a, b_], axis=1), axis=0)
    return pairs.astype(np.int32)
