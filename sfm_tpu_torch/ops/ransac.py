"""Batched fixed-size RANSAC (port of sfm_tpu/ops/ransac.py).

A static batch of hypotheses is solved and scored in one go ([..., B, M]
error matrix), no data-dependent trip count. Drawing the minimal sets is
split from scoring: ``draw_minimal_sets`` draws them (Gumbel-top-k on
uniforms from a seeded ``torch.Generator``), ``ransac`` takes the indices.
Tests can therefore feed this package and the JAX package the same draws.
"""

from __future__ import annotations

import hashlib
from typing import Callable, NamedTuple

import torch


class RansacResult(NamedTuple):
    model: torch.Tensor        # best model (solver-shaped)
    inliers: torch.Tensor      # [..., M] bool
    num_inliers: torch.Tensor  # [...]
    ok: torch.Tensor           # [...] enough inliers


def _generator_seed(seed: int, pair_index: int, tag: str) -> int:
    blob = f"{seed}:{pair_index}:{tag}".encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "little") & ((1 << 63) - 1)


def draw_minimal_sets(seed: int, pair_index: int, mask: torch.Tensor, num_hypotheses: int,
                      k: int, tag: str) -> torch.Tensor:
    """[B, k] distinct indices into the valid entries of mask [M] for pair
    `pair_index`, deterministic in (seed, pair_index, tag). With fewer than
    k valid entries, indices repeat into invalid slots (callers guard via
    the inlier threshold)."""
    gen = torch.Generator(device=mask.device)
    gen.manual_seed(_generator_seed(seed, pair_index, tag))
    u = torch.rand((num_hypotheses, mask.shape[0]), generator=gen, device=mask.device)
    u = torch.where(mask[None, :], u, torch.full((), -1.0, device=mask.device))
    return torch.sort(u, dim=-1, descending=True, stable=True).indices[:, :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., M, D], idx [..., B, k] -> [..., B, k, D]."""
    lead = idx.shape[:-2]
    B, k = idx.shape[-2:]
    flat = idx.reshape(*lead, B * k)
    out = torch.gather(x, -2, flat[..., None].expand(*lead, B * k, x.shape[-1]))
    return out.reshape(*lead, B, k, x.shape[-1])


def _select(models: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """models [..., B, *S], best [...] -> [..., *S]."""
    n_lead = best.dim()
    tail = models.shape[n_lead + 1:]
    index = best.reshape(*best.shape, 1, *([1] * len(tail))).expand(*best.shape, 1, *tail)
    return torch.gather(models, n_lead, index).squeeze(n_lead)


def ransac(idx: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor,
           solver: Callable, error_fn: Callable, threshold_sq,
           min_inliers: int) -> RansacResult:
    """Score the hypotheses solved from minimal sets idx [..., B, k].

    x1/x2 [..., M, D], mask [..., M]; solver maps [..., B, k, D] pairs to
    models [..., B, *S]; error_fn(models [..., B, *S], x1 [..., 1, M, D],
    x2) -> squared errors [..., B, M]. MSAC score (truncated error).
    threshold_sq: a float or a tensor of the leading shape [...].
    """
    models = solver(_take_rows(x1, idx), _take_rows(x2, idx))
    errs = error_fn(models, x1[..., None, :, :], x2[..., None, :, :])
    thr = torch.as_tensor(threshold_sq, dtype=errs.dtype, device=errs.device)[..., None, None]
    inl = (errs < thr) & mask[..., None, :]
    counts = inl.sum(-1)
    score = torch.where(inl, errs, thr).sum(-1)
    best = torch.argmin(torch.where(counts > 0, score, torch.full((), float("inf"), device=errs.device)), dim=-1)
    best_inl = _select(inl, best)
    n = torch.gather(counts, -1, best[..., None])[..., 0]
    return RansacResult(model=_select(models, best), inliers=best_inl, num_inliers=n, ok=n >= min_inliers)


def irls_refit(model: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor,
               fit_fn: Callable, error_fn: Callable, threshold_sq, iters: int):
    """LO-RANSAC-style refinement: refit on the current inliers with a
    threshold annealed from 4x to 1x; keep the model with the most inliers.
    threshold_sq: a float or a tensor of the leading shape [...].
    Returns (model, inliers [..., M])."""
    thr = torch.as_tensor(threshold_sq, dtype=x1.dtype, device=x1.device)[..., None]
    best_model = model
    best_count = ((error_fn(model, x1, x2) < thr) & mask).sum(-1)
    for it in range(iters):
        anneal = 4.0 ** (1.0 - it / max(iters - 1, 1))
        errs = error_fn(model, x1, x2)
        w = ((errs < thr * anneal) & mask).to(x1.dtype)
        model = fit_fn(x1, x2, w)
        count = ((error_fn(model, x1, x2) < thr) & mask).sum(-1)
        better = count >= best_count
        best_model = torch.where(better[..., None, None], model, best_model)
        best_count = torch.where(better, count, best_count)
    errs = error_fn(best_model, x1, x2)
    return best_model, (errs < thr) & mask
