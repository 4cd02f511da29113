"""K2: fused descriptor distance + top-2 (csrc/match_topk.cu).

Replaces sfm_tpu/kernels/match_topk.py match_topk2. Batched over pairs: the
leading dimension of every argument is the pair.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.kernels import check, launch, on_cuda, ptr

BIG = 1e9


def match_topk2_plain(da: torch.Tensor, db: torch.Tensor, vb: torch.Tensor):
    """(d1, d2, idx) of each row of da [P, N1, 128] among the valid rows of
    db [P, N2, 128] (vb [P, N2] bool), squared L2 on bf16-rounded values
    with fp32 accumulation; norms also from the bf16-rounded values, as in
    the TPU kernel."""
    a = da.to(torch.bfloat16).float()
    b = db.to(torch.bfloat16).float()
    gram = a @ b.transpose(1, 2)
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    dist = na[:, :, None] + nb[:, None, :] - 2.0 * gram
    dist = torch.where(vb[:, None, :], dist.clamp_min(0.0), torch.full((), BIG, device=da.device))
    d1, idx = dist.min(dim=2)
    d2 = dist.scatter(2, idx[:, :, None], BIG).min(dim=2).values
    return d1, d2, idx.to(torch.int32)


def match_topk2(da: torch.Tensor, db: torch.Tensor, vb: torch.Tensor):
    """da [P, N1, 128], db [P, N2, 128] float, vb [P, N2] bool ->
    (d1 [P, N1] f32, d2 [P, N1] f32, idx [P, N1] int32)."""
    if not on_cuda(da):
        return match_topk2_plain(da, db, vb)
    P, N1, D = da.shape
    N2 = db.shape[1]
    if D != 128:
        raise ValueError(f"descriptor width must be 128, got {D}")
    a16 = da.to(torch.bfloat16).contiguous()
    b16 = db.to(torch.bfloat16).contiguous()
    v8 = vb.to(torch.uint8).contiguous()
    dev = da.device
    check(a16, "da", torch.bfloat16, (P, N1, D), dev)
    check(b16, "db", torch.bfloat16, (P, N2, D), dev)
    check(v8, "vb", torch.uint8, (P, N2), dev)
    d1 = torch.empty((P, N1), dtype=torch.float32, device=dev)
    d2 = torch.empty((P, N1), dtype=torch.float32, device=dev)
    idx = torch.empty((P, N1), dtype=torch.int32, device=dev)
    launch("sfm_match_topk2", "match_topk2",
           ptr(a16), ptr(b16), ptr(v8), P, N1, N2, ptr(d1), ptr(d2), ptr(idx))
    return d1, d2, idx
