"""The benchmark's one generator: rendered views, made on the device from
the seed, with a torch.Generator, in a few large calls.

Every seed gets the same sizes (views, image size, blobs and splats): the
seed draws only where the blobs lie and their splats' offsets, signs,
amplitudes and sizes, so the work of a run does not depend on its seed.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def look_at(centres: torch.Tensor) -> torch.Tensor:
    """World -> camera rotations [V, 3, 3] of cameras at centres [V, 3]
    looking at the origin, image y pointing down the world's y axis."""
    z = -centres / centres.norm(dim=1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=centres.dtype, device=centres.device).expand_as(z)
    x = torch.linalg.cross(up, z)
    x = x / x.norm(dim=1, keepdim=True)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], 1)


def blob_views(spec: dict, g: torch.Generator, device) -> torch.Tensor:
    """spec["views"] square views of spec["image_size"] pixels of a 3-D blob
    scene: spec["blobs"] parents uniform in a cube of half-width
    spec["extent"], each a cluster of spec["children"] Gaussian splats of
    fixed amplitude and world size (so appearance is viewpoint-invariant),
    seen from an orbit of radius spec["radius"] over spec["arc_fraction"]
    of a turn, focal spec["focal"]. A splat is separable, so a view is one
    product [H, n] @ [n, W] of its splats' row and column profiles plus a
    low-frequency background, clipped to [0, 1]. Returns [V, S, S] float32."""
    f32 = torch.float32
    V, S, n_child = spec["views"], spec["image_size"], spec["children"]
    B = spec["blobs"]
    parents = spec["extent"] * (2 * torch.rand(B, 3, generator=g, device=device) - 1)
    off = 0.035 * torch.randn(B, n_child, 3, generator=g, device=device)
    off[:, 0] = 0.0
    sign = torch.where(torch.rand(B, n_child, generator=g, device=device) < 0.5, -1.0, 1.0)
    amp = (0.35 + 0.65 * torch.rand(B, n_child, generator=g, device=device)) * sign
    size = 0.02 + 0.025 * torch.rand(B, n_child, generator=g, device=device)
    X = (parents[:, None] + off).reshape(-1, 3)
    amp, size = amp.reshape(-1), size.reshape(-1)
    ang = 2 * math.pi * spec["arc_fraction"] * torch.arange(V, device=device, dtype=f32) / V
    centres = torch.stack([spec["radius"] * torch.sin(ang), 0.3 * torch.sin(2 * ang),
                           spec["radius"] * torch.cos(ang)], 1)
    R = look_at(centres)
    pix = torch.arange(S, device=device, dtype=f32) + 0.5
    bg = 0.45 + (0.05 * torch.sin(pix / 37.0))[None, :] * torch.cos(pix / 53.0)[:, None]
    views = torch.empty(V, S, S, device=device, dtype=f32)
    for v in range(V):
        Xc = (X - centres[v]) @ R[v].T
        depth = Xc[:, 2]
        ok = depth > 0.5
        zs = torch.where(ok, depth, torch.ones_like(depth))
        u = spec["focal"] * Xc[:, 0] / zs + S / 2
        w = spec["focal"] * Xc[:, 1] / zs + S / 2
        sig2 = 2 * (spec["focal"] * size / zs) ** 2 + 1e-6
        gx = torch.exp(-(pix[None, :] - u[:, None]) ** 2 / sig2[:, None])        # [n, W]
        gy = torch.exp(-(pix[None, :] - w[:, None]) ** 2 / sig2[:, None])        # [n, H]
        a = torch.where(ok, 0.35 * amp, torch.zeros_like(amp))
        views[v] = (bg + (gy * a[:, None]).T @ gx).clamp_(0.0, 1.0)
    return views
