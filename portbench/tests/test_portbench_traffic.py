"""The generator: one seed gives the same views, two seeds different ones,
and every seed the same sizes (the work of a run does not depend on it)."""

import json

import torch

from conftest import ROOT
from portbench import gen

CPU = torch.device("cpu")
BIG = 2**31 + 12345   # seeds may pass 32 signed bits


def test_views_repeat_for_a_seed_and_differ_across_seeds():
    conf = json.loads((ROOT / "portbench/configs/rome16k.json").read_text())
    spec = dict(conf["views"], views=3, image_size=64, focal=76.8, blobs=50)
    a = gen.blob_views(spec, gen.generator(BIG, CPU), CPU)
    b = gen.blob_views(spec, gen.generator(BIG, CPU), CPU)
    c = gen.blob_views(spec, gen.generator(BIG + 1, CPU), CPU)
    assert a.shape == (3, 64, 64) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0 and float(a.std()) > 0.01


def test_look_at_is_a_rotation_facing_the_origin():
    centres = torch.tensor([[4.0, 0.3, 0.0], [0.0, -0.2, 4.0], [-2.8, 0.0, -2.8]])
    R = gen.look_at(centres)
    eye = torch.eye(3).expand(3, 3, 3)
    assert torch.allclose(R @ R.transpose(1, 2), eye, atol=1e-6)
    assert torch.allclose(torch.linalg.det(R), torch.ones(3), atol=1e-6)
    z = (R @ (-centres)[:, :, None])[:, :, 0]
    assert bool((z[:, 2] > 0).all()) and torch.allclose(z[:, :2], torch.zeros(3, 2), atol=1e-5)
