"""The plain SIFT reference against the port's CPU path (its plain
versions) at a tiny size: the frozen copy bit for bit. (Its parts against
independently written ones: test_portbench_sift_independent.py.)"""

import dataclasses
import types

import torch

from conftest import tiny_cell
from portbench import gen
from portbench.reference import sift as ref_sift

CPU = torch.device("cpu")


def test_sift_copy_is_the_ports_extraction():
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops.sift import extract_features

    cfg = SiftConfig(max_keypoints=512, max_candidates=2048, desc_per_octave=256, num_octaves=3)
    spec = dict(tiny_cell("r16k-features").config["views"], views=2)
    img = gen.blob_views(spec, gen.generator(11, CPU), CPU)
    hw = torch.full((2, 2), img.shape[1], dtype=torch.int32)
    got = extract_features(img, cfg, hw)
    want = ref_sift.extract_features(img, types.SimpleNamespace(**dataclasses.asdict(cfg)), hw)
    assert int(want.valid.sum()) > 50
    assert all(torch.equal(a, b) for a, b in zip(got, want))
