"""Traffic kind "features": `sfm_tpu_torch.pipeline.stages.extract_stage`
over rendered views.

Set-up renders traffic["views"] views of the configuration's blob scene
on the device and hands them to the host as image batches of
traffic["views_per_call"] views, as the pipeline's ingest hands canvases
to the stage. The window calls extract_stage on the batches in turn (the
stage uploads each chunk of 8, extracts on the device and returns host
arrays). The last answer of each batch is compared: every view's
keypoints and descriptors against the plain reference's (a frozen copy of
the SIFT layer) on the same canvases, on the device, with TF32 off.
"""

from __future__ import annotations

import math
import time
import types
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import gen
from portbench.reference import sift as ref

# the port's modules this kind drives (portbench.nojax loads them)
PROGRAM = ("sfm_tpu_torch.config", "sfm_tpu_torch.pipeline.ingest", "sfm_tpu_torch.pipeline.stages")
CHUNK = 8             # views per device batch of the stage (pipeline/stages._FEATURE_CHUNK)
POS_TOL_PX = 1e-3     # a keypoint is matched when position, blur and angle agree this closely
SIGMA_TOL = 1e-3
ANGLE_TOL = 1e-3


@dataclass
class State:
    sift: dict
    batches: list            # the program's ImageBatch objects
    device: torch.device
    last: dict = field(default_factory=dict)   # batch index -> the stage's last FeatureSet
    refs: dict = field(default_factory=dict)   # batch index -> the reference's features


def setup(cell, seed: int, device) -> State:
    from sfm_tpu_torch.pipeline.ingest import ImageBatch

    spec = dict(cell.config["views"], views=cell.traffic["views"])
    views = gen.blob_views(spec, gen.generator(seed, device), device).cpu().numpy()
    V, S = views.shape[0], views.shape[1]
    per = cell.traffic["views_per_call"]
    intr = np.tile(np.asarray([spec["focal"], spec["focal"], S / 2, S / 2, 0, 0], np.float32), (per, 1))
    batches = [ImageBatch(canvases=views[s:s + per], valid_hw=np.full((per, 2), S, np.int32),
                          scales=np.ones(per, np.float32), intrinsics=intr,
                          names=[f"view{v}" for v in range(s, s + per)])
               for s in range(0, V, per)]
    state = State(sift=dict(cell.config["sift"]), batches=batches, device=device)
    _extract(state, 0)   # the one chunk shape the window uses
    state.last.clear()
    return state


def _pipeline_config(state: State):
    from sfm_tpu_torch.config import PipelineConfig, SiftConfig

    return PipelineConfig(sift=SiftConfig(**state.sift), verbose=False)


def _extract(state: State, b: int) -> int:
    from sfm_tpu_torch.pipeline.stages import extract_stage

    state.last[b] = extract_stage(state.batches[b], _pipeline_config(state), state.device)
    return state.batches[b].canvases.shape[0]


def window(state: State, seconds: float) -> tuple[dict, list, float]:
    t0 = time.perf_counter()
    deadline = t0 + seconds
    images, calls, b = 0, [], 0
    while time.perf_counter() < deadline:
        n = _extract(state, b)
        images += n
        S = state.batches[b].canvases.shape[1]
        calls.append(dict(images=n, chunk=CHUNK, image_size=S, octaves=state.sift["num_octaves"],
                          levels=state.sift["scales_per_octave"] + 3,
                          upsample=state.sift["upsample_first_octave"]))
        b = (b + 1) % len(state.batches)
    wall = time.perf_counter() - t0
    return dict(images=images, calls=len(calls)), calls, wall


def reference_features(state: State, canvases: np.ndarray, tf32: bool = False) -> list:
    """The plain reference on the device, in the stage's chunks of 8: one
    dict of tensors per view."""
    cfg = types.SimpleNamespace(**state.sift)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = []
        for s in range(0, canvases.shape[0], CHUNK):
            img = torch.from_numpy(np.ascontiguousarray(canvases[s:s + CHUNK])).to(state.device)
            hw = torch.full((img.shape[0], 2), img.shape[1], dtype=torch.int32, device=state.device)
            f = ref.extract_features(img, cfg, hw)
            out += [dict(xy=f.xy[i], sigma=f.sigma[i], angle=f.angle[i], desc=f.desc[i], valid=f.valid[i])
                    for i in range(img.shape[0])]
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _views_of(fs, device) -> list:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return [dict(xy=t(fs.xy[i]), sigma=t(fs.sigma[i]), angle=t(fs.angle[i]), desc=t(fs.desc[i]),
                 valid=t(fs.valid[i])) for i in range(fs.xy.shape[0])]


def _unmatched(a: dict, b: dict) -> tuple[int, int, float]:
    """(a's valid keypoints, those with no keypoint of b at the same place,
    blur and angle, the largest descriptor gap of the matched ones)."""
    ia, ib = torch.nonzero(a["valid"]).flatten(), torch.nonzero(b["valid"]).flatten()
    if ia.numel() == 0:
        return 0, 0, 0.0
    if ib.numel() == 0:
        return ia.numel(), ia.numel(), 0.0
    dpos = torch.cdist(a["xy"][ia].double(), b["xy"][ib].double())
    dsig = (a["sigma"][ia, None] - b["sigma"][None, ib]).abs().double()
    dang = torch.remainder(a["angle"][ia, None] - b["angle"][None, ib] + math.pi, 2 * math.pi) - math.pi
    cost = dpos + dsig + dang.abs().double()
    j = cost.argmin(1)
    rows = torch.arange(ia.numel(), device=cost.device)
    ok = (dpos[rows, j] <= POS_TOL_PX) & (dsig[rows, j] <= SIGMA_TOL * b["sigma"][ib][j].abs().double()) \
        & (dang.abs()[rows, j] <= ANGLE_TOL)
    gap = 0.0
    if bool(ok.any()):
        gap = float((a["desc"][ia[ok]] - b["desc"][ib[j[ok]]]).abs().max())
    return ia.numel(), int((~ok).sum()), gap


def compare_views(got: list, want: list) -> list:
    """Per view: kp_unmatched (the larger share, of either side's valid
    keypoints, without a counterpart on the other) and desc_gap (the
    largest element gap of matched descriptors)."""
    rows = []
    for g, w in zip(got, want):
        nw, miss_w, gap_w = _unmatched(w, g)
        ng, miss_g, gap_g = _unmatched(g, w)
        share = max(miss_w / nw if nw else float(ng > 0), miss_g / ng if ng else float(nw > 0))
        rows.append(dict(kp_unmatched=share, desc_gap=max(gap_w, gap_g)))
    return rows


def answers(state: State, outputs: dict | None = None) -> list:
    """The numbers of every view of each batch's last answer."""
    outputs = state.last if outputs is None else outputs
    rows = []
    for b, fs in sorted(outputs.items()):
        if b not in state.refs:
            state.refs[b] = reference_features(state, state.batches[b].canvases)
        want = state.refs[b]
        got = fs if isinstance(fs, list) else _views_of(fs, state.device)
        rows += compare_views(got, want)
    return rows


def control_outputs(state: State) -> dict:
    """The reference in the program's place with TF32 on, one answer per batch."""
    return {b: reference_features(state, batch.canvases, tf32=True) for b, batch in enumerate(state.batches)}


def program_outputs(state: State) -> dict:
    state.last.clear()
    for b in range(len(state.batches)):
        _extract(state, b)
    return dict(state.last)
