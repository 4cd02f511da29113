"""Traffic kind "photos": `sfm_tpu_torch.pipeline.stages.extract_stage`
over rendered photos laid out as the pipeline's ingest lays out a
landscape photo whose long side is the canvas: the content at the
top-left of a square zero canvas, `valid_hw` its (height, width).

Set-up renders traffic["views"] square views of the configuration's blob
layers on the device (`gen.blob_views`, see `render`) and keeps the top
views["content_height"] rows of each as the photo; the rows below are
the canvas's zero padding. The views go to the host as image batches of
traffic["views_per_call"] views. The window calls extract_stage on the
batches in turn, as the "features" kind does (its `window`). The last
answer of each batch is compared, view by view, with the plain reference
(`portbench/reference/sift.py`, on the device, TF32 off) by the
"features" kind's comparison. The reference runs one view at a time, so
that its full sort of a view's score maps fits beside the program's
memory.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench import gen
from portbench.kinds import features
from portbench.reference import sift as ref

PROGRAM = features.PROGRAM
window = features.window
program_outputs = features.program_outputs


def render(spec: dict, seed: int, device) -> np.ndarray:
    """[V, S, S] float32 canvases: each the top spec["content_height"] rows
    of a view, zero below. A view is gen.blob_views' background plus the
    splats of every layer of spec["layers"] (each a blob scene of its own
    blobs, cube and orbit, rendered with the views' other settings),
    clipped to [0, 1]: a far layer of fine splats and a near one of coarse
    splats, so that every octave's scale has structure."""
    g = gen.generator(seed, device)
    bg = gen.blob_views({**spec, **spec["layers"][0], "blobs": 0}, g, device)   # the background alone
    views = bg.clone()
    for layer in spec["layers"]:
        views += gen.blob_views(dict(spec, **layer), g, device) - bg
    views.clamp_(0.0, 1.0)[:, spec["content_height"]:] = 0.0
    return views.cpu().numpy()


def setup(cell, seed: int, device) -> features.State:
    from sfm_tpu_torch.pipeline.ingest import ImageBatch

    spec = dict(cell.config["views"], views=cell.traffic["views"])
    views = render(spec, seed, device)
    V, S = views.shape[0], views.shape[1]
    per = cell.traffic["views_per_call"]
    hw = np.tile(np.asarray([spec["content_height"], S], np.int32), (per, 1))
    # The renderer's principal point is the square's centre.
    intr = np.tile(np.asarray([spec["focal"], spec["focal"], S / 2, S / 2, 0, 0], np.float32), (per, 1))
    batches = [ImageBatch(canvases=views[s:s + per], valid_hw=hw, scales=np.ones(per, np.float32),
                          intrinsics=intr, names=[f"view{v}" for v in range(s, s + per)])
               for s in range(0, V, per)]
    state = features.State(sift=dict(cell.config["sift"]), batches=batches, device=device)
    features._extract(state, 0)   # the one call shape the window uses
    state.last.clear()
    return state


def reference_features(state: features.State, batch, tf32: bool = False) -> list:
    """The plain reference on the device, one view at a time: one dict of
    tensors per view."""
    cfg = types.SimpleNamespace(**state.sift)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = []
        for i in range(batch.canvases.shape[0]):
            img = torch.from_numpy(np.ascontiguousarray(batch.canvases[i:i + 1])).to(state.device)
            hw = torch.from_numpy(np.ascontiguousarray(batch.valid_hw[i:i + 1])).to(state.device)
            f = ref.extract_features(img, cfg, hw)
            out.append(dict(xy=f.xy[0], sigma=f.sigma[0], angle=f.angle[0], desc=f.desc[0], valid=f.valid[0]))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def answers(state: features.State, outputs: dict | None = None) -> list:
    """The numbers of every view of each batch's last answer."""
    outputs = state.last if outputs is None else outputs
    rows = []
    for b, fs in sorted(outputs.items()):
        if b not in state.refs:
            state.refs[b] = reference_features(state, state.batches[b])
        got = fs if isinstance(fs, list) else features._views_of(fs, state.device)
        rows += features.compare_views(got, state.refs[b])
    return rows


def control_outputs(state: features.State) -> dict:
    """The reference in the program's place with TF32 on, one answer per batch."""
    return {b: reference_features(state, batch, tf32=True) for b, batch in enumerate(state.batches)}
