"""Image ingest (copy of sfm_tpu/pipeline/ingest.py; numpy only): load,
grayscale, resize cap, canvas pad, EXIF-prior intrinsics.

Host-side (IO is irregular); emits fixed-shape [B, S, S] canvases + per-image
valid (h, w), so every image of a run has the same canvas shape. The focal prior
follows the reference-class fallback f ~= 1.2 * max(w, h) when no EXIF data
is available.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.geometry.cameras import NUM_INTRINSICS

_FOCAL_PRIOR_FACTOR = 1.2
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".pgm")


@dataclass
class ImageBatch:
    canvases: np.ndarray      # [B, S, S] float32 grayscale in [0, 1]
    valid_hw: np.ndarray      # [B, 2] int32 (h, w) of real content
    scales: np.ndarray        # [B] canvas pixels -> original pixels factor
    intrinsics: np.ndarray    # [B, 6] prior intrinsics in CANVAS pixel units
    names: list


def _to_gray_f32(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        img = img[..., :3] @ np.asarray([0.299, 0.587, 0.114], dtype=np.float32)
    img = img.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return img


def _load_file(path: str) -> np.ndarray:
    import cv2  # host-side IO only (SURVEY.md §2.2)

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(f"could not read image: {path}")
    return img


# EXIF tag ids (TIFF/EP standard).
_TAG_EXIF_IFD = 0x8769
_TAG_FOCAL_LENGTH = 0x920A          # rational, millimetres
_TAG_FOCAL_35MM = 0xA405            # short, 35mm-equivalent focal length
_TAG_FPX_RES = 0xA20E               # FocalPlaneXResolution (px per unit)
_TAG_FP_RES_UNIT = 0xA210           # 2=inch, 3=cm, 4=mm, 5=um
_FP_UNIT_MM = {2: 25.4, 3: 10.0, 4: 1.0, 5: 1e-3}


def exif_focal_px(path: str) -> float | None:
    """Focal length in ORIGINAL pixel units from EXIF metadata, or None.

    Reference-class ingest seeds intrinsics from EXIF before falling back to
    f = 1.2*max(w, h) (SURVEY.md §2.2). Two derivations, tried in order:
      1. FocalLengthIn35mmFilm: f_px = f35 / 36mm * image_width_px.
      2. FocalLength (mm) * FocalPlaneXResolution (px per unit): converts the
         physical focal length through the sensor's pixel pitch.
    Metadata is read without decoding pixel data (PIL lazy open).
    """
    try:
        from PIL import Image

        with Image.open(path) as im:
            width_px = im.size[0]
            exif = im.getexif()
            ifd = exif.get_ifd(_TAG_EXIF_IFD)
    except Exception:
        return None

    f35 = ifd.get(_TAG_FOCAL_35MM)
    if f35:
        return float(f35) / 36.0 * float(width_px)

    f_mm = ifd.get(_TAG_FOCAL_LENGTH)
    xres = ifd.get(_TAG_FPX_RES)
    unit_mm = _FP_UNIT_MM.get(int(ifd.get(_TAG_FP_RES_UNIT, 0) or 0))
    if f_mm and xres and unit_mm:
        px_per_mm = float(xres) / unit_mm
        return float(f_mm) * px_per_mm
    return None


def load_images(images: Sequence, cfg: SiftConfig) -> ImageBatch:
    """images: dir path | list of paths | list of arrays -> padded batch."""
    if isinstance(images, (str, os.PathLike)):
        d = str(images)
        paths = sorted(
            os.path.join(d, f) for f in os.listdir(d) if f.lower().endswith(_IMAGE_EXTS)
        )
        arrays = [_load_file(p) for p in paths]
        names = [os.path.basename(p) for p in paths]
        focal_priors = [exif_focal_px(p) for p in paths]
    else:
        arrays, names, focal_priors = [], [], []
        for i, im in enumerate(images):
            if isinstance(im, (str, os.PathLike)):
                arrays.append(_load_file(str(im)))
                names.append(os.path.basename(str(im)))
                focal_priors.append(exif_focal_px(str(im)))
            else:
                arrays.append(np.asarray(im))
                names.append(f"image_{i:06d}")
                focal_priors.append(None)
    if not arrays:
        raise ValueError("no images provided")

    S = cfg.image_max_dim
    B = len(arrays)
    canvases = np.zeros((B, S, S), dtype=np.float32)
    valid_hw = np.zeros((B, 2), dtype=np.int32)
    scales = np.ones(B, dtype=np.float32)
    intr = np.zeros((B, NUM_INTRINSICS), dtype=np.float32)

    for i, raw in enumerate(arrays):
        g = _to_gray_f32(raw)
        h, w = g.shape
        scale = 1.0
        if max(h, w) > S:
            scale = S / max(h, w)
            new_h, new_w = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
            g = _resize_bilinear(g, new_h, new_w)
            h, w = new_h, new_w
        canvases[i, :h, :w] = g
        valid_hw[i] = (h, w)
        scales[i] = 1.0 / scale  # canvas px * scales -> original px
        if focal_priors[i]:  # EXIF prior, converted to canvas pixel units
            f = float(focal_priors[i]) * scale
        else:
            f = _FOCAL_PRIOR_FACTOR * max(h, w)
        intr[i] = (f, f, w / 2.0, h / 2.0, 0.0, 0.0)

    return ImageBatch(canvases=canvases, valid_hw=valid_hw, scales=scales, intrinsics=intr, names=names)


def resolve_paths(images: Sequence) -> list[str] | None:
    """If `images` is a directory or list of paths, return the path list."""
    if isinstance(images, (str, os.PathLike)):
        d = str(images)
        return sorted(
            os.path.join(d, f) for f in os.listdir(d) if f.lower().endswith(_IMAGE_EXTS)
        )
    if len(images) and all(isinstance(im, (str, os.PathLike)) for im in images):
        return [str(p) for p in images]
    return None


def _resize_bilinear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    try:
        import cv2

        return cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA)
    except ImportError:
        ys = (np.arange(new_h) + 0.5) * img.shape[0] / new_h - 0.5
        xs = (np.arange(new_w) + 0.5) * img.shape[1] / new_w - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, img.shape[0] - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, img.shape[1] - 1)
        y1 = np.minimum(y0 + 1, img.shape[0] - 1)
        x1 = np.minimum(x0 + 1, img.shape[1] - 1)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        return (
            img[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + img[np.ix_(y0, x1)] * (1 - fy) * fx
            + img[np.ix_(y1, x0)] * fy * (1 - fx)
            + img[np.ix_(y1, x1)] * fy * fx
        ).astype(np.float32)
