"""Exporters (port of sfm_tpu/scene/export.py): COLMAP-compatible text and
binary sparse models, a PLY cloud, and a reader for the binary model.

Host-side writers over the Reconstruction state; formats follow the public
COLMAP sparse-model layouts so downstream MVS/visualization tools accept
the output directly. The bytes are sfm_tpu's on the same Reconstruction.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sfm_tpu_torch.geometry.rotations import aa_to_quat
from sfm_tpu_torch.scene.state import Reconstruction


def _quat(rvec: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of one world->camera angle-axis, in fp32 as stored."""
    return aa_to_quat(torch.from_numpy(np.asarray(rvec, np.float32))).numpy()


def write_ply(rec: Reconstruction, path: str, colors: np.ndarray | None = None) -> None:
    """Sparse point cloud as ASCII PLY."""
    pts = rec.points[rec.point_valid]
    if colors is None:
        colors = np.full((len(pts), 3), 200, dtype=np.uint8)
    else:
        colors = colors[rec.point_valid].astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\nend_header\n")
        for p, c in zip(pts, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")


def _colmap_camera_row(rec: Reconstruction, i: int):
    """(model_name, model_id, width, height, params) for camera i — the same
    model-selection rule as the text writer (never silently drop fy or k2)."""
    fx, fy, cx, cy, k1, k2 = (float(v) for v in rec.intrinsics[i])
    if rec.image_sizes is not None:
        w, h = int(rec.image_sizes[i][0]), int(rec.image_sizes[i][1])
    else:
        w, h = int(round(cx * 2)), int(round(cy * 2))
    if k1 == 0.0 and k2 == 0.0:
        return "PINHOLE", 1, w, h, [fx, fy, cx, cy]
    if fx == fy and k2 == 0.0:
        return "SIMPLE_RADIAL", 2, w, h, [fx, cx, cy, k1]
    if fx == fy:
        return "RADIAL", 3, w, h, [fx, cx, cy, k1, k2]
    return "OPENCV", 4, w, h, [fx, fy, cx, cy, k1, k2, 0.0, 0.0]


def write_colmap_bin(rec: Reconstruction, out_dir: str) -> None:
    """cameras.bin / images.bin / points3D.bin — COLMAP's default binary
    sparse-model layout (what downstream MVS/visualization tools read unless
    told otherwise). Same content as write_colmap_text."""
    import struct

    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(out_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(rec.intrinsics)))
        for i in range(len(rec.intrinsics)):
            _name, model_id, w, h, params = _colmap_camera_row(rec, i)
            f.write(struct.pack("<iiQQ", i + 1, model_id, w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))

    obs_by_image: dict[int, list[int]] = {}
    for row in range(rec.num_observations):
        obs_by_image.setdefault(int(rec.obs_image[row]), []).append(row)
    point2d_idx = np.zeros(max(rec.num_observations, 1), dtype=np.int64)

    reg = [i for i in range(len(rec.registered)) if rec.registered[i]]
    with open(os.path.join(out_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(reg)))
        for i in reg:
            q = _quat(rec.rvecs[i]).astype(np.float64)
            t = np.asarray(rec.tvecs[i], np.float64)
            name = rec.image_names[i] if i < len(rec.image_names) else f"image_{i:06d}.jpg"
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *t))
            f.write(struct.pack("<i", i + 1))
            f.write(name.encode() + b"\x00")
            rows = obs_by_image.get(i, [])
            f.write(struct.pack("<Q", len(rows)))
            for idx, r in enumerate(rows):
                u, v = (float(x) for x in rec.obs_uv[r])
                f.write(struct.pack("<ddq", u, v, int(rec.obs_point[r]) + 1))
                point2d_idx[r] = idx

    errs = rec.reprojection_errors() if rec.num_observations else np.zeros(0)
    track_rows: dict[int, list[int]] = {}
    for row in range(rec.num_observations):
        track_rows.setdefault(int(rec.obs_point[row]), []).append(row)
    valid = [p for p in range(len(rec.points)) if rec.point_valid[p]] if rec.points is not None else []
    with open(os.path.join(out_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(valid)))
        for pid in valid:
            p = np.asarray(rec.points[pid], np.float64)
            rows = track_rows.get(pid, [])
            err = float(np.mean([errs[r] for r in rows])) if rows else 0.0
            f.write(struct.pack("<q", pid + 1))
            f.write(struct.pack("<3d", *p))
            f.write(struct.pack("<3B", 200, 200, 200))
            f.write(struct.pack("<d", err))
            f.write(struct.pack("<Q", len(rows)))
            for r in rows:
                f.write(struct.pack("<ii", int(rec.obs_image[r]) + 1, int(point2d_idx[r])))


def read_colmap_bin(in_dir: str):
    """Read a COLMAP binary sparse model. Returns
    (cameras, images, points3D) dicts keyed by id:
      cameras[id]  = dict(model_id, width, height, params)
      images[id]   = dict(qvec, tvec, camera_id, name, xys, point3D_ids)
      points3D[id] = dict(xyz, rgb, error, image_ids, point2D_idxs)
    Round-trip partner of write_colmap_bin; also imports models produced by
    COLMAP itself (same public layout)."""
    import struct

    _NUM_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8}

    cameras = {}
    with open(os.path.join(in_dir, "cameras.bin"), "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            k = _NUM_PARAMS[model_id]
            params = struct.unpack(f"<{k}d", f.read(8 * k))
            cameras[cid] = dict(model_id=model_id, width=w, height=h, params=list(params))

    images = {}
    with open(os.path.join(in_dir, "images.bin"), "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (iid,) = struct.unpack("<i", f.read(4))
            qvec = struct.unpack("<4d", f.read(32))
            tvec = struct.unpack("<3d", f.read(24))
            (cam_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (m,) = struct.unpack("<Q", f.read(8))
            xys = np.zeros((m, 2))
            p3d = np.zeros(m, np.int64)
            for k in range(m):
                x, y, pid = struct.unpack("<ddq", f.read(24))
                xys[k] = (x, y)
                p3d[k] = pid
            images[iid] = dict(qvec=np.asarray(qvec), tvec=np.asarray(tvec),
                               camera_id=cam_id, name=name.decode(), xys=xys,
                               point3D_ids=p3d)

    points3D = {}
    with open(os.path.join(in_dir, "points3D.bin"), "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (pid,) = struct.unpack("<q", f.read(8))
            xyz = struct.unpack("<3d", f.read(24))
            rgb = struct.unpack("<3B", f.read(3))
            (err,) = struct.unpack("<d", f.read(8))
            (m,) = struct.unpack("<Q", f.read(8))
            img_ids = np.zeros(m, np.int32)
            p2d = np.zeros(m, np.int32)
            for k in range(m):
                img_ids[k], p2d[k] = struct.unpack("<ii", f.read(8))
            points3D[pid] = dict(xyz=np.asarray(xyz), rgb=rgb, error=err,
                                 image_ids=img_ids, point2D_idxs=p2d)
    return cameras, images, points3D


def write_colmap_text(rec: Reconstruction, out_dir: str) -> None:
    """cameras.txt / images.txt / points3D.txt in COLMAP sparse text format."""
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for i in range(len(rec.intrinsics)):
            fx, fy, cx, cy, k1, k2 = (float(v) for v in rec.intrinsics[i])
            if rec.image_sizes is not None:
                w, h = int(rec.image_sizes[i][0]), int(rec.image_sizes[i][1])
            else:  # legacy fallback: principal point assumed centered
                w, h = int(round(cx * 2)), int(round(cy * 2))
            # Pick the COLMAP model that actually represents the intrinsics —
            # never silently drop fy or k2.
            if k1 == 0.0 and k2 == 0.0:
                f.write(f"{i + 1} PINHOLE {w} {h} {fx:.6f} {fy:.6f} {cx:.6f} {cy:.6f}\n")
            elif fx == fy and k2 == 0.0:
                f.write(f"{i + 1} SIMPLE_RADIAL {w} {h} {fx:.6f} {cx:.6f} {cy:.6f} {k1:.8f}\n")
            elif fx == fy:
                f.write(f"{i + 1} RADIAL {w} {h} {fx:.6f} {cx:.6f} {cy:.6f} {k1:.8f} {k2:.8f}\n")
            else:
                f.write(
                    f"{i + 1} OPENCV {w} {h} {fx:.6f} {fy:.6f} {cx:.6f} {cy:.6f} "
                    f"{k1:.8f} {k2:.8f} 0.0 0.0\n"
                )

    # Group observations by image for the POINTS2D lines.
    obs_by_image: dict[int, list[int]] = {}
    if rec.num_observations:
        for row, img in enumerate(rec.obs_image):
            obs_by_image.setdefault(int(img), []).append(row)

    # POINT2D_IDX in points3D.txt TRACK[] must index into the image's
    # POINTS2D line (0-based row order below), not the detector keypoint id.
    point2d_idx = np.zeros(rec.num_observations, dtype=np.int64)
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for i in range(len(rec.registered)):
            if not rec.registered[i]:
                continue
            q = _quat(rec.rvecs[i])
            t = rec.tvecs[i]
            name = rec.image_names[i] if i < len(rec.image_names) else f"image_{i:06d}.jpg"
            f.write(
                f"{i + 1} {q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f} "
                f"{t[0]:.8f} {t[1]:.8f} {t[2]:.8f} {i + 1} {name}\n"
            )
            rows = obs_by_image.get(i, [])
            parts = []
            for idx, r in enumerate(rows):
                u, v = rec.obs_uv[r]
                parts.append(f"{u:.3f} {v:.3f} {int(rec.obs_point[r]) + 1}")
                point2d_idx[r] = idx
            f.write(" ".join(parts) + "\n")

    errs = rec.reprojection_errors() if rec.num_observations else np.zeros(0)
    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] (IMAGE_ID, POINT2D_IDX)\n")
        if rec.points is None:
            return
        track_rows: dict[int, list[int]] = {}
        for row, pid in enumerate(rec.obs_point if rec.num_observations else []):
            track_rows.setdefault(int(pid), []).append(row)
        for pid in range(len(rec.points)):
            if not rec.point_valid[pid]:
                continue
            p = rec.points[pid]
            rows = track_rows.get(pid, [])
            err = float(np.mean([errs[r] for r in rows])) if rows else 0.0
            track = " ".join(f"{int(rec.obs_image[r]) + 1} {int(point2d_idx[r])}" for r in rows)
            f.write(f"{pid + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 200 200 200 {err:.4f} {track}\n")
