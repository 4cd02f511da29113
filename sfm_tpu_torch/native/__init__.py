"""Native (C++) host components and their ctypes bindings (port of
sfm_tpu/native).

``tracks.cpp`` (a copy of sfm_tpu/native/tracks.cpp) is compiled with g++
at first use into ``sfm_tpu_torch/build/``, keyed by a hash of the source,
the flags and the host CPU (``-march=native`` code must not load on another
CPU), and loaded with ctypes. A failed build raises: there is no silent Python
fallback on the main path (the pure-Python union-find in scene/tracks.py is
the plain version the tests hold the native builder against).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "tracks.cpp"
BUILD_DIR = _HERE.parent / "build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lib: ctypes.CDLL | None = None
_build_lock = threading.Lock()   # clusters on threads: the first builds, the others wait


def host_cpu_id() -> str:
    """The machine type plus the CPU's model name and feature flags (the
    first of each in /proc/cpuinfo, where there is one): what -march=native
    compiles for."""
    ident = [platform.machine(), platform.processor()]
    try:
        with open("/proc/cpuinfo") as f:
            seen = set()
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part") and key not in seen:
                    seen.add(key)
                    ident.append(line.strip())
    except OSError:
        pass
    return "\n".join(ident)


def library_path() -> Path:
    """Where the library built from this source, with these flags, for this
    CPU lives."""
    key = _SRC.read_bytes() + "\0".join((*GXX_FLAGS, host_cpu_id())).encode()
    return BUILD_DIR / f"libsfm_native_{hashlib.sha256(key).hexdigest()[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """Build (once per source, flags and CPU) and load the native library;
    callers on other threads wait for the first."""
    if _lib is not None:
        return _lib
    with _build_lock:
        return _lib if _lib is not None else _build_and_load()


def _build_and_load() -> ctypes.CDLL:
    global _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / so.name
            proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(out)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(out, so)
    lib = ctypes.CDLL(str(so))
    lib.sfm_build_tracks.restype = ctypes.c_int64
    lib.sfm_build_tracks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                    # pairs, ok
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # idx_i, idx_j, inlier
        ctypes.c_int64, ctypes.c_int64,                      # num_edges, m
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # num_images, max_kp, min_length
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # obs_image, obs_kp, track_id
        ctypes.c_int64, ctypes.c_void_p,                     # cap_rows, num_tracks_out
    ]
    _lib = lib
    return lib
