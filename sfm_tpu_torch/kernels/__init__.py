"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their wrappers.

Every kernel of the port lives in ``sfm_tpu_torch/csrc/``. At first use
each ``.cu`` source is compiled by its own ``nvcc`` process (all started
together), the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes`` and cached under ``sfm_tpu_torch/build/``
by a hash of the sources. Nothing is compiled or loaded at import time, so
the package imports (and its CPU tests run) on machines without a GPU or a
CUDA toolkit.

Wrapper contract (one Python function per kernel):

- a tensor on the CPU goes to the kernel's plain PyTorch version, which sits
  beside the wrapper in the same module;
- a CUDA tensor launches the kernel on ``torch.cuda.current_stream()``, or
  the wrapper raises: there is no fallback;
- inputs are checked for device, dtype, shape and contiguity; outputs are
  allocated with ``torch.empty``;
- each launch adds one to ``LAUNCHES[name]``, and nothing else does. Two
  launches run the device code of another kernel too and count for it
  where they do: ``fused_ne_payloads`` with the Schur-Jacobi blocks runs
  ``whw_cam_reduce``'s and adds one to its count as well; ``pcg_solve``
  past ``ba_kernels.MAX_CAMS`` cameras counts as ``pcg_solve_big`` (its
  coupling phase is ``schur_coupling_payloads_big``'s device code, as
  ``pcg_solve``'s is ``schur_coupling_matvec``'s).

Every BA kernel is built at two camera widths, 6 and 8 (intrinsics
refinement): K3, K5, K7, K11 and ``pcg_solve``, the large-camera-count set
K4, K6, K8 and K10, and the camera-sharded LM's entries of K3 and K11
(``fused_ne_sums``, K3's undamped sums; ``coupling_point_half`` /
``coupling_camera_half``, K11 cut at h). Each has a C entry point per width
(the 8-wide one named ``<entry>_w8``, the same arguments) and counts its
8-wide launches under ``<name>_w8`` (``pcg_solve_big_w8`` past
``MAX_CAMS``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {
    "dog_extrema_scores": 0,
    "sift_descriptors": 0,
    "match_topk2": 0,
    "fused_ne_payloads": 0,
    "fused_cost_sums": 0,
    "cam_segment_sum": 0,
    "whw_cam_reduce": 0,
    "schur_coupling_matvec": 0,
    "fused_ne_payloads_big": 0,
    "fused_cost_sums_big": 0,
    "whw_payloads_big": 0,
    "schur_coupling_payloads_big": 0,
    "pcg_solve": 0,
    "pcg_solve_big": 0,
    # The 8-wide instantiations (intrinsics refinement).
    "fused_ne_payloads_w8": 0,
    "fused_cost_sums_w8": 0,
    "whw_cam_reduce_w8": 0,
    "schur_coupling_matvec_w8": 0,
    "pcg_solve_w8": 0,
    "fused_ne_payloads_big_w8": 0,
    "fused_cost_sums_big_w8": 0,
    "whw_payloads_big_w8": 0,
    "schur_coupling_payloads_big_w8": 0,
    "pcg_solve_big_w8": 0,
    # The camera-sharded LM: K3's sharded mode and K11 cut at h, both widths.
    "fused_ne_sums": 0,
    "coupling_point_half": 0,
    "coupling_camera_half": 0,
    "fused_ne_sums_w8": 0,
    "coupling_point_half_w8": 0,
    "coupling_camera_half_w8": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argtypes (every pointer and the stream are c_void_p).
_SIGNATURES = {
    "sfm_dog_extrema": (_P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "sfm_sift_descriptors": (_P,) * 9 + (_I,) * 6 + (_P,),
    "sfm_match_topk2": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "sfm_fused_ne_payloads": (_P,) * 12 + (_I, _I, _I, _I, _F, _I, _I) + (_P,) * 8,
    "sfm_fused_cost_sums": (_P,) * 15 + (_I, _I, _I, _I, _F, _I, _I) + (_P,) * 6,
    "sfm_segment_sum": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "sfm_whw_cam_reduce": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "sfm_schur_coupling_matvec": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "sfm_fused_ne_payloads_big": (_P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P),
    "sfm_fused_cost_sums_big": (_P, _P, _P, _P, _P, _I, _I, _F, _P, _I, _P, _P),
    "sfm_whw_payloads_big": (_P, _P, _P, _I, _P, _P),
    "sfm_schur_coupling_payloads_big": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "sfm_pcg_blocks_per_sm": (_I, _I, ctypes.POINTER(_I)),
    "sfm_pcg_solve": (_P,) * 11 + (_I, _I, _I, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "sfm_fused_ne_sums": (_P,) * 11 + (_I, _I, _I, _I, _F, _I, _I) + (_P,) * 6,
    "sfm_coupling_point_half": (_P, _P, _P, _P, _I, _I, _P, _P),
    "sfm_coupling_camera_half": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
}
# The 8-wide twins take the same arguments.
WIDE_ENTRIES = ("sfm_fused_ne_payloads", "sfm_fused_cost_sums", "sfm_whw_cam_reduce",
                "sfm_schur_coupling_matvec", "sfm_pcg_blocks_per_sm", "sfm_pcg_solve",
                "sfm_fused_ne_sums", "sfm_coupling_point_half", "sfm_coupling_camera_half",
                "sfm_fused_ne_payloads_big", "sfm_fused_cost_sums_big", "sfm_whw_payloads_big",
                "sfm_schur_coupling_payloads_big")
_SIGNATURES.update({f"{e}_w8": _SIGNATURES[e] for e in WIDE_ENTRIES})

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
# Clusters of the divide-and-conquer pipeline run on threads
# (partition.parallel_clusters): the first of them builds and loads the
# library while the others wait, and every count is added under a lock
# (a ctypes call releases the GIL, and `+=` on a dict entry is a read and
# a write).
_build_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """Add one to LAUNCHES[name]: the only way a wrapper counts."""
    with _count_lock:
        LAUNCHES[name] += 1


def _source_files() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library; callers on
    other threads wait for the first."""
    if _lib is not None:
        return _lib
    with _build_lock:
        return _lib if _lib is not None else _build_and_load()


def _build_and_load() -> ctypes.CDLL:
    global _lib, build_seconds
    files = _source_files()
    digest = hashlib.sha256()
    for f in files:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    so = BUILD_DIR / f"libsfm_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objs, procs = [], []
            for f in files:
                if f.suffix != ".cu":
                    continue
                objs.append(str(Path(tmp) / (f.stem + ".o")))
                procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(f), "-o", objs[-1]],
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True))
            errors = []
            for proc in procs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"{' '.join(proc.args)} ({proc.returncode}):\n{err}")
            if errors:
                raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
            out = Path(tmp) / so.name
            proc = subprocess.run([nvcc, "-shared", "-o", str(out), *objs],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(out, so)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def launch(entry: str, name: str, *args) -> None:
    """Call C entry point `entry` on the current stream; raise on a CUDA error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    count_launch(name)


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`
    (None entries of `shape` match any size)."""
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_cuda(t: torch.Tensor) -> bool:
    """Kernel route for CUDA tensors, plain route for CPU tensors; any other
    device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain route for device {t.device}")
