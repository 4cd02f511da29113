"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their wrappers.

Every kernel of the port lives in ``sfm_tpu_torch/csrc/`` and is compiled
with ``nvcc`` into one shared library with a plain C interface, loaded with
``ctypes`` at first use and cached under ``sfm_tpu_torch/build/`` by a hash
of the sources. Nothing is compiled or loaded at import time, so the package
imports (and its CPU tests run) on machines without a GPU or a CUDA toolkit.

Wrapper contract (one Python function per kernel):

- a tensor on the CPU goes to the kernel's plain PyTorch version, which sits
  beside the wrapper in the same module;
- a CUDA tensor launches the kernel on ``torch.cuda.current_stream()``, or
  the wrapper raises: there is no fallback;
- inputs are checked for device, dtype, shape and contiguity; outputs are
  allocated with ``torch.empty``;
- each launch adds one to ``LAUNCHES[name]``, and nothing else does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {
    "dog_extrema_scores": 0,
    "match_topk2": 0,
    "fused_ne_payloads": 0,
    "fused_cost_sums": 0,
    "cam_segment_sum": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argtypes (every pointer and the stream are c_void_p).
_SIGNATURES = {
    "sfm_dog_extrema": (_P, _P, _I, _I, _I, _I, _F, _P),
    "sfm_match_topk2": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    "sfm_fused_ne_payloads": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P),
    "sfm_fused_cost_sums": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _I, _P, _P),
    "sfm_segment_sum": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
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
            out = Path(tmp) / so.name
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out),
                   *[str(f) for f in files if f.suffix == ".cu"]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
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
    LAUNCHES[name] += 1


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
