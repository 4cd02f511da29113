"""K14 (subpixel_refine): its plain version against a float64 refinement
written anew, the kernel's own source run on the host against the plain
version, its launch plan, the arguments the wrapper hands the C entry, and
the wrapper's input checks.

The octave is synthetic: Gaussian blobs of 0.8-5 px blurred in closed form
to each level's sigma, so that the DoG has extrema inside the volume, at
its two end levels and at the image borders. The candidates are the plain
score map's extrema plus planted voxels on the border rows and columns and
on both end levels, which the refinement clamps inside.

Tolerance: 1e-4 px / level and the same `valid` on every candidate whose
decisions (the 0.6 step in every round, |offset| < 1, the contrast and the
two edge tests) lie more than 1e-3 (relative) from their thresholds in
float64. Nearer than that, fp32 rounding may flip a decision, and with it
the voxel or the verdict. Responses: 1e-5 relative.
"""

import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels import _SIGNATURES
from sfm_tpu_torch.kernels import subpixel_refine as k14
from sfm_tpu_torch.kernels.dog_extrema import scores_from_dog
from sfm_tpu_torch.ops.detect import pre_threshold

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "sfm_tpu_torch" / "csrc" / "subpixel_refine.cu"
ENTRY = "sfm_subpixel_refine"
POS_GAP = 1e-4
RESPONSE_GAP = 1e-5
MARGIN = 1e-3


def _octave(shape, seed: int, blobs: int = 40) -> np.ndarray:
    """Gaussian stacks [B, L, H, W] float32: blobs (amplitude +-0.2-1, std
    0.8-5 px, some centred on or beyond the borders) on a zero background,
    level i blurred to sigma 1.6 * 2^(i / 3) exactly (variances add)."""
    rng = np.random.default_rng(seed)
    B, L, H, W = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = np.zeros(shape)
    for b in range(B):
        for _ in range(blobs):
            cy, cx = rng.uniform(-1, H), rng.uniform(-1, W)
            s = rng.uniform(0.8, 5.0)
            a = rng.choice([-1.0, 1.0]) * rng.uniform(0.2, 1.0)
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            for lev in range(L):
                v = s * s + (1.6 * 2.0 ** (lev / 3)) ** 2
                out[b, lev] += a * s * s / v * np.exp(-d2 / (2 * v))
    return out.astype(np.float32)


def _candidates(gauss: np.ndarray, cfg: SiftConfig, seed: int):
    """(idx [B, K] int64, scores [B, K] float32): every extremum of the plain
    score map, then planted voxels on the border rows and columns and the
    two end levels (score 1), then a few dead slots (score 0)."""
    rng = np.random.default_rng(seed)
    B, L, H, W = gauss.shape
    g = torch.from_numpy(gauss)
    score = scores_from_dog(g[:, 1:] - g[:, :-1], pre_threshold(cfg)).reshape(B, -1).numpy()
    per = []
    for b in range(B):
        found = np.flatnonzero(score[b])
        lev = rng.choice([0, L - 2], 12)
        y = np.concatenate([rng.choice([0, 1, H - 2, H - 1], 6), rng.integers(0, H, 6)])
        x = np.concatenate([rng.integers(0, W, 6), rng.choice([0, 1, W - 2, W - 1], 6)])
        planted = (lev * H + y) * W + x
        dead = rng.integers(0, (L - 1) * H * W, 4)
        per.append((np.concatenate([found, planted, dead]),
                    np.concatenate([score[b, found], np.ones(12), np.zeros(4)])))
    K = max(i.size for i, _ in per)
    idx = np.zeros((B, K), np.int64)
    scores = np.zeros((B, K), np.float32)
    for b, (i, s) in enumerate(per):
        idx[b, :i.size], scores[b, :i.size] = i, s
    return idx, scores


def _refine64(gauss: np.ndarray, idx: np.ndarray, scores: np.ndarray, cfg: SiftConfig):
    """Float64 refinement, one candidate at a time: the DoG cube by slicing,
    central differences, numpy's solve. Returns the fields x, y, level,
    sigma, response, valid [N] and each candidate's smallest relative
    distance of a decision from its threshold."""
    G = gauss.astype(np.float64)
    B, L, H, W = G.shape
    K = idx.shape[1]
    thr = cfg.contrast_threshold / cfg.scales_per_octave
    r = cfg.edge_threshold
    out = {f: np.zeros(B * K) for f in ("x", "y", "level", "sigma", "response")}
    valid = np.zeros(B * K, bool)
    margin = np.full(B * K, np.inf)
    for t in range(B * K):
        b, flat = t // K, int(idx[t // K, t % K])
        lev = min(max(flat // (H * W), 1), L - 3)
        y = min(max(flat % (H * W) // W, 2), H - 3)
        x = min(max(flat % W, 2), W - 3)

        def cube():
            # D[k] = DoG level lev - 1 + k = G[lev + k] - G[lev - 1 + k]
            box = G[b, lev - 1:lev + 3, y - 1:y + 2, x - 1:x + 2]
            return box[1:] - box[:-1]

        off, grad = np.zeros(3), np.zeros(3)
        for _ in range(cfg.refine_iters):
            D = cube()
            grad = np.array([D[2, 1, 1] - D[0, 1, 1], D[1, 2, 1] - D[1, 0, 1], D[1, 1, 2] - D[1, 1, 0]]) / 2
            hess = np.empty((3, 3))
            for i in range(3):
                e = np.eye(3, dtype=int)[i]
                hess[i, i] = D[tuple(1 + e)] + D[tuple(1 - e)] - 2 * D[1, 1, 1]
                for j in range(i + 1, 3):
                    f = np.eye(3, dtype=int)[j]
                    hess[i, j] = hess[j, i] = (D[tuple(1 + e + f)] - D[tuple(1 + e - f)]
                                               - D[tuple(1 - e + f)] + D[tuple(1 - e - f)]) / 4
            off = np.clip(-np.linalg.solve(hess + 1e-6 * np.eye(3), grad), -1.5, 1.5)
            margin[t] = min(margin[t], np.min(np.abs(np.abs(off) - 0.6)) / 0.6)
            step = np.where(np.abs(off) > 0.6, np.sign(off), 0).astype(int)
            lev = min(max(lev + step[0], 1), L - 3)
            y = min(max(y + step[1], 2), H - 3)
            x = min(max(x + step[2], 2), W - 3)
        D = cube()
        c = D[1, 1, 1]
        contrast = c + 0.5 * grad @ off
        dyy = D[1, 2, 1] + D[1, 0, 1] - 2 * c
        dxx = D[1, 1, 2] + D[1, 1, 0] - 2 * c
        dyx = (D[1, 2, 2] - D[1, 2, 0] - D[1, 0, 2] + D[1, 0, 0]) / 4
        tr, det = dxx + dyy, dxx * dyy - dyx * dyx
        worst = np.max(np.abs(off))
        margin[t] = min(margin[t], abs(worst - 1.0), abs(abs(contrast) - thr) / thr,
                        abs(det) / max(abs(dxx * dyy) + dyx * dyx, 1e-300),
                        abs(tr * tr * r - (r + 1) ** 2 * det) / max((r + 1) ** 2 * abs(det), 1e-300))
        valid[t] = (scores[b, t % K] > 0 and worst < 1.0 and abs(contrast) >= thr
                    and det > 0 and tr * tr * r < (r + 1) ** 2 * det)
        out["level"][t], out["y"][t], out["x"][t] = lev + off[0], y + off[1], x + off[2]
        out["sigma"][t] = cfg.sigma0 * 2.0 ** ((lev + off[0]) / cfg.scales_per_octave)
        out["response"][t] = abs(contrast)
    return out, valid, margin


def _gaps(got, want: dict, want_valid: np.ndarray, robust: np.ndarray) -> list:
    """What differs, on the robust candidates, beyond the tolerances."""
    bad = []
    if (got.valid.numpy() != want_valid)[robust].any():
        bad.append("valid")
    for f in ("x", "y", "level"):
        if np.abs(getattr(got, f).double().numpy() - want[f])[robust].max() > POS_GAP:
            bad.append(f)
    for f in ("sigma", "response"):
        rel = np.abs(getattr(got, f).double().numpy() - want[f]) / np.maximum(np.abs(want[f]), 1e-30)
        if rel[robust & want_valid].max() > RESPONSE_GAP:
            bad.append(f)
    return bad


CASES = [((2, 6, 40, 56), SiftConfig()),
         ((2, 6, 36, 44), SiftConfig(refine_iters=5)),
         ((3, 7, 24, 24), SiftConfig(scales_per_octave=4, edge_threshold=6.0))]


@pytest.fixture(scope="module", params=range(len(CASES)), ids=["default", "five_rounds", "seven_levels"])
def case(request):
    shape, cfg = CASES[request.param]
    gauss = _octave(shape, seed=sum(shape))
    idx, scores = _candidates(gauss, cfg, seed=shape[2])
    want, want_valid, margin = _refine64(gauss, idx, scores, cfg)
    return gauss, idx, scores, cfg, want, want_valid, margin


def test_plain_refinement_equals_float64_refinement(case):
    gauss, idx, scores, cfg, want, want_valid, margin = case
    got = k14.subpixel_refine_plain(torch.from_numpy(gauss), torch.from_numpy(idx), torch.from_numpy(scores), cfg)
    robust = margin > MARGIN
    assert robust.mean() > 0.9
    assert _gaps(got, want, want_valid, robust) == []
    # Coverage: survivors and rejections, and voxels clamped at the borders
    # and both end levels.
    assert want_valid[robust].sum() >= 10 and (~want_valid[robust]).sum() >= 10
    B, L, H, W = gauss.shape
    flat = idx.reshape(-1)
    lev, y, x = flat // (H * W), flat % (H * W) // W, flat % W
    for clamped in (lev == 0, lev == L - 2, y < 2, y > H - 3, x < 2, x > W - 3):
        assert (clamped & robust).sum() >= 2


@pytest.fixture(scope="module")
def host_library(tmp_path_factory) -> ctypes.CDLL:
    """csrc/subpixel_refine.cu built for the host against the CUDA shim of
    tools/cuda_syntax_check.py: each launch runs its blocks and threads one
    after another (the kernel uses no shared memory or barriers)."""
    tmp = tmp_path_factory.mktemp("k14")
    spec = importlib.util.spec_from_file_location("cuda_syntax_check", REPO / "tools" / "cuda_syntax_check.py")
    shim = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(shim)
    (tmp / "include").mkdir()
    (tmp / "include" / "cuda_runtime.h").write_text(shim.CUDA_RUNTIME_SHIM + r"""
template <class F> void sfm_host_launch(F body, int blocks, int threads, ...) {
  for (blockIdx.x = 0; blockIdx.x < (unsigned)blocks; ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < (unsigned)threads; ++threadIdx.x) body();
}
""")
    text = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"sfm_host_launch([&] { \1(\3); }, \2);", SOURCE.read_text(),
                  flags=re.S)
    (tmp / "k14.cpp").write_text(text + "\nuint3 threadIdx, blockIdx;\ndim3 blockDim, gridDim;\n")
    so = tmp / "libk14.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(tmp / "include"),
                    "-o", str(so), str(tmp / "k14.cpp")], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    getattr(lib, ENTRY).argtypes = list(_SIGNATURES[ENTRY])
    getattr(lib, ENTRY).restype = ctypes.c_int
    return lib


def test_kernel_source_on_the_host_equals_the_plain_version(case, host_library, monkeypatch):
    """The wrapper's launch, with the C entry point built for the host: the
    kernel's arithmetic in fp32 against the plain version's (which solves
    with LAPACK and divides by s where the kernel multiplies by 1 / s)."""
    gauss, idx, scores, cfg, want, want_valid, margin = case
    lib = host_library
    calls = []

    def host_launch(entry, name, *args):
        calls.append(name)
        assert getattr(lib, entry)(*args, None) == 0

    monkeypatch.setattr(k14, "on_cuda", lambda t: True)
    monkeypatch.setattr(k14, "launch", host_launch)
    g, i, s = torch.from_numpy(gauss), torch.from_numpy(idx), torch.from_numpy(scores)
    # The candidates as select_candidates hands them: slices of longer rows.
    wide = lambda t: torch.cat([t, torch.zeros_like(t[:, :3])], 1)[:, :t.shape[1]]  # noqa: E731
    got = k14.subpixel_refine(g, wide(i), wide(s), cfg)
    assert calls == ["subpixel_refine"]
    plain = k14.subpixel_refine_plain(g, i, s, cfg)
    robust = margin > MARGIN
    assert _gaps(got, want, want_valid, robust) == []
    assert torch.equal(got.img, plain.img) and torch.equal(got.angle, plain.angle)
    assert torch.equal(got.valid[torch.from_numpy(robust)], plain.valid[torch.from_numpy(robust)])
    for f in ("x", "y", "level"):
        assert (getattr(got, f) - getattr(plain, f)).abs().max() <= POS_GAP


@pytest.mark.parametrize("n", [1, 255, 256, 257, 32768, 2**31 - 1])
def test_launch_plan_gives_a_thread_to_each_candidate(n):
    blocks, threads = k14.refine_launch_plan(n)
    assert threads == 256 and (blocks - 1) * threads < n <= blocks * threads


def test_launch_plan_refuses_what_one_grid_cannot_hold():
    assert k14.refine_launch_plan(0) == (0, 256)
    for n in (-1, 2**31):
        with pytest.raises(ValueError):
            k14.refine_launch_plan(n)


def _c_arguments() -> list:
    """The C entry's parameter types, in order, as ctypes types."""
    params = re.search(rf'extern "C" int {ENTRY}\((.*?)\)\s*\{{', SOURCE.read_text(), flags=re.S).group(1)
    types = []
    for p in params.split(","):
        decl = p.strip().rsplit(" ", 1)[0]
        types.append(ctypes.c_void_p if "*" in p else {"int": ctypes.c_int, "float": ctypes.c_float,
                                                        "int64_t": ctypes.c_int64}[decl])
    return types


def test_signature_matches_the_c_entry():
    assert list(_SIGNATURES[ENTRY]) == _c_arguments()


def test_wrapper_passes_the_plan(monkeypatch):
    """The wrapper hands the C entry the stack, the candidates with their row
    strides, eight fresh outputs, N = B * K, K, the shape, the rounds and
    the thresholds as the plain version compares them; no candidates, no
    launch."""
    passed = []
    monkeypatch.setattr(k14, "on_cuda", lambda t: True)
    monkeypatch.setattr(k14, "launch", lambda entry, name, *a: passed.append((entry, name, a)))
    shape = (2, 6, 40, 56)
    gauss = torch.zeros(shape)
    idx = torch.arange(2 * 64).reshape(2, 64)[:, :50]
    scores = torch.ones((2, 50))
    cfg = SiftConfig(refine_iters=4, edge_threshold=8.0)
    kps = k14.subpixel_refine(gauss, idx, scores, cfg)
    (entry, name, args), = passed
    assert (entry, name) == (ENTRY, "subpixel_refine")
    assert len(_SIGNATURES[entry]) == len(args) + 1
    assert args[:5] == (gauss.data_ptr(), idx.data_ptr(), 64, scores.data_ptr(), 50)
    assert args[5:13] == tuple(t.data_ptr() for t in kps)
    assert [f.dtype for f in kps] == [torch.int64] + [torch.float32] * 6 + [torch.bool]
    assert all(f.shape == (100,) for f in kps)
    assert args[13:] == (100, 50, *shape[1:], 4, 0.04 / 3, 8.0, 81.0, 1.6, 3.0)
    none = k14.subpixel_refine(gauss, idx[:, :0], scores[:, :0], cfg)
    assert len(passed) == 1 and all(f.shape == (0,) for f in none)


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(k14, "on_cuda", lambda t: True)
    monkeypatch.setattr(k14, "launch", lambda *a: None)
    gauss = torch.zeros((1, 6, 16, 16))
    idx = torch.zeros((1, 8), dtype=torch.int64)
    scores = torch.ones((1, 8))
    cfg = SiftConfig()
    bad = [(gauss.double(), idx, scores), (gauss, idx.int(), scores), (gauss, idx, scores.double()),
           (gauss, idx.reshape(-1), scores), (gauss, idx, scores[:, :4]), (gauss, idx[:, ::2], scores[:, :4]),
           (gauss.transpose(2, 3), idx, scores), (torch.zeros((1, 3, 16, 16)), idx, scores),
           (torch.zeros((1, 6, 4, 16)), idx, scores), (torch.zeros((1, 6, 16, 4)), idx, scores)]
    for g, i, s in bad:
        with pytest.raises(ValueError):
            k14.subpixel_refine(g, i, s, cfg)
    with pytest.raises(ValueError):
        k14.subpixel_refine(gauss, idx, scores, SiftConfig(refine_iters=-1))
    k14.subpixel_refine(gauss, idx, scores, cfg)


def test_kernel_source_parses():
    """csrc/subpixel_refine.cu parses with g++ against the CUDA shim
    (tools/cuda_syntax_check.py); compiling it for the card and running it
    there takes the card (chip_smoke.py's [refine] line)."""
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "cuda_syntax_check.py"), "subpixel_refine.cu"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
