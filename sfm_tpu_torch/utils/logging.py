"""Observability: stage timers (port of sfm_tpu/utils/logging.py).

Each stage records its wall-clock duration into a manifest dict. PyTorch
returns before the GPU finishes, so on a CUDA device the timer synchronises
before reading the clock at both ends of a stage. With ``profile_dir`` each
stage is traced with ``torch.profiler`` and written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


class StageTimer:
    def __init__(self, verbose: bool = True, profile_dir: str | None = None,
                 device: torch.device | str = "cpu"):
        self.verbose = verbose
        self.profile_dir = profile_dir
        self.device = torch.device(device)
        self.durations: dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        prof = None
        if self.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        self._sync()
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            yield
            self._sync()
        dt = time.perf_counter() - t0
        if prof is not None:
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.profile_dir, f"{name}.json"))
        self.durations[name] = self.durations.get(name, 0.0) + dt
        if self.verbose:
            print(f"[sfm_tpu_torch] stage {name}: {dt:.2f}s")

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.durations, f, indent=2)
