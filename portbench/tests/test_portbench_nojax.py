"""Nothing a cell loads imports JAX or the JAX package (names compared
whole: the port's own name starts with the JAX package's)."""

import subprocess
import sys

from conftest import ROOT, manifest
from portbench import nojax


def test_names_are_compared_whole():
    assert nojax.forbidden_loaded({"sfm_tpu_torch": 1, "sfm_tpu_torch.ba": 1, "jaxtyping": 1}) == []
    assert nojax.forbidden_loaded({"sfm_tpu": 1, "sfm_tpu.ba.core": 1, "jax.numpy": 1, "jaxlib": 1,
                                   "flax.linen": 1}) == ["flax.linen", "jax.numpy", "jaxlib", "sfm_tpu",
                                                         "sfm_tpu.ba.core"]


def test_no_cell_loads_jax():
    cells = [w["name"] for w in manifest()["workloads"]]
    out = subprocess.run([sys.executable, "-m", "portbench.nojax", *cells], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_sources_import_nothing_forbidden():
    """No file under portbench/ imports jax, the JAX package, chip_smoke,
    tools or benchmarks."""
    import re

    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|sfm_tpu|chip_smoke|tools|benchmarks)(\.|\s|$)", re.M)
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not bad.search(path.read_text()), path
