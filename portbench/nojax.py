"""The no-JAX check: the benchmark measures the PyTorch port, and nothing it
runs may load JAX or the JAX package. Names are compared whole, by the
part before the first dot: `sfm_tpu_torch` is the port, `sfm_tpu` is not.

    python3 -m portbench.nojax WORKLOAD

loads the cell's configuration, traffic, kind module, reference, readers
and the port's modules the kind names in its PROGRAM (without running
anything on a device) and exits non-zero, naming them, if a forbidden module was loaded.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sfm_tpu")


def forbidden_loaded(modules=None) -> list:
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".", 1)[0] in FORBIDDEN})


def load_cell_modules(workload: str) -> None:
    """Import everything a run of the cell imports before it touches a device."""
    import importlib

    from portbench import harness

    cell = harness.load_cell(workload)
    kind = harness.kind_module(cell)
    for m in cell.end_to_end + cell.per_layer:
        harness.reader(m["name"])
    for name in ("sfm_tpu_torch", "sfm_tpu_torch.kernels", *kind.PROGRAM):
        importlib.import_module(name)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    for workload in argv:
        load_cell_modules(workload)
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    print(f"no forbidden module among {len(sys.modules)} loaded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
