"""The benchmark of the PyTorch + CUDA port (sfm_tpu_torch) on the H100.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

BENCHMARK.json at the repository root names the cells; portbench/harness.py
says which files each name leads to. Nothing here imports JAX or the JAX
package (portbench/nojax.py checks it).
"""
