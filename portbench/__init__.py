"""The benchmark of the PyTorch and CUDA port (``lm2a_tpu_torch``) on an NVIDIA
H100: ``python3 portbench/run.py`` (see ``harness.py``). Cells, metrics and
bounds are in ``BENCHMARK.json`` at the repository's root; each
configuration, traffic mix, limit set, per-layer metric and kernel cost model
is a file of its own here, found by name."""
