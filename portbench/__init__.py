"""The benchmark of the PyTorch and CUDA port (mlsgpu_tpu_torch): whole
reconstructions of seeded sphere scans, one cell a run. See
portbench/harness.py for a run and BENCHMARK.json for the cells."""
