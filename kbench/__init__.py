"""The benchmark of the PyTorch/CUDA port ``kmcex_tpu_torch`` on one GPU.
``python3 kbench/run.py --help``; cells in ``BENCHMARK.json``."""
