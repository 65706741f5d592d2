"""The benchmark of seaweedfs_tpu_torch, the PyTorch and CUDA port: one
cell of BENCHMARK.json per run of `python3 bench_port/run.py`."""
