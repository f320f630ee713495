"""The benchmark of the PyTorch/CUDA port (`hidvae_tpu_torch`): one cell
of BENCHMARK.json a run, `python3 perfbench/run.py --workload <cell> ...`."""
