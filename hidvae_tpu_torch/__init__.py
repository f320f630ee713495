"""PyTorch/CUDA port of hidvae_tpu for one NVIDIA H100. Each module
mirrors the JAX package's module of the same path and is held against it by
tests/test_torch_*.py; it imports torch and numpy, never JAX. Entry points
run on `cuda` unless given `device="cpu"`."""
