"""PyTorch/CUDA port of hidvae_tpu for one NVIDIA H100: each module
mirrors the JAX module of its path (held to it by tests/test_torch_*.py)
and never imports JAX; entry points run on `cuda` unless told otherwise."""
