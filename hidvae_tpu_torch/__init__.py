"""PyTorch/CUDA port of hidvae_tpu for one NVIDIA H100.

The JAX package `hidvae_tpu` is the reference: every module here mirrors a
module of the same path there and is held against it by the
`tests/test_torch_*.py` parity tests. This package imports torch and numpy
only, never JAX or `hidvae_tpu`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
card and no such argument they raise (utils/runtime.py).
"""
