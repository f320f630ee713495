"""The no-JAX guard: a module counts as JAX's or the JAX package's when its
top-level name (the part before the first dot) is one of FORBIDDEN as a
whole word. The port's name, hidvae_tpu_torch, begins with hidvae_tpu, so a
prefix test would be wrong."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "hidvae_tpu")


def forbidden_modules(names=None):
    """Sorted top-level names among `names` (default: sys.modules) that are
    forbidden."""
    names = sys.modules.keys() if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))
