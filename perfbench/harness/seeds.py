"""Generators derived from a run's seed: one stream per purpose (salt), so
adding a draw in one place moves no other. Seeds may exceed 32 bits."""

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def mixed(seed: int, salt: int) -> int:
    """A 63-bit seed for the stream `salt` of `seed`."""
    return ((int(seed) * _MIX) ^ (int(salt) * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB)) & _MASK


def generator(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mixed(seed, salt))
    return g


# One salt per stream.
FEATURES, VAE_WEIGHTS, DECODER_WEIGHTS, KMEANS, TRAFFIC, SAMPLE = 1, 2, 3, 4, 5, 6
