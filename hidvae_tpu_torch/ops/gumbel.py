"""Gumbel-softmax sampling (counterpart of hidvae_tpu/ops/gumbel.py) from a
generator (or RowShard) or given uniforms or noise (JAX's, in tests)."""

import math
from typing import Optional

import torch

from hidvae_tpu_torch.ops.dropout import uniform


def sample_gumbel(shape, generator: Optional[torch.Generator] = None, device=None,
                  dtype=torch.float32, eps: float = 1e-20, uniforms=None):
    """Gumbel(0, 1) noise -log(-log(U + eps) + eps), U drawn from
    `generator` (a RowShard keeps this rank's rows) unless `uniforms` are given."""
    u = uniform(shape, generator, device, dtype) if uniforms is None else uniforms
    return -torch.log(-torch.log(u + eps) + eps)


def gumbel_softmax_sample(logits, temperature: float,
                          generator: Optional[torch.Generator] = None, noise=None):
    """softmax((logits + Gumbel noise) / temperature) over the last axis; the
    noise is drawn from `generator` unless given."""
    if noise is None:
        noise = sample_gumbel(logits.shape, generator, logits.device, logits.dtype)
    return torch.softmax((logits + noise) / temperature, dim=-1)


class TemperatureScheduler:
    """Exponential-decay temperature: every `step_size` iterations t becomes
    max(t * exp(-anneal_rate * it), min_t)."""

    def __init__(self, t0: float, min_t: float, anneal_rate: float, step_size: int):
        self.t0 = t0
        self.min_t = min_t
        self.anneal_rate = anneal_rate
        self.step_size = step_size
        self.t = t0

    def update_t(self, it: int):
        if it % self.step_size == self.step_size - 1:
            self.t = max(self.t * math.exp(-self.anneal_rate * it), self.min_t)

    def get_t(self, it: int) -> float:
        self.update_t(it)
        return self.t
