"""A run's inputs, made from its seed on its device: item features, the
stage-1 weights (codebooks k-means-seeded from the features) and the
stage-2 weights. Both the port and the reference are handed these."""

from perfbench.harness import seeds, weights
from perfbench.reference.spec import decoder_spec, sem_id_dim, vae_spec


def make(cfg, seed: int, device):
    feats = weights.make_features(cfg["n_items"], cfg["input_dim"], seed, device)
    vae = weights.make_weights(vae_spec(cfg), seed, seeds.VAE_WEIGHTS, device)
    weights.seed_codebooks_(vae, cfg, feats, seed, device)
    dec = weights.make_weights(decoder_spec(cfg), seed, seeds.DECODER_WEIGHTS, device)
    return feats, vae, dec


def flop_cfg(cfg):
    """The configuration with its ID tuple width, as harness/flops.py reads it."""
    return {**cfg, "sem_id_dim": sem_id_dim(cfg)}
