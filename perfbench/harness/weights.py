"""Seeded weights and item features, made on the device in a few large
draws: one normal draw for every random tensor of a spec, sliced and scaled
per tensor (1/sqrt(fan-in) for products, 1/sqrt(width) for embeddings)."""

import math

import torch

from perfbench.harness import seeds

ROWS_PER_CODE, LLOYD_STEPS = 16, 10  # the seeded codebooks' k-means


def make_weights(spec, seed: int, salt: int, device):
    """{name: tensor} for (name, shape, kind) of `spec`, from one draw."""
    random = [(n, s) for n, s, k in spec if k in ("linear", "embed", "codebook")]
    total = sum(math.prod(s) for _, s in random)
    draw = torch.randn(total, generator=seeds.generator(seed, salt, device), device=device)
    out, off = {}, 0
    for name, shape, kind in spec:
        if kind in ("linear", "embed", "codebook"):
            n = math.prod(shape)
            t = draw[off:off + n].view(shape)
            off += n
            if kind == "linear":
                t = t * (1.0 / math.sqrt(shape[1]))
            elif kind == "embed":
                t = t * (1.0 / math.sqrt(shape[-1]))
            out[name] = t.clone()
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
    return out


def make_features(n_items: int, dim: int, seed: int, device):
    """[n_items, dim] unit-norm rows, standing in for text embeddings."""
    x = torch.randn((n_items, dim), generator=seeds.generator(seed, seeds.FEATURES, device),
                    device=device)
    return x / x.norm(dim=-1, keepdim=True)


def seed_codebooks_(W, cfg, features, seed: int, device):
    """Codebooks standing in for trained ones: level by level, k-means
    (LLOYD_STEPS from K seeded rows) over the encoded first
    ROWS_PER_CODE * K items' residuals, the residual then taken against the
    level's effective codebook. Deterministic: sums by a one-hot product."""
    from perfbench.reference.model import encode_items, exact_fp32, l2norm, Arith

    g = seeds.generator(seed, seeds.KMEANS, device)
    k = cfg["codebook_size"]
    with torch.no_grad(), exact_fp32():
        res = encode_items(W, cfg, features[: ROWS_PER_CODE * k], Arith())
        for level in range(cfg["n_layers"]):
            pick = torch.randperm(res.shape[0], generator=g, device=device)[:k]
            codes = res[pick]
            for _ in range(LLOYD_STEPS):
                dist = torch.sum(codes * codes, -1)[None] - 2.0 * (res @ codes.T)
                onehot = torch.nn.functional.one_hot(torch.argmin(dist, -1), k).float()
                count = onehot.sum(0)[:, None]
                codes = torch.where(count > 0, (onehot.T @ res) / count.clamp(min=1), codes)
            W[f"quantize_{level}.embedding"] = codes.clone()
            eff = l2norm(codes) if level == 0 and cfg["codebook_normalize"] else codes
            dist = torch.sum(eff * eff, -1)[None] - 2.0 * (res @ eff.T)
            res = res - eff[torch.argmin(dist, -1)]
    return W
