"""The one generator of every traffic mix: user histories whose lengths
follow a named distribution and whose items follow Zipf's law over the
catalog, all drawn on the device from the run's seed. Lengths are the
distribution's stratified quantiles, so every seed serves the same multiset
of lengths in another order; the seed picks the order, the items and the
users."""

import math

import torch

from perfbench.harness import seeds


def lengths(n: int, spec: dict, g, device):
    """[n] int64 lengths: quantiles (i + 0.5) / n of spec's distribution,
    permuted by `g`. "geometric": min + a geometric count with the given
    mean, cut at max; "log_uniform": min..max uniform in log."""
    u = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    kind = spec["dist"]
    if kind == "geometric":
        p = 1.0 / (spec["mean"] - spec["min"] + 1.0)
        out = spec["min"] + torch.floor(torch.log1p(-u) / math.log1p(-p))
    elif kind == "log_uniform":
        lo, hi = math.log(spec["min"]), math.log(spec["max"] + 1)
        out = torch.floor(torch.exp(lo + u * (hi - lo)))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    out = torch.clamp(out, spec["min"], spec["max"]).long()
    return out[torch.randperm(n, generator=g, device=device)]


class Zipf:
    """Items by Zipf's law with exponent `alpha` over `n_items`, the
    popularity ranks mapped onto items by a seeded permutation."""

    def __init__(self, n_items: int, alpha: float, g, device):
        w = torch.arange(1, n_items + 1, dtype=torch.float64, device=device) ** -alpha
        self.cdf = torch.cumsum(w / w.sum(), 0)
        self.item_of_rank = torch.randperm(n_items, generator=g, device=device)
        self.n = n_items

    def draw(self, shape, g):
        u = torch.rand(shape, generator=g, device=self.cdf.device, dtype=torch.float64)
        rank = torch.clamp(torch.searchsorted(self.cdf, u), max=self.n - 1)
        return self.item_of_rank[rank]


def histories(n_rows: int, width: int, spec: dict, zipf: Zipf, g, device):
    """(items [n_rows, width] int32, -1 after each row's length; lengths)."""
    lens = lengths(n_rows, spec, g, device)
    items = zipf.draw((n_rows, width), g)
    cols = torch.arange(width, device=device)[None]
    items = torch.where(cols < lens[:, None], items, torch.full_like(items, -1))
    return items.to(torch.int32), lens


def user_ids(n: int, g, device):
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=g, device=device, dtype=torch.int64)


def serve_pages(traffic: dict, n_items: int, seed: int, device):
    """`distinct_pages` pages of `page_users` histories: a list of (histories
    [B, window] int32 numpy, user ids [B] int32 numpy, lengths [B] numpy)."""
    g = seeds.generator(seed, seeds.TRAFFIC, device)
    zipf = Zipf(n_items, traffic["zipf_alpha"], g, device)
    b, p = traffic["page_users"], traffic["distinct_pages"]
    items, lens = histories(b * p, traffic["history_window"], traffic["lengths"], zipf, g,
                            device)
    users = user_ids(b * p, g, device).to(torch.int32)
    items, lens, users = items.cpu().numpy(), lens.cpu().numpy(), users.cpu().numpy()
    return [(items[i * b:(i + 1) * b], users[i * b:(i + 1) * b], lens[i * b:(i + 1) * b])
            for i in range(p)]


def train_pool(traffic: dict, n_items: int, seed: int, device):
    """(users [n] int32, histories [n, window] int32, next items [n] int32)
    on the device: the trainer's sampling pool."""
    g = seeds.generator(seed, seeds.TRAFFIC, device)
    zipf = Zipf(n_items, traffic["zipf_alpha"], g, device)
    n = traffic["pool_sequences"]
    items, _ = histories(n, traffic["history_window"], traffic["lengths"], zipf, g, device)
    users = user_ids(n, g, device).to(torch.int32)
    fut = zipf.draw((n,), g).to(torch.int32)
    return users, items, fut
