"""Compounding Zipf category trees for the seeded raw-data generators (a
copy of hidvae_tpu/data/synth_tree.py)."""

from typing import Sequence

import numpy as np


def zipf(n: int, a: float, s: float) -> np.ndarray:
    """Normalized Zipf-Mandelbrot weights 1/(rank+a)^s over n ranks."""
    w = 1.0 / (np.arange(n) + a) ** s
    return w / w.sum()


class ZipfTree:
    """A 3-level category tree with compounding Zipf item assignment."""

    def __init__(self, n_l1: int, n_l2: int, n_l3: int):
        self.n_l1, self.n_l2, self.n_l3 = n_l1, n_l2, n_l3
        self.l2_parent = np.arange(n_l2) % n_l1
        self.l3_parent = np.arange(n_l3) % n_l2
        self.l2_children = [np.nonzero(self.l2_parent == i)[0] for i in range(n_l1)]
        self.l3_children = [np.nonzero(self.l3_parent == j)[0] for j in range(n_l2)]

    def assign(self, rng: np.random.RandomState, n_items: int, l1_zipf=(1.2, 1.3),
               l2_zipf=(0.8, 1.6), l3_zipf=(0.6, 2.0)):
        """Per-item (l1, l2, l3) class indices, drawn as synth_tree.py:55-75."""
        l1 = rng.choice(self.n_l1, n_items, p=zipf(self.n_l1, *l1_zipf))
        l2 = np.empty(n_items, np.int64)
        l3 = np.empty(n_items, np.int64)
        for parent, child, children, law in ((l1, l2, self.l2_children, l2_zipf),
                                             (l2, l3, self.l3_children, l3_zipf)):
            for i, kids in enumerate(children):
                m = parent == i
                if m.any():
                    child[m] = kids[rng.choice(len(kids), m.sum(), p=zipf(len(kids), *law))]
        return l1, l2, l3


def personal_pool(rng: np.random.RandomState, items_by_class: Sequence[np.ndarray],
                  n_items: int, min_pool: int, size: int) -> np.ndarray:
    """A user's item pool: the items of one drawn L1 class (the whole catalog
    where that class has fewer than `min_pool`), `size` of them drawn."""
    pool = items_by_class[int(rng.randint(len(items_by_class)))]
    if len(pool) < min_pool:
        pool = np.arange(n_items)
    return rng.choice(pool, size=min(len(pool), size), replace=False)
