"""Prefix-index parity: index, permutation, ranges, masks, tries, item
lookup and duplicate ranks against hidvae_tpu/ops/prefix_search.py on the
same corpora, duplicates included."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidvae_tpu.ops import prefix_search as _jps
from hidvae_tpu_torch.ops import prefix_search as ps

# The JAX functions under jit: one compile per shape instead of one per
# eager op of their fixed-step search loops.
jps = types.SimpleNamespace(
    build_prefix_index=jax.jit(_jps.build_prefix_index),
    build_prefix_index_with_perm=jax.jit(_jps.build_prefix_index_with_perm),
    prefix_range=jax.jit(_jps.prefix_range),
    exists_prefix=jax.jit(_jps.exists_prefix),
    lookup_items=jax.jit(_jps.lookup_items),
    first_digit_mask=jax.jit(_jps.first_digit_mask, static_argnums=1),
    valid_digit_mask=jax.jit(_jps.valid_digit_mask, static_argnums=(3, 4, 5)),
    trie_digit_mask=jax.jit(_jps.trie_digit_mask),
    narrow_range=jax.jit(_jps.narrow_range, static_argnums=3),
    duplicate_ranks=jax.jit(_jps.duplicate_ranks),
    build_prefix_tries=_jps.build_prefix_tries,
)


def _np(t):
    return t.detach().cpu().numpy()


def _corpus(seed, n, d, k):
    """Rows with heavy duplication (small k) plus exact duplicated rows."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, k, (n, d)).astype(np.int32)
    ids[n // 2:n // 2 + 5] = ids[0]
    return ids


CORPORA = [(0, 200, 3, 5), (1, 64, 4, 16), (2, 300, 6, 9)]


@pytest.fixture(params=CORPORA, ids=lambda c: f"n{c[1]}d{c[2]}k{c[3]}")
def corpus(request):
    seed, n, d, k = request.param
    ids = _corpus(seed, n, d, k)
    t_sorted, t_perm = ps.build_prefix_index_with_perm(torch.from_numpy(ids))
    j_sorted, j_perm = jps.build_prefix_index_with_perm(jnp.asarray(ids))
    return dict(ids=ids, k=k, seed=seed, t_sorted=t_sorted, t_perm=t_perm,
                j_sorted=j_sorted, j_perm=j_perm)


def test_index_and_perm(corpus):
    np.testing.assert_array_equal(_np(corpus["t_sorted"]), np.asarray(corpus["j_sorted"]))
    np.testing.assert_array_equal(_np(corpus["t_perm"]), np.asarray(corpus["j_perm"]))
    np.testing.assert_array_equal(
        _np(ps.build_prefix_index(torch.from_numpy(corpus["ids"]))),
        np.asarray(jps.build_prefix_index(jnp.asarray(corpus["ids"]))))


def test_ranges_and_exists(corpus):
    ids, k = corpus["ids"], corpus["k"]
    rng = np.random.RandomState(corpus["seed"] + 10)
    d = ids.shape[1]
    for p in range(1, d + 1):
        # Half the queries are corpus prefixes, half random (often absent).
        q = np.concatenate([ids[rng.randint(0, len(ids), 20), :p],
                            rng.randint(0, k + 2, (20, p))]).astype(np.int32)
        lo, hi = ps.prefix_range(corpus["t_sorted"], torch.from_numpy(q))
        jlo, jhi = jps.prefix_range(corpus["j_sorted"], jnp.asarray(q))
        np.testing.assert_array_equal(_np(lo), np.asarray(jlo))
        np.testing.assert_array_equal(_np(hi), np.asarray(jhi))
        np.testing.assert_array_equal(
            _np(ps.exists_prefix(corpus["t_sorted"], torch.from_numpy(q))),
            np.asarray(jps.exists_prefix(corpus["j_sorted"], jnp.asarray(q))))


def test_lookup_items(corpus):
    ids, k = corpus["ids"], corpus["k"]
    rng = np.random.RandomState(corpus["seed"] + 11)
    tuples = np.concatenate([ids[rng.randint(0, len(ids), 30)],
                             rng.randint(0, k + 1, (10, ids.shape[1]))]).astype(np.int32)
    tuples = tuples.reshape(5, 8, -1)
    got = ps.lookup_items(corpus["t_sorted"], corpus["t_perm"], torch.from_numpy(tuples))
    want = jps.lookup_items(corpus["j_sorted"], corpus["j_perm"], jnp.asarray(tuples))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_masks_and_narrowing(corpus):
    ids, k = corpus["ids"], corpus["k"]
    d = ids.shape[1]
    n_digits = k - 1  # some digits unrepresentable, as tag digits can be
    np.testing.assert_array_equal(
        _np(ps.first_digit_mask(corpus["t_sorted"], n_digits)),
        np.asarray(jps.first_digit_mask(corpus["j_sorted"], n_digits)))
    rng = np.random.RandomState(corpus["seed"] + 12)
    prefixes = ids[rng.randint(0, len(ids), 16), :1].astype(np.int32)
    lo, hi = ps.prefix_range(corpus["t_sorted"], torch.from_numpy(prefixes))
    jlo, jhi = jps.prefix_range(corpus["j_sorted"], jnp.asarray(prefixes))
    tries = ps.build_prefix_tries(_np(corpus["t_sorted"]), n_digits)
    jtries = jps.build_prefix_tries(np.asarray(corpus["j_sorted"]), n_digits)
    for level in range(1, d):
        for cap in (4, len(ids)):
            np.testing.assert_array_equal(
                _np(ps.valid_digit_mask(corpus["t_sorted"], lo, hi, level, n_digits, cap)),
                np.asarray(jps.valid_digit_mask(corpus["j_sorted"], jlo, jhi, level,
                                                n_digits, cap)))
        starts, bitmaps = tries[level]
        np.testing.assert_array_equal(starts, jtries[level][0])
        np.testing.assert_array_equal(bitmaps, jtries[level][1])
        np.testing.assert_array_equal(
            _np(ps.trie_digit_mask(torch.from_numpy(starts), torch.from_numpy(bitmaps), lo, hi)),
            np.asarray(jps.trie_digit_mask(jnp.asarray(starts), jnp.asarray(bitmaps), jlo, jhi)))
        digit = ids[rng.randint(0, len(ids), 16), level].astype(np.int32)
        lo, hi = ps.narrow_range(corpus["t_sorted"], lo, hi, level, torch.from_numpy(digit))
        jlo, jhi = jps.narrow_range(corpus["j_sorted"], jlo, jhi, level, jnp.asarray(digit))
        np.testing.assert_array_equal(_np(lo), np.asarray(jlo))
        np.testing.assert_array_equal(_np(hi), np.asarray(jhi))


def test_duplicate_ranks(corpus):
    ids = corpus["ids"]
    np.testing.assert_array_equal(_np(ps.duplicate_ranks(torch.from_numpy(ids))),
                                  np.asarray(jps.duplicate_ranks(jnp.asarray(ids))))


def test_tries_budget_and_unsorted_guard():
    ids = np.sort(_corpus(3, 50, 3, 4).view("i4,i4,i4"), axis=0).view(np.int32).reshape(50, 3)
    tries = ps.build_prefix_tries(ids, 4, budget_bytes=1)
    assert all(v is None for v in tries.values())
    with pytest.raises(ValueError, match="sorted"):
        ps.build_prefix_tries(ids[::-1].copy(), 4)
