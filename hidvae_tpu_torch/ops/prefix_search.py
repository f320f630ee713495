"""Corpus prefix index for constrained generation (counterpart of
hidvae_tpu/ops/prefix_search.py): the table sorted once, a prefix found by
two fixed-step binary searches; `build_prefix_tries` is host numpy."""

import math

import numpy as np
import torch

_NEG = torch.iinfo(torch.int32).min
_POS = torch.iinfo(torch.int32).max


def _lexsort_rows(ids):
    """Stable lexicographic order of the rows of ids [N, D] (column 0 most
    significant); equal rows keep ascending original index, as np.lexsort."""
    n = ids.shape[0]
    order = torch.arange(n, device=ids.device)
    for col in range(ids.shape[1] - 1, -1, -1):
        keys = ids[order, col]
        order = order[torch.sort(keys, stable=True).indices]
    return order


def build_prefix_index(corpus_ids):
    """Sort corpus ID rows lexicographically. corpus_ids: [N, D] int32."""
    return build_prefix_index_with_perm(corpus_ids)[0]


def build_prefix_index_with_perm(corpus_ids):
    """Sorted table plus the sort permutation (sorted row -> corpus row)."""
    corpus_ids = corpus_ids.to(torch.int32)
    order = _lexsort_rows(corpus_ids)
    return corpus_ids[order], order.to(torch.int32)


def lookup_items(sorted_corpus, perm, tuples):
    """Resolve full ID tuples [..., D] to corpus row indices; -1 where the
    tuple is absent. Duplicated tuples resolve to the smallest row index
    (the sort is stable)."""
    lo, hi = prefix_range(sorted_corpus, tuples)
    idx = perm[torch.clamp(lo, 0, perm.shape[0] - 1).long()]
    return torch.where(hi > lo, idx, torch.full_like(idx, -1))


def _lex_less(rows, queries):
    """rows, queries: [Q, D] -> [Q] bool, True where rows <lex queries."""
    neq = rows != queries
    any_neq = torch.any(neq, dim=-1)
    first = torch.argmax(neq.to(torch.int32), dim=-1)  # first differing column
    q_idx = torch.arange(rows.shape[0], device=rows.device)
    return any_neq & (rows[q_idx, first] < queries[q_idx, first])


def _search_steps(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2)))) + 2


def _lex_bound(sorted_corpus, queries, inclusive: bool):
    """For each query row the number of corpus rows <lex it (or <=lex with
    `inclusive`). queries: [Q, D] -> [Q] int32."""
    n = sorted_corpus.shape[0]
    q = queries.shape[0]
    lo = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    hi = torch.full((q,), n, dtype=torch.int32, device=queries.device)
    for _ in range(_search_steps(n)):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        rows = sorted_corpus[torch.clamp(mid, 0, n - 1).long()]
        less = _lex_less(rows, queries)
        if inclusive:
            less = less | torch.all(rows == queries, dim=-1)
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def _padded_queries(sorted_corpus, prefixes):
    p = min(prefixes.shape[-1], sorted_corpus.shape[-1])
    d = sorted_corpus.shape[-1]
    q = prefixes[..., :p].reshape(-1, p).to(torch.int32)
    pad_lo = torch.full((q.shape[0], d - p), _NEG, dtype=torch.int32, device=q.device)
    pad_hi = torch.full((q.shape[0], d - p), _POS, dtype=torch.int32, device=q.device)
    return torch.cat([q, pad_lo], -1), torch.cat([q, pad_hi], -1)


def prefix_range(sorted_corpus, prefixes):
    """Half-open row range [lo, hi) of corpus rows matching each prefix.
    prefixes: [..., P] int32, P <= D. hi == lo when the prefix is absent."""
    batch_shape = prefixes.shape[:-1]
    q_lo, q_hi = _padded_queries(sorted_corpus, prefixes)
    lo = _lex_bound(sorted_corpus, q_lo, inclusive=False)
    hi = _lex_bound(sorted_corpus, q_hi, inclusive=True)
    return lo.reshape(batch_shape), hi.reshape(batch_shape)


def exists_prefix(sorted_corpus, prefixes):
    """Whether each prefix [..., P] matches at least one corpus row."""
    lo, hi = prefix_range(sorted_corpus, prefixes)
    return hi > lo


def valid_digit_mask(sorted_corpus, lo, hi, level: int, n_digits: int, cap: int):
    """[Q, n_digits] bool: any(corpus[lo:hi, level] == v) over at most `cap`
    rows a range (lo, hi [Q] int32); values outside [0, n_digits) dropped."""
    q = lo.shape[0]
    offs = torch.arange(cap, dtype=torch.int32, device=lo.device)[None, :]
    rows = torch.clamp(lo[:, None] + offs, 0, sorted_corpus.shape[0] - 1)
    vals = sorted_corpus[rows.long(), level]                       # [Q, cap]
    in_range = offs < (hi - lo)[:, None]
    representable = in_range & (vals >= 0) & (vals < n_digits)
    slot = torch.where(representable, vals, torch.full_like(vals, n_digits))
    out = torch.zeros((q, n_digits + 1), dtype=torch.bool, device=lo.device)
    out.scatter_(1, slot.long(), True)
    return out[:, :n_digits]


def first_digit_mask(sorted_corpus, n_digits: int):
    """[n_digits] bool: first-column values present in the corpus."""
    col = sorted_corpus[:, 0]
    ok = (col >= 0) & (col < n_digits)
    out = torch.zeros((n_digits + 1,), dtype=torch.bool, device=col.device)
    out[torch.where(ok, col, torch.full_like(col, n_digits)).long()] = True
    return out[:n_digits]


def narrow_range(sorted_corpus, lo, hi, level: int, digit):
    """Narrow each [lo, hi) range by fixing column `level` to `digit`, by a
    binary search inside the range. lo, hi, digit: [Q]. Returns (lo', hi')."""
    n = sorted_corpus.shape[0]
    col = sorted_corpus[:, level]

    def bound(leq: bool):
        a, b = lo, hi
        for _ in range(_search_steps(n)):
            mid = torch.div(a + b, 2, rounding_mode="floor")
            vals = col[torch.clamp(mid, 0, n - 1).long()]
            less = vals <= digit if leq else vals < digit
            active = a < b
            a = torch.where(active & less, mid + 1, a)
            b = torch.where(active & ~less, mid, b)
        return a

    return bound(False), bound(True)


def build_prefix_tries(sorted_corpus, n_digits: int, budget_bytes: int = 64 << 20):
    """Next-digit bitmaps of a sorted corpus, level i in 1..D-1: starts
    [M_i] int32 of its prefix runs and bitmaps [M_i, n_digits] bool (None
    past `budget_bytes`). Host numpy."""
    ids = np.asarray(sorted_corpus)
    n, d = ids.shape
    # An unsorted table silently yields wrong masks: refuse it.
    if n > 1:
        diff = ids[1:] != ids[:-1]
        changed = diff.any(axis=1)
        first = diff.argmax(axis=1)
        rows = np.arange(n - 1)
        if np.any(changed & (ids[:-1][rows, first] > ids[1:][rows, first])):
            raise ValueError(
                "build_prefix_tries requires a lexicographically-sorted corpus "
                "table (use the output of build_prefix_index)"
            )
    tries = {}
    for i in range(1, d):
        change = np.any(ids[1:, :i] != ids[:-1, :i], axis=1)
        m = int(change.sum()) + 1
        if m * n_digits > budget_bytes:
            tries[i] = None
            continue
        node_of_row = np.concatenate([[0], np.cumsum(change)])
        starts = np.concatenate([[0], np.nonzero(change)[0] + 1]).astype(np.int32)
        vals = ids[:, i]
        ok = (vals >= 0) & (vals < n_digits)
        bitmap = np.zeros((m, n_digits), bool)
        bitmap[node_of_row[ok], vals[ok]] = True
        tries[i] = (starts, bitmap)
    return tries


def tries_on_device(tries, device):
    """`build_prefix_tries`' levels as tensors on `device`; None where no
    level has a trie."""
    if not tries or all(t is None for t in tries.values()):
        return None
    return {lvl: None if t is None else tuple(torch.from_numpy(a).to(device) for a in t)
            for lvl, t in tries.items()}


def trie_digit_mask(starts, bitmaps, lo, hi):
    """Next-digit validity [Q, K] by trie-node lookup; all False where the
    range is empty. starts [M] int32, bitmaps [M, K] bool, lo/hi [Q]."""
    m = starts.shape[0]
    node = torch.searchsorted(starts, lo, right=True) - 1
    valid = bitmaps[torch.clamp(node, 0, m - 1).long()]
    return valid & (hi > lo)[:, None]


def duplicate_ranks(corpus_ids):
    """Rank of each row among identical ID tuples, in corpus order: row i
    gets r if it is the (r+1)-th occurrence of its tuple."""
    n = corpus_ids.shape[0]
    ids = corpus_ids.to(torch.int32)
    order = _lexsort_rows(ids)  # stable: ties in original order
    sorted_ids = ids[order]
    new_group = torch.ones((n,), dtype=torch.bool, device=ids.device)
    if n > 1:
        new_group[1:] = torch.any(sorted_ids[1:] != sorted_ids[:-1], dim=-1)
    pos = torch.arange(n, device=ids.device)
    group_start = torch.cummax(torch.where(new_group, pos, torch.zeros_like(pos)), 0).values
    ranks = torch.empty((n,), dtype=torch.int32, device=ids.device)
    ranks[order] = (pos - group_start).to(torch.int32)
    return ranks
