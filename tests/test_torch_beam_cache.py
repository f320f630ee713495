"""The beam's incremental decode (models/transformer.py `DecoderCache`)
against the decoder rerun over every earlier digit, and its products
against the benchmark's needed count. No JAX."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch
from hidvae_tpu_torch.models.retrieval import BEAMS, EncoderDecoderRetrievalModel as Model
from hidvae_tpu_torch.ops.prefix_search import build_prefix_index, build_prefix_tries
from perfbench.harness import flops

B, N, K, E, A, LAYERS = 3, 4, 16, 16, 32, 4
D = [6, 3]  # 3 semantic digits and 3 tags; 3 digits


def _setup(d, ragged=True):
    torch.manual_seed(d)
    mask = torch.ones((B, N * d), dtype=torch.bool)
    mask[1, (N - 2) * d:] = not ragged
    sem = torch.where(mask, torch.randint(0, K, (B, N * d)), -1).int()
    tt = torch.arange(d, dtype=torch.int32)
    batch = TokenizedSeqBatch(torch.arange(B, dtype=torch.int32) * 977, sem,
                              torch.zeros((B, d), dtype=torch.int32), mask, tt.repeat(B, N),
                              tt.repeat(B, 1))
    return Model(E, A, 2, LAYERS, K, d, max_pos=N * d).eval(), batch


class Rerun:
    """In the cache's place: each digit reruns the decoder over all earlier."""

    def __init__(self, model, enc, ctx_mask, rows):
        self.model, self.enc, self.ctx_mask = model, enc, ctx_mask
        self.digits = torch.zeros((rows, model.sem_id_dim), dtype=torch.int32)

    def step(self, pos, sem_ids):
        if pos:
            self.digits[:, pos - 1:pos] = sem_ids
        tt = torch.arange(pos, dtype=torch.int32).expand(len(self.digits), pos)
        return self.model.decode_logits(self.enc, self.ctx_mask, self.digits[:, :pos], tt,
                                        last_only=True)

    def reorder(self, rows, n):
        self.digits[:, :n] = self.digits[rows, :n]


@pytest.mark.parametrize("g", [BEAMS, 1])
@pytest.mark.parametrize("d", D)
def test_cached_step_matches_the_rerun(d, g):
    """Each digit's logits for random beam tuples equal decode_logits over
    the same prefixes, also after every random reorder of the beams."""
    (model, batch), rows = _setup(d), B * g
    ids = torch.randint(0, K, (rows, d), dtype=torch.int32)
    tt = torch.arange(d, dtype=torch.int32).repeat(rows, 1)
    with torch.no_grad():
        enc, ctx_mask = model.encode_context(batch)
        cache = model.start_decode(enc, ctx_mask, rows)
        for i in range(d):
            torch.testing.assert_close(
                model.decode_step(cache, i, ids[:, i - 1:i] if i else None),
                model.decode_logits(enc, ctx_mask, ids[:, :i], tt[:, :i], last_only=True),
                rtol=1e-5, atol=1e-6)
            parent = (torch.arange(B)[:, None] * g + torch.randint(0, g, (B, g))).reshape(-1)
            ids = ids[parent]
            cache.reorder(parent, i + 1)


@pytest.mark.parametrize("top_k", [True, False])
@pytest.mark.parametrize("mode", ["none", "tries", "caps", "sampled"])
@pytest.mark.parametrize("d", D)
def test_beam_matches_the_rerun_beam(d, mode, top_k, monkeypatch):
    """generate_next_sem_id gives the rerun search's tuples and scores,
    constrained or not, with 32 beams or one, Gumbel-sampled too."""
    model, batch = _setup(d)
    corpus = torch.randint(0, K, (40, d)).int()
    index = None if mode in ("none", "sampled") else build_prefix_index(corpus)
    kw = {}
    if mode == "tries":
        kw["prefix_tries"] = {i: tuple(map(torch.from_numpy, t))
                              for i, t in build_prefix_tries(index.numpy(), K).items()}
    elif mode == "caps":
        kw["prefix_caps"] = tuple(int(torch.unique(corpus[:, :p], dim=0, return_counts=True)
                                      [1].max()) for p in range(1, d))

    def search():
        if mode == "sampled":
            kw.update(sample=True, generator=torch.Generator().manual_seed(4))
        with torch.no_grad():
            return model.generate_next_sem_id(batch, index, top_k=top_k, **kw)

    got = search()
    monkeypatch.setattr(model, "start_decode", lambda *a: Rerun(model, *a))
    monkeypatch.setattr(model, "decode_step", lambda cache, *a: cache.step(*a))
    want = search()
    assert torch.equal(got.sem_ids, want.sem_ids)
    torch.testing.assert_close(got.log_probas, want.log_probas, rtol=1e-5, atol=1e-6)
    if index is not None:
        table = {tuple(r) for r in corpus.tolist()}
        assert all(tuple(r) in table for r in got.sem_ids[:, 0].tolist())


@pytest.mark.parametrize("d", D)
def test_beam_runs_the_needed_products(d):
    """On full histories a search runs the benchmark's needed products
    (harness/flops.py), less the first digit's weights-by-values product
    over one key, which the counter skips (2 * attn_dim a row and layer)."""
    model, batch = _setup(d, ragged=False)
    cfg = {"decoder_embed_dim": E, "attn_embed_dim": A, "ffn_dim": 1024, "codebook_size": K,
           "attn_layers": LAYERS, "max_seq_len": N, "sem_id_dim": d}
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.generate_next_sem_id(batch)
    unseen = B * BEAMS * LAYERS // 2 * 2 * A
    assert counter.get_total_flops() == flops.beam_flops(cfg, [N] * B) - unseen
