"""The plain reference against the port at small widths, for both
configurations: the corpus table, the beam's tuples and scores, the resolved
items, and one training step's loss and update."""

import pytest
import torch

from _tiny import overrides
from hidvae_tpu_torch.ops.prefix_search import lookup_items
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.train.common import Optimizer, inverse_sqrt_schedule
from hidvae_tpu_torch.train.device_data import DeviceSeqData
from hidvae_tpu_torch.train.transformer import run_loop
from perfbench.harness import build, inputs, runner
from perfbench.harness import traffic as gen
from perfbench.reference import model as ref

CONFIGS = {"amazon_hidvae": "amazon_hidvae.serve_b256", "ml32m_rqvae": "ml32m_rqvae.serve_b256"}


def _setup(config, seed=5):
    cell = CONFIGS[config]
    _, _, cfg, traffic, _, _ = runner.load_cell(cell, overrides=overrides(cell))
    _, _, _, train_mix, _, _ = runner.load_cell("ml32m_rqvae.train_b64",
                                                overrides=overrides(cell))
    return cfg, {**traffic, **train_mix}, inputs.make(cfg, seed, "cpu")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_table_beam_items(config):
    cfg, traffic, (feats, vae_w, dec_w) = _setup(config)
    tok = build.tokenizer(cfg, vae_w, "cpu")
    model = build.decoder(cfg, dec_w, tok.sem_ids_dim, torch.float32, "cpu")
    engine = RetrievalEngine(model, tok, feats, max_seq_len=cfg["max_seq_len"],
                             batch_buckets=(traffic["page_users"],), device="cpu")
    table = ref.corpus_table(vae_w, cfg, feats)
    assert torch.equal(engine.corpus_ids.long(), table)

    hist, users, _ = gen.serve_pages(traffic, cfg["n_items"], 5, "cpu")[0]
    out = engine.recommend(hist, users, top_k=10)
    sets = ref.PrefixSets(table, cfg["codebook_size"])
    W = ref.with_head_dim(dec_w, cfg)
    h = ref.pad_histories(torch.from_numpy(hist), cfg["max_seq_len"])
    u = torch.from_numpy(users)
    uid, ids, mask, tt, _ = ref.tokenize(table, u, h, torch.zeros_like(u))
    with torch.no_grad():
        enc, cmask = ref.encode_context(W, cfg, ref.Arith(), uid, ids, mask, tt)
        tuples, scores = ref.beam_search(W, cfg, ref.Arith(), enc, cmask, sets)
        rescored = ref.score_tuples(W, cfg, ref.Arith(), enc, cmask,
                                    torch.from_numpy(out["sem_ids"]).long(), sets)
    assert torch.equal(tuples[:, :10], torch.from_numpy(out["sem_ids"]).long())
    torch.testing.assert_close(scores[:, :10], torch.from_numpy(out["scores"]),
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(rescored, torch.from_numpy(out["scores"]), rtol=0, atol=1e-4)
    resolved = ref.resolve(sets, tuples[:, :10])
    assert torch.equal(resolved, torch.from_numpy(out["items"]).long())
    mine = lookup_items(engine.sorted_ids, engine.perm, tuples[:, :10].int())
    assert torch.equal(mine.long(), resolved)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_step(config):
    cfg, traffic, (feats, vae_w, dec_w) = _setup(config)
    pool = gen.train_pool(traffic, cfg["n_items"], 5, "cpu")
    tok = build.tokenizer(cfg, vae_w, "cpu")
    table = tok.precompute_corpus_ids(feats).to(torch.int32)
    model = build.decoder(cfg, dec_w, tok.sem_ids_dim, torch.bfloat16, "cpu")
    opt = Optimizer(model.parameters(), inverse_sqrt_schedule(cfg["learning_rate"], 10),
                    cfg["weight_decay"])
    hist = run_loop(model, opt, DeviceSeqData(*pool), table, seed=5, start_iter=0,
                    iterations=1, batch_size=cfg["batch_size"], subsample=True, log_every=1)
    losses, grads, after = ref.train_steps(dec_w, cfg, ref.Arith(dtype=torch.bfloat16), pool,
                                           table.long(), 5, 1)
    assert hist["train_loss"][0] == pytest.approx(losses[0], rel=1e-6)
    for name, p in model.named_parameters():
        torch.testing.assert_close(opt.adamw.state[p]["exp_avg"] / 0.1, grads[name],
                                   rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(p.detach(), after[name], rtol=1e-5, atol=1e-6)



@pytest.mark.parametrize("held, kept", [((1, 2, 0), [0, 2]), ((1, 3, 0), [0, 1])])
def test_beam_follows_near_ties_only(held, kept):
    """A judged search's prefix within TIE_REL of the beam's edge is kept in
    place of the reference's own edge candidate; one further below is not,
    and a candidate above the band is never displaced."""
    gen = torch.tensor([[[1, 0, 0], [2, 0, 0]]])
    scores = torch.tensor([[-1.0, -2.0, -2.0 - 1e-6, -2.5, -3.0, -3.0, -3.0, -3.0]])
    follow = torch.tensor([[held]])
    chosen = ref.follow_near_ties(scores, gen, 1, follow, 2)
    assert chosen.tolist() == [kept]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_beam_following_its_own_answer_is_unchanged(config):
    cfg, traffic, (feats, vae_w, dec_w) = _setup(config, seed=7)
    table = ref.corpus_table(vae_w, cfg, feats)
    sets = ref.PrefixSets(table, cfg["codebook_size"])
    W = ref.with_head_dim(dec_w, cfg)
    hist, users, _ = gen.serve_pages(traffic, cfg["n_items"], 7, "cpu")[0]
    h = ref.pad_histories(torch.from_numpy(hist), cfg["max_seq_len"])
    u = torch.from_numpy(users)
    uid, ids, mask, tt, _ = ref.tokenize(table, u, h, torch.zeros_like(u))
    with torch.no_grad():
        enc, cmask = ref.encode_context(W, cfg, ref.Arith(), uid, ids, mask, tt)
        tuples, scores = ref.beam_search(W, cfg, ref.Arith(), enc, cmask, sets)
        again, rescores = ref.beam_search(W, cfg, ref.Arith(), enc, cmask, sets,
                                          follow=tuples[:, :10])
    assert torch.equal(again, tuples)
    assert torch.equal(rescores, scores)
