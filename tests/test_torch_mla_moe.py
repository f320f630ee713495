"""models/mla_moe.py against its plain fp32 reference at tiny widths: MoE,
MLA prefill, absorbed cached decode against the full forward, the engine's
beam; spans, counters and routing notes. No JAX."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import MOE_ROUTINGS, MOE_TINY, build_vae, moe_errors, moe_inputs, seeded_histories
from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch
from hidvae_tpu_torch.models.mla_moe import MlaMoeRetrievalModel
from hidvae_tpu_torch.ops import moe_experts as moe
from hidvae_tpu_torch.serve.engine import RetrievalEngine
from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
from hidvae_tpu_torch.utils import debug
from perfbench.reference import mla_moe as ref

C = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=16,
         qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, rope_theta=50000,
         rms_norm_eps=1e-5, intermediate_size=96, moe_intermediate_size=24,
         n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
         routed_scaling_factor=2.446, first_k_dense_replace=1, norm_topk_prob=True)
K, D, NSEM, USERS = 16, 6, 3, 50
TOK = dict(input_dim=32, hidden_dims=(16,), embed_dim=16, codebook_size=K, n_layers=NSEM,
           codebook_normalize=False, tag_class_counts=(4, 6, 12), tag_embed_dim=16,
           n_items=96, max_seq_len=5)
TOL = dict(rtol=1e-4, atol=1e-5)  # fp32 both sides; the absorbed decode sums in another order


def weights(seed=0, bias_sd=0.01):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in ref.spec(C, K, D, NSEM, USERS):
        x = torch.randn(shape, generator=g)
        out[name] = {"ones": torch.ones(shape), "bias": x * bias_sd}.get(
            kind, x / math.sqrt(shape[-1]))
    return out


def model(W):
    m = MlaMoeRetrievalModel(C, K, D, n_sem_layers=NSEM, user_buckets=USERS,
                             dtype=torch.float32).eval()
    m.load_state_dict(W, strict=True)
    return m


def batch(lengths=(4, 2, 5)):
    """Ragged histories of `lengths` items, left-packed."""
    torch.manual_seed(1)
    b, n = len(lengths), max(lengths)
    mask = (torch.arange(n)[None] < torch.tensor(lengths)[:, None]).repeat_interleave(D, 1)
    sem = torch.where(mask, torch.randint(0, K, (b, n * D)), -1).int()
    tt = torch.arange(D, dtype=torch.int32)
    return TokenizedSeqBatch(torch.arange(b, dtype=torch.int32) * 97 + 5, sem,
                             torch.zeros((b, D), dtype=torch.int32), mask, tt.repeat(b, n),
                             tt.repeat(b, 1))


def contexts(W, bt):
    return [ref.context(W, int(u), s[m], t[m], K, NSEM, USERS)
            for u, s, t, m in zip(bt.user_ids, bt.sem_ids, bt.token_type_ids, bt.seq_mask)]


def test_moe_layer_matches_the_reference():
    W = weights(bias_sd=0.1)
    layer = model(W).layers[1].mlp
    x = torch.randn(40, C["hidden_size"])
    s = torch.sigmoid(x @ W["layers.1.mlp.gate.weight"].T)
    idx, w = layer.route(x)
    # the bias changed a choice, the weights are renormalized and scaled
    assert (torch.topk(s, 2).indices.sort().values != idx.sort().values).any()
    torch.testing.assert_close(w.sum(-1), torch.full((40,), 2.446))
    with torch.no_grad():
        want, ref_idx, _, _ = ref.moe(W, C, "layers.1.mlp", x, ref.Arith())
        torch.testing.assert_close(layer(x), want, **TOL)
        shared = ref.swiglu(W, "layers.1.mlp.shared_experts", x, ref.Arith())
    assert torch.equal(idx.sort().values, ref_idx.sort().values)
    assert (want - shared).abs().max() > 0.1 and shared.abs().max() > 0.1


@pytest.mark.parametrize("rows", MOE_ROUTINGS)
def test_grouped_swiglu_plain_at_edge_routings(rows):
    """The plain version (the CPU's path, the kernels' yardstick) in fp32
    against a loop over the experts."""
    args = moe_inputs(sum(rows) // 2, torch.device("cpu"), torch.Generator().manual_seed(5),
                      **dict(MOE_TINY, experts=len(rows)), rows=rows)
    args = {k: v.float() if v.is_floating_point() else v for k, v in args.items()}
    [err] = moe_errors(**args, fns=(moe.grouped_swiglu_plain,))
    assert err <= 1e-5, err


def test_grouped_swiglu_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="one card"):
        moe.grouped_swiglu(**moe_inputs(9, torch.device("cpu"), torch.Generator(), **MOE_TINY))


def test_mla_prefill_matches_the_reference():
    W, bt = weights(), batch()
    attn = model(W).layers[0].self_attn
    x = torch.randn(3, 1 + 5 * D, C["hidden_size"])
    mask = torch.cat([torch.ones((3, 1), dtype=torch.bool), bt.seq_mask], 1)
    with torch.no_grad():
        out, _ = attn.prefill(x, torch.cumsum(mask, 1) - 1, mask)
        for u in range(3):
            xu = x[u, mask[u]][None]
            torch.testing.assert_close(out[u, mask[u]],
                                       ref.attention(W, C, "layers.0.self_attn", xu,
                                                     ref.Arith())[0], **TOL)


@pytest.mark.parametrize("g", [ref.BEAMS, 2])
def test_cached_absorbed_decode_matches_the_full_forward(g):
    """Each digit's logits of random beam rows, reordered at random, against
    the reference's whole forward over [user, history, BOS, digits]."""
    W, bt = weights(), batch()
    m, b = model(W), 3
    ctx, rows = contexts(W, bt), b * g
    ids = torch.randint(0, K, (rows, D), dtype=torch.int32)
    with torch.no_grad():
        cache = m.start_decode(*m.encode_context(bt), rows)
        for i in range(D):
            got = m.decode_step(cache, i, ids[:, i - 1:i] if i else None)[:, 0]
            for u in range(b):
                x = ref.with_digits(W, ctx[u], ids[u * g:(u + 1) * g, :i], K, NSEM)
                torch.testing.assert_close(got[u * g:(u + 1) * g],
                                           ref.forward(W, C, [x])[0][0][:, -1], **TOL)
            parent = (torch.arange(b)[:, None] * g + torch.randint(0, g, (b, g))).reshape(-1)
            ids = ids[parent]
            cache.reorder(parent, i + 1)


@pytest.fixture(scope="module")
def served():
    """(engine, weights, histories, users)."""
    vae, feats = build_vae(TOK, torch.Generator().manual_seed(3))
    tok = HSemanticIdTokenizer(vae, n_layers=NSEM, codebook_size=K,
                               tag_class_counts=TOK["tag_class_counts"],
                               use_concatenated_ids=True, device="cpu")
    W = weights(2)
    engine = RetrievalEngine(model(W), tok, feats.numpy(), max_seq_len=TOK["max_seq_len"],
                             batch_buckets=(4,), device="cpu")
    hist = seeded_histories(TOK["n_items"], 3, 7, seed=4)
    return engine, W, hist, np.array([7, 1234567, 99])


def test_engine_matches_the_reference_beam(served):
    engine, W, hist, users = served
    out = engine.recommend(hist, users, top_k=ref.BEAMS)
    table = engine.corpus_ids.long()
    sets = ref.PrefixSets(table, K)
    items = engine._pad_histories(hist)
    tups = torch.from_numpy(out["sem_ids"]).long()
    with torch.no_grad(), ref.exact_fp32():
        ctxs = [ref.context(W, int(users[u]), table[v[v >= 0]].reshape(-1),
                            torch.arange(D).repeat(int((v >= 0).sum())), K, NSEM, USERS)
                for u, v in enumerate(items[:3])]
        held = [[ref.prefix_keys(t[:, :i + 1]) for i in range(D)] for t in tups]
        found = ref.beam_search(W, C, ctxs, sets, K, NSEM, D, follow=held)
        for u, (gen, sc, _) in enumerate(found):
            assert torch.equal(gen, tups[u])
            torch.testing.assert_close(torch.from_numpy(out["scores"][u]), sc, **TOL)
            np.testing.assert_array_equal(out["items"][u], sets.resolve(gen).numpy())


def test_spans_counters_and_routing_notes(served):
    engine, _, hist, users = served
    model = engine.model
    debug.clear()
    with debug.recording() as notes, profile(activities=[ProfilerActivity.CPU]):
        out = engine.recommend(hist, users, top_k=5)
    recs = debug.records()
    names = [r["name"] for r in recs]
    layers, moe = C["num_hidden_layers"], C["num_hidden_layers"] - 1
    passes = 1 + D  # the prefill and each digit
    assert names.count("model.mla") == layers * passes
    assert names.count("model.moe") == moe * passes and names.count("model.ffn") == passes
    experts = [v for n, v in notes if n == "moe.experts"]
    assert len(experts) == moe * passes
    assert len([n for n, _ in notes if n == "beam.prefixes"]) == D
    # valid prefill tokens (the bucket's padding row: its user token) and beam rows
    valid = 4 + int((engine._pad_histories(hist) >= 0).sum()) * D
    tokens = moe * (valid + D * 4 * ref.BEAMS)
    counts = recs[0]["counts"]
    assert counts["moe.tokens"] == tokens
    assert counts["moe.routed_rows"] == tokens * C["num_experts_per_tok"]
    assert counts["moe.max_expert_rows"] == sum(
        int(torch.bincount(e.flatten(), minlength=8).max()) for e in experts)
    assert [e.shape[0] for e in experts[:moe]] == [valid] * moe
    # a note is the layer's own choice
    layer, x = model.layers[1].mlp, torch.randn(9, C["hidden_size"])
    with debug.recording() as notes, torch.no_grad():
        layer(x)
    assert len(notes) == 1 and torch.equal(notes[0][1], layer.route(x)[0])
    plain = engine.recommend(hist, users, top_k=5)  # no profiler, no recorder
    np.testing.assert_array_equal(plain["sem_ids"], out["sem_ids"])
