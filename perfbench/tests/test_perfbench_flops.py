"""The analytic product count against FlopCounterMode on the port's own
calls, at small widths. The executed count is held on forward passes with
every history full (no padding), so the port runs what it describes; each
piece of the needed count is held on a call that does exactly that work:
the encoder over an unpadded context, the decoder's first digit for beam
rows sharing one user's cross-attention keys and values, the
self-attention of one new token over its earlier keys, and a training
step as three forwards."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _tiny import overrides
from hidvae_tpu_torch.models.attention import dot_product_attention
from hidvae_tpu_torch.train.device_data import tokenize_on_device
from perfbench.harness import build, flops, inputs, runner
from perfbench.reference.spec import sem_id_dim

CELLS = {"amazon_hidvae": "amazon_hidvae.serve_b256", "ml32m_rqvae": "ml32m_rqvae.serve_b256"}
BEAMS = 32


def _model(config, width=None):
    """(flop cfg, the port's decoder, a batch of 4 full histories of
    `width` items (default: the window), 4, width)."""
    cell = CELLS[config]
    _, _, cfg, _, _, _ = runner.load_cell(cell, overrides=overrides(cell))
    _, _, dec_w = inputs.make(cfg, 3, "cpu")
    d = sem_id_dim(cfg)
    model = build.decoder(cfg, dec_w, d, torch.float32, "cpu").eval()
    b, n = 4, width or cfg["max_seq_len"]
    table = torch.randint(0, cfg["codebook_size"], (50, d), dtype=torch.int32)
    items = torch.randint(0, 50, (b, n), dtype=torch.int32)
    users = torch.arange(b, dtype=torch.int32)
    batch = tokenize_on_device(table, users, items, torch.zeros(b, dtype=torch.int32))
    return inputs.flop_cfg(cfg), model, batch, b, n


def _count(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _unseen(fcfg, rows):
    """At one key the self-attention's einsum multiplies weights by values
    without a matrix product, which the counter skips: 2 * attn_dim a row
    and decoder layer."""
    return rows * (fcfg["attn_layers"] // 2) * 2 * fcfg["attn_embed_dim"]


@pytest.mark.parametrize("config", sorted(CELLS))
def test_train_forward_count(config):
    fcfg, model, batch, b, n = _model(config)
    with torch.no_grad():
        counted = _count(lambda: model(batch))
    assert counted == flops.train_forward_flops(fcfg, [n] * b, executed=True)
    assert flops.train_forward_flops(fcfg, [n] * b) < counted


@pytest.mark.parametrize("config", sorted(CELLS))
def test_train_step_is_three_forwards(config):
    """Forward and backward of a training step: three times the forward's
    products, the rule of the needed training count."""
    fcfg, model, batch, b, n = _model(config)
    counted = _count(lambda: model(batch).loss.backward())
    assert counted == 3 * flops.train_forward_flops(fcfg, [n] * b, executed=True)


@pytest.mark.parametrize("config", sorted(CELLS))
def test_beam_count(config):
    fcfg, model, batch, b, n = _model(config)
    with torch.no_grad():
        counted = _count(lambda: model.generate_next_sem_id(batch))
    unseen = _unseen(fcfg, b * BEAMS)  # the first digit's
    assert counted == flops.beam_flops(fcfg, [n] * b, executed=True) - unseen
    assert flops.beam_flops(fcfg, [n] * b) < counted


def test_needed_count_follows_valid_tokens():
    fcfg, _, _, _, n = _model("ml32m_rqvae")
    short, full = flops.beam_flops(fcfg, [1]), flops.beam_flops(fcfg, [n])
    assert short < full == flops.beam_flops(fcfg, [n + 10])  # the window caps it
    assert flops.train_step_flops(fcfg, [2, 3]) == 3 * flops.train_forward_flops(fcfg, [2, 3])


@pytest.mark.parametrize("config", sorted(CELLS))
@pytest.mark.parametrize("width", [1, 3])
def test_needed_encoder_count(config, width):
    """The encoder over contexts of `width` items, all valid: the needed
    count of a user whose history has `width` items."""
    fcfg, model, batch, b, _ = _model(config, width)
    t = flops.context_tokens(fcfg, width)
    assert batch.seq_mask.all() and batch.sem_ids.shape[1] + 1 == t
    with torch.no_grad():
        counted = _count(lambda: model.encode_context(batch))
    assert counted == b * flops.encoder_flops(fcfg, t)


@pytest.mark.parametrize("config", sorted(CELLS))
def test_needed_first_digit_count(config):
    """The beam's first digit at n = 1 for 32 beam rows a user: one new
    token a row, the cross-attention's keys and values once a user."""
    fcfg, model, batch, b, width = _model(config, 2)
    t = flops.context_tokens(fcfg, width)
    rows = b * BEAMS
    with torch.no_grad():
        enc, ctx_mask = model.encode_context(batch)
        empty = torch.zeros((rows, 0), dtype=torch.int32)
        counted = _count(lambda: model.decode_logits(enc, ctx_mask, empty, empty,
                                                     last_only=True))
    needed = b * flops.cross_kv_flops(fcfg, t) + rows * flops.decoder_flops(fcfg, 1, t, 1, 1)
    assert counted == needed - _unseen(fcfg, rows)


@pytest.mark.parametrize("n", [2, 3, 6])
def test_needed_causal_pairs(n):
    """A cached decode's self-attention: position i's query over its i + 1
    keys, through the port's attention, sums to the n(n + 1) / 2 query-key
    pairs of the needed count (4 * pairs * attn_dim products)."""
    heads, head_dim = 2, 8
    q, k, v = (torch.randn(1, heads, n, head_dim) for _ in range(3))
    counted = sum(_count(lambda i=i: dot_product_attention(q[:, :, i:i + 1], k[:, :, :i + 1],
                                                           v[:, :, :i + 1]))
                  for i in range(n))
    a = heads * head_dim
    assert counted == 4 * (n * (n + 1) // 2) * a - 2 * a  # the first position's one key
