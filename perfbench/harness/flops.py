"""Products of the stage-2 model, counted from the configuration's widths
and the generated inputs: 2 * m * n * k for every matrix product, nothing
for elementwise work. The needed count takes each needed token once:

- valid tokens only: a user's context is the user token and the valid
  history digits, padding is not counted;
- the beam: each digit's new token once per beam row, keys and values of
  earlier digits not recomputed, the cross-attention's keys and values of a
  user's context once per decoder layer;
- training: three times the forward, with no rematerialization; the
  decoder's needed tokens are BOS and the first D - 1 digits, whose logits
  the loss reads.

`executed=True` counts what the port runs instead (padded contexts, the
beam's recompute of earlier digits, the unused last decoder token); the
tests hold that variant against FlopCounterMode."""


BEAMS = 32


def _widths(cfg):
    return (cfg["decoder_embed_dim"], cfg["attn_embed_dim"], cfg["ffn_dim"],
            cfg["codebook_size"], cfg["attn_layers"] // 2)


def encoder_flops(cfg, t: int) -> int:
    """One context of t tokens through in_proj_context and the encoder."""
    e, a, f, _, layers = _widths(cfg)
    per_layer = 2 * t * a * 3 * a + 4 * t * t * a + 2 * t * a * a + 4 * t * a * f
    return 2 * t * e * a + layers * per_layer


def decoder_flops(cfg, n: int, t: int, out_rows: int, causal_pairs: int) -> int:
    """One row of n decoder tokens over a context of t tokens: in_proj, the
    blocks (self-attention over `causal_pairs` query-key pairs, the
    cross-attention's queries, scores and output, without its keys and
    values) and out_proj for `out_rows` positions."""
    e, a, f, k, layers = _widths(cfg)
    per_layer = (2 * n * a * 3 * a + 4 * causal_pairs * a + 2 * n * a * a
                 + 2 * n * a * a + 4 * n * t * a + 2 * n * a * a + 4 * n * a * f)
    return 2 * n * e * a + layers * per_layer + 2 * out_rows * a * k


def cross_kv_flops(cfg, t: int) -> int:
    """The cross-attention keys and values of one context, every layer."""
    _, a, _, _, layers = _widths(cfg)
    return layers * 2 * t * a * 2 * a


def context_tokens(cfg, history_len: int) -> int:
    return 1 + min(int(history_len), cfg["max_seq_len"]) * cfg["sem_id_dim"]


def beam_flops(cfg, history_lens, executed: bool = False) -> int:
    """One page: the encoder and the constrained beam search of each user."""
    d = cfg["sem_id_dim"]
    pad_t = 1 + cfg["max_seq_len"] * d
    total = 0
    for length in history_lens:
        t = pad_t if executed else context_tokens(cfg, length)
        total += encoder_flops(cfg, t)
        if executed:
            for i in range(d):
                n = i + 1
                total += cross_kv_flops(cfg, t)
                total += BEAMS * decoder_flops(cfg, n, t, 1, n * n)
        else:
            total += cross_kv_flops(cfg, t)
            for i in range(d):
                total += BEAMS * decoder_flops(cfg, 1, t, 1, i + 1)
    return total


def train_forward_flops(cfg, history_lens, executed: bool = False) -> int:
    """The training forward of a batch with these (cropped) history
    lengths."""
    d = cfg["sem_id_dim"]
    pad_t = 1 + cfg["max_seq_len"] * d
    total = 0
    for length in history_lens:
        t = pad_t if executed else context_tokens(cfg, length)
        n = d + 1 if executed else d
        pairs = n * n if executed else n * (n + 1) // 2
        total += (encoder_flops(cfg, t) + cross_kv_flops(cfg, t)
                  + decoder_flops(cfg, n, t, n if executed else d, pairs))
    return total


def train_step_flops(cfg, history_lens) -> int:
    """Needed products of one training step: three times the forward."""
    return 3 * train_forward_flops(cfg, history_lens)
