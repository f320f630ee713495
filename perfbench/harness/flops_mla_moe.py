"""Products and weight bytes of the decoder-only MLA-MoE retriever
(hidvae_tpu_torch/models/mla_moe.py), counted from the configuration's
widths and the generated inputs: 2 * m * n * k for every matrix product,
nothing for elementwise work.

The needed count of a page takes each needed token once, whatever
implements it: valid tokens alone (a user's context is the user token and
the valid history digits; padding is not counted), the prefill's causal
attention over the valid pairs, and in the beam each row's one new token
a digit, attending to its context and its earlier digits, with the head
over it. An MoE token is counted at its `num_experts_per_tok` routed
experts, the shared ones and the router.

`executed_*` count what the port runs instead (the prefill's projections
and attention over padded positions, the absorbed decode's products); the
tests hold them against FlopCounterMode."""

BEAMS = 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def _w(c):
    return (c["hidden_size"], c["num_attention_heads"], c["qk_nope_head_dim"],
            c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"])


def sem_id_dim(c):
    return c["n_layers"] + len(c.get("tag_class_counts") or [])


def n_moe_layers(c):
    return c["num_hidden_layers"] - c["first_k_dense_replace"]


def mla_projections(c) -> int:
    """q, the latent, its decompression and the output, one token."""
    d, h, dn, dr, dv, r = _w(c)
    return 2 * d * h * (dn + dr) + 2 * d * (r + dr) + 2 * r * h * (dn + dv) + 2 * h * dv * d


def attention_pair(c) -> int:
    """One query-key pair over every head: the score and the weighted value."""
    _, h, dn, dr, dv, _ = _w(c)
    return 2 * h * (dn + dr + dv)


def expert_row(c) -> int:
    """One token through one routed expert."""
    return 6 * c["hidden_size"] * c["moe_intermediate_size"]


def moe_token(c) -> int:
    """One token's shared experts and router (its routed rows apart)."""
    d = c["hidden_size"]
    return 6 * d * c["moe_intermediate_size"] * c["n_shared_experts"] + 2 * d * c[
        "n_routed_experts"]


def moe_flops(c, tokens: int, routed_rows: int) -> int:
    """Needed products of MoE layer calls over `tokens` tokens and
    `routed_rows` routed rows."""
    return routed_rows * expert_row(c) + tokens * moe_token(c)


def moe_weight_bytes(c, itemsize: int = 2) -> int:
    """Bytes of one MoE layer's held weights (experts, shared experts, the
    router's matrix), each read once a call."""
    d, e, w = c["hidden_size"], c["n_routed_experts"], c["moe_intermediate_size"]
    return itemsize * (3 * d * w * (e + c["n_shared_experts"]) + d * e)


def token_flops(c) -> int:
    """One token through every layer's projections and feed-forward."""
    dense = c["first_k_dense_replace"]
    ffn = dense * 6 * c["hidden_size"] * c["intermediate_size"] + n_moe_layers(c) * (
        c["num_experts_per_tok"] * expert_row(c) + moe_token(c))
    return c["num_hidden_layers"] * mla_projections(c) + ffn


def context_tokens(c, history_len: int) -> int:
    return 1 + min(int(history_len), c["max_seq_len"]) * sem_id_dim(c)


def page_flops(c, history_lens) -> int:
    """Needed products of one page: each user's prefill and constrained
    32-beam search."""
    layers, per, pair = c["num_hidden_layers"], token_flops(c), attention_pair(c)
    head = 2 * c["hidden_size"] * c["codebook_size"]
    total = 0
    for length in history_lens:
        t = context_tokens(c, length)
        total += t * per + layers * pair * t * (t + 1) // 2
        for i in range(sem_id_dim(c)):
            total += BEAMS * (per + layers * pair * (t + i + 1) + head)
    return total


def _executed_ffn(c) -> int:
    """The port's feed-forward products of one token: the dense layers, and
    in each MoE layer its routed experts' rows (grouped, unpadded), the
    shared experts and the router."""
    dense = c["first_k_dense_replace"] * 6 * c["hidden_size"] * c["intermediate_size"]
    return dense + n_moe_layers(c) * (c["num_experts_per_tok"] * expert_row(c) + moe_token(c))


def executed_prefill(c, rows: int, positions: int, valid: int) -> int:
    """The port's prefill of `rows` contexts of `positions` padded positions,
    `valid` valid tokens (the feed-forward runs on those alone)."""
    d, h, dn, dr, dv, r = _w(c)
    attn = c["num_hidden_layers"] * rows * positions * (
        mla_projections(c) + positions * 2 * h * (dn + dr + dv))
    return attn + valid * _executed_ffn(c)


def executed_step(c, rows: int, prefix: int, pos: int) -> int:
    """The port's decode step of `rows` beam rows over their users' latent
    prefixes of `prefix` positions at decoder position `pos`, the query
    absorbed: q and the latent, the query's fold into the latent, scores
    and weighted latents over the prefix and the row's pos + 1 own
    positions, the value half, the output; feed-forward and head. At pos 0
    the weighted sum over the row's one own latent is an elementwise
    product, no matrix product."""
    d, h, dn, dr, dv, r = _w(c)
    proj = 2 * d * h * (dn + dr) + 2 * d * (r + dr) + 2 * h * dv * d
    own = pos + 1 if pos else 0
    attn = 2 * h * (dn * r + (prefix + pos + 1) * (r + dr) + (prefix + own) * r + r * dv)
    per_row = c["num_hidden_layers"] * (proj + attn) + 2 * d * c["codebook_size"]
    return rows * (per_row + _executed_ffn(c))
