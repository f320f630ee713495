"""Plain PyTorch reference, in fp32 with TF32 off, of a decoder-only
generative retriever with DeepSeek-V3's block (`model_type` deepseek_v3:
latent attention with no query LoRA, decoupled rotary keys, dense SwiGLU
in the first `first_k_dense_replace` layers, sigmoid-routed experts with a
selection bias and shared experts after them) over
[user token, history digits, BOS, generated digits]. No cache, no
absorption of the query into the latent, no grouping of rows: each
sequence is run whole and unpadded. Imports torch alone.

Departures from the published model, each the retriever's:
- the vocabulary is the recommender's tokens: the ID table (K rows per
  semantic level, 1,000 per tag level, a padding row), hashed user buckets
  and a BOS vector in place of the text vocabulary, and the head maps to
  the K codes of a digit;
- positions count the user token (0), the valid history digits, BOS and
  the generated digits; padding takes none;
- the weights are held in the configuration's dtype (bf16) and computed in
  fp32 here;
- judging aids that change nothing where the program agrees with it: the
  routing may follow a given choice (`forward`'s `follow`), reporting how
  far each followed choice lies below the reference's own (off beyond
  ROUTE_TIE), so that one rounding-close choice does not send the two
  computations apart downstream; and the beam may keep the candidates a
  search under judgement kept where they lie within BEAM_TIE of its edge
  (`follow_near_ties`)."""

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

BEAMS = 32
NEG_LARGE = -1.0e9
INVALID_PENALTY = -10000.0
MAX_TAG_SIZE = 1000
KEY_BASE = 1024
# A near tie of the router: a followed expert's biased score lies within this
# of the reference's sixth-best (sigmoid scores in (0, 1)). bf16 serving's
# largest such deficit read 0.015-0.021 on the H100 (61 seeds, ~540k tokens
# each); leaving the bias out of the choice reads up to 0.065.
ROUTE_TIE = 3e-2
# A near tie at the beam's edge: a row the served search kept is followed
# within this share of the k-th score's size. On the H100 bf16 serving's
# kept rows lay up to 0.0138 below the reference's edge (check.beam_tie_max,
# 9 seeds), its scores within 0.0083 of fp32's (score_gap, 61 seeds); the
# kind's `edge` fault (ranks 33-40 kept for 25-32) reads best_gap 0.047-0.076
# at bands 0.01 to 0.03.
BEAM_TIE = 2e-2


@contextlib.contextmanager
def exact_fp32():
    """fp32 products at full precision (no TF32) inside, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def round_fp8(t):
    """Operands through float8 e4m3 with one scale per tensor."""
    x = t.float()
    scale = 448.0 / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Arith:
    """The products the model states in its compute dtype, in fp32 here;
    `lower="fp8"` rounds their operands through fp8 e4m3 (the control)."""

    def __init__(self, lower: Optional[str] = None):
        self.lower = lower

    def op(self, t):
        t = t.float()
        return round_fp8(t) if self.lower == "fp8" else t

    def linear(self, x, w):
        return F.linear(self.op(x), self.op(w))

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.op(a), self.op(b))


def spec(c, num_embeddings: int, sem_id_dim: int, n_sem_layers: int, user_buckets: int):
    """(name, shape, kind) of every weight; kind "linear" (fan-in the last
    axis), "embed", "ones" or "bias" (the routing bias, held in fp32)."""
    dim, h = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], \
        c["kv_lora_rank"]
    e, width = c["n_routed_experts"], c["moe_intermediate_size"]
    rows = num_embeddings * n_sem_layers + MAX_TAG_SIZE * (sem_id_dim - n_sem_layers) + 1
    out = [("sem_id_embedder.emb.weight", (rows, dim), "embed"),
           ("user_id_embedder.emb.weight", (user_buckets, dim), "embed"),
           ("bos_emb", (dim,), "embed")]

    def swiglu(p, w):
        out.extend([(f"{p}.gate_proj.weight", (w, dim), "linear"),
                    (f"{p}.up_proj.weight", (w, dim), "linear"),
                    (f"{p}.down_proj.weight", (dim, w), "linear")])

    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}"
        out.extend([(f"{p}.input_layernorm.weight", (dim,), "ones"),
                    (f"{p}.self_attn.q_proj.weight", (h * (dn + dr), dim), "linear"),
                    (f"{p}.self_attn.kv_a_proj_with_mqa.weight", (r + dr, dim), "linear"),
                    (f"{p}.self_attn.kv_a_layernorm.weight", (r,), "ones"),
                    (f"{p}.self_attn.kv_b_proj.weight", (h * (dn + dv), r), "linear"),
                    (f"{p}.self_attn.o_proj.weight", (dim, h * dv), "linear"),
                    (f"{p}.post_attention_layernorm.weight", (dim,), "ones")])
        if i < c["first_k_dense_replace"]:
            swiglu(f"{p}.mlp", c["intermediate_size"])
        else:
            out.extend([(f"{p}.mlp.gate.weight", (e, dim), "linear"),
                        (f"{p}.mlp.gate.e_score_correction_bias", (e,), "bias"),
                        (f"{p}.mlp.experts.gate_up_proj", (e, 2 * width, dim), "linear"),
                        (f"{p}.mlp.experts.down_proj", (e, dim, width), "linear")])
            swiglu(f"{p}.mlp.shared_experts", width * c["n_shared_experts"])
    out.extend([("norm.weight", (dim,), "ones"), ("out_proj.weight", (num_embeddings, dim),
                                                  "linear")])
    return out


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w.float()


def rope(x, pos, theta):
    """x [..., T, (h,) d] at positions [T], deepseek_v3's pair layout: the
    pairs (x[2j], x[2j + 1]) rotated and laid out de-interleaved."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv
    if x.dim() == 4:
        ang = ang[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * ang.cos() - b * ang.sin(), b * ang.cos() + a * ang.sin()], -1)


def id_rows(ids, tts, num_embeddings: int, n_sem_layers: int):
    """The ID table's row of each (digit, token type)."""
    ids, t = ids.long(), tts.long()
    sem = t * num_embeddings + ids
    tag = num_embeddings * n_sem_layers + (t - n_sem_layers) * MAX_TAG_SIZE + ids
    return torch.where(t < n_sem_layers, sem, tag)


def context(W, user: int, ids, tts, num_embeddings: int, n_sem_layers: int, user_buckets: int):
    """[1 + n, C]: the user token and the n valid history digits."""
    u = W["user_id_embedder.emb.weight"][user % user_buckets]
    rows = id_rows(ids, tts, num_embeddings, n_sem_layers)
    return torch.cat([u[None], W["sem_id_embedder.emb.weight"][rows]]).float()


def with_digits(W, ctx, digits, num_embeddings: int, n_sem_layers: int):
    """[S, 1 + n + 1 + m, C]: the context, BOS and the first m digits of
    each row of digits [S, m] (digit i of token type i)."""
    s, m = digits.shape
    tts = torch.arange(m, device=digits.device).expand(s, m)
    d = W["sem_id_embedder.emb.weight"][id_rows(digits, tts, num_embeddings, n_sem_layers)]
    bos = W["bos_emb"].expand(s, 1, -1)
    return torch.cat([ctx.expand(s, *ctx.shape), bos.float(), d.float()], 1)


def attention(W, c, p, x, ar):
    """Causal latent attention over x [S, T, C], keys and values decompressed."""
    h, dn, dr, dv, r = (c["num_attention_heads"], c["qk_nope_head_dim"],
                        c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"])
    s, t, _ = x.shape
    pos = torch.arange(t, device=x.device)
    q = ar.linear(x, W[f"{p}.q_proj.weight"]).view(s, t, h, dn + dr)
    ckv = ar.linear(x, W[f"{p}.kv_a_proj_with_mqa.weight"])
    lat = rms_norm(ckv[..., :r], W[f"{p}.kv_a_layernorm.weight"], c["rms_norm_eps"])
    kv = ar.linear(lat, W[f"{p}.kv_b_proj.weight"]).view(s, t, h, dn + dv)
    k_pe = rope(ckv[..., r:], pos, c["rope_theta"])[:, :, None].expand(s, t, h, dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, c["rope_theta"])], -1)
    k = torch.cat([kv[..., :dn], k_pe], -1)
    scores = ar.einsum("sqhd,skhd->shqk", q, k) * (dn + dr) ** -0.5
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    a = torch.softmax(torch.where(causal, scores, -torch.inf), -1)
    o = ar.einsum("shqk,skhd->sqhd", a, kv[..., dn:]).reshape(s, t, h * dv)
    return ar.linear(o, W[f"{p}.o_proj.weight"])


def swiglu(W, p, x, ar):
    g = ar.linear(x, W[f"{p}.gate_proj.weight"])
    return ar.linear(F.silu(g) * ar.linear(x, W[f"{p}.up_proj.weight"]),
                     W[f"{p}.down_proj.weight"])


def route(W, c, p, x, follow=None):
    """The router in fp32: (experts used [N, k], their weights [N, k], off
    [N], deficit [N]). Where `follow` [N, k] gives a choice (-1: none) it
    is used, and its deficit is how far below the reference's k-th biased
    score the followed choice's lowest lies (0 where the choices agree);
    off where that exceeds ROUTE_TIE."""
    k = c["num_experts_per_tok"]
    s = torch.sigmoid(F.linear(x, W[f"{p}.gate.weight"].float()))
    biased = s + W[f"{p}.gate.e_score_correction_bias"].float()
    top = torch.topk(biased, k, -1)
    idx, deficit = top.indices, torch.zeros(x.shape[0], device=x.device)
    if follow is not None:
        idx = torch.where((follow >= 0).all(-1)[:, None], follow, idx)
        same = torch.sort(idx, -1).values.eq(torch.sort(top.indices, -1).values).all(-1)
        low = biased.gather(1, idx).min(-1).values
        deficit = torch.where(same, 0.0, (top.values[:, -1] - low).clamp(min=0))
    w = s.gather(1, idx)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * c["routed_scaling_factor"], deficit > ROUTE_TIE, deficit


def moe(W, c, p, x, ar, follow=None):
    """The routed experts, each over the tokens that chose it, and the shared
    ones. (output [N, C], experts used [N, k], off [N], deficit [N])."""
    idx, w, off, deficit = route(W, c, p, x, follow)
    out = swiglu(W, f"{p}.shared_experts", x, ar)
    width, k = c["moe_intermediate_size"], c["num_experts_per_tok"]
    order = torch.argsort(idx.flatten(), stable=True)
    counts = torch.bincount(idx.flatten(), minlength=c["n_routed_experts"]).tolist()
    for e, part in enumerate(order.split(counts)):
        if part.numel() == 0:
            continue
        tok = part // k
        gu = ar.linear(x[tok], W[f"{p}.experts.gate_up_proj"][e])
        y = ar.linear(F.silu(gu[:, :width]) * gu[:, width:], W[f"{p}.experts.down_proj"][e])
        out = out.index_add(0, tok, y * w.flatten()[part][:, None])
    return out, idx, off, deficit


def forward(W, c, xs, ar=None, follow=None):
    """xs: groups [S, T, C] of whole sequences, each group of one length ->
    (logits [S, T, K] a group, routes a group: [(experts used [S, T, k],
    off [S, T], deficit [S, T]) per MoE layer]). Attention runs a group at
    a time, the rest over every token at once. `follow`: a group's experts
    to use per MoE layer, [layers, S, T, k] (-1: none), or None."""
    ar = ar or Arith()
    shapes = [x.shape[:2] for x in xs]
    sizes = [s * t for s, t in shapes]
    x = torch.cat([g.reshape(n, -1) for g, n in zip(xs, sizes)])
    if follow is not None and all(f is None for f in follow):
        follow = None
    if follow is not None:
        k = c["num_experts_per_tok"]
        follow = torch.cat([torch.full((c["num_hidden_layers"], n, k), -1, dtype=torch.long,
                                       device=x.device) if f is None else f.flatten(1, 2)
                            for f, n in zip(follow, sizes)], 1)
    eps, routes = c["rms_norm_eps"], []
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}"
        hn = rms_norm(x, W[f"{p}.input_layernorm.weight"], eps)
        x = x + torch.cat([attention(W, c, f"{p}.self_attn", g.view(s, t, -1), ar).flatten(0, 1)
                           for g, (s, t) in zip(hn.split(sizes), shapes)])
        hn = rms_norm(x, W[f"{p}.post_attention_layernorm.weight"], eps)
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(W, f"{p}.mlp", hn, ar)
        else:
            f = None if follow is None else follow[len(routes)]
            y, idx, off, deficit = moe(W, c, f"{p}.mlp", hn, ar, f)
            routes.append((idx, off, deficit))
            x = x + y
    logits = ar.linear(rms_norm(x, W["norm.weight"], eps), W["out_proj.weight"])
    split = [[t.split(sizes) for t in r] for r in routes]
    return ([g.view(s, t, -1) for g, (s, t) in zip(logits.split(sizes), shapes)],
            [[tuple(part[j].view(s, t, *part[j].shape[1:]) for part in r) for r in split]
             for j, (s, t) in enumerate(shapes)])


class PrefixSets:
    """Which digit prefixes the corpus table [N, D] holds, by length."""

    def __init__(self, table, n_codes: int):
        self.n_codes, self.keys = n_codes, []
        key = torch.zeros(table.shape[0], dtype=torch.long, device=table.device)
        for col in range(table.shape[1]):
            key = key * KEY_BASE + table[:, col].long()
            self.keys.append(torch.unique(key))
        self.full = key

    def valid_next(self, prefixes):
        """[R, K] bool: digit v may follow each prefix [R, i]."""
        key = prefix_keys(prefixes)
        cand = key[:, None] * KEY_BASE + torch.arange(self.n_codes, device=key.device)[None]
        keys = self.keys[prefixes.shape[1]]
        pos = torch.clamp(torch.searchsorted(keys, cand), max=keys.shape[0] - 1)
        return keys[pos] == cand

    def resolve(self, tuples):
        """The lowest corpus row holding each tuple [..., D], else -1."""
        key = prefix_keys(tuples)
        order = torch.sort(self.full, stable=True)
        pos = torch.clamp(torch.searchsorted(order.values, key), max=order.values.shape[0] - 1)
        return torch.where(order.values[pos] == key, order.indices[pos],
                           torch.full_like(key, -1))


def prefix_keys(digits):
    key = torch.zeros(digits.shape[:-1], dtype=torch.long, device=digits.device)
    for col in range(digits.shape[-1]):
        key = key * KEY_BASE + digits[..., col].long()
    return key


def digit_log_probs(logits, digits, sets, temperature=1.0):
    """Constrained log-probability [S, m] of each digit of digits [S, m]
    from the logits [S, m, K] that predict them (INVALID_PENALTY where the
    prefix leaves the corpus)."""
    logp = torch.log_softmax(logits.float() / temperature, -1)
    out = []
    for i in range(digits.shape[1]):
        step = logp[:, i] + INVALID_PENALTY * (~sets.valid_next(digits[:, :i]))
        out.append(step.gather(1, digits[:, i:i + 1].long())[:, 0])
    return torch.stack(out, 1)


def follow_near_ties(scores, gen, i, held, k, taken=None):
    """The k candidates [k] a beam keeps at digit i from scores [k * K],
    by descending score (lower index first among equal ones), with each
    candidate whose prefix key is in `held` (the digits 0..i that a search
    under judgement kept) taken ahead of the others within BEAM_TIE of the
    k-th score's size. `taken`: a list given the share of that size by
    which the lowest kept candidate lies below the k-th score."""
    tie = BEAM_TIE
    n = scores.shape[0]
    kk = n // gen.shape[0]
    order = torch.sort(scores, descending=True, stable=True).indices
    edge = scores[order[k - 1]]
    band = tie * torch.clamp(edge.abs(), min=1.0)
    cand = (prefix_keys(gen[:, :i])[:, None] * KEY_BASE
            + torch.arange(kk, device=scores.device)[None]).reshape(n)
    sure = scores > edge + band
    near = torch.isin(cand, held) & ~sure & (scores >= edge - band)
    rank = (2 * sure.long() + near.long())[order]
    order = order[torch.sort(rank, descending=True, stable=True).indices]
    chosen = torch.sort(order[:k]).values
    if taken is not None:
        taken.append(float((edge - scores[chosen].min()).clamp(min=0)
                           / torch.clamp(edge.abs(), min=1.0)))
    return chosen[torch.sort(scores[chosen], descending=True, stable=True).indices]


def beam_search(W, c, ctxs, sets, num_embeddings: int, n_sem_layers: int, sem_id_dim: int,
                ar=None, follow=None, route_of=None, temperature=1.0, k=BEAMS, ties=None):
    """The 32-beam searches of users with contexts `ctxs` [1 + n, C] over
    sem_id_dim digits constrained to `sets`, each step rerunning every
    row's whole sequence. A user's result: (digits [k, D], scores [k],
    [per step: (the rows' digits before it [k, step], experts of the new
    token [layers, k, e_k])]). `follow`: a user's prefix keys a digit [m_i]
    (the digits 0..i a search under judgement kept), whose near ties at the
    beam's edge go their way; `route_of(user, rows' digits [k, step])`: the
    routing to follow for those sequences, or None; `ties`: as
    `follow_near_ties`' `taken`."""
    kk, dev, n = num_embeddings, ctxs[0].device, len(ctxs)
    gen = [torch.zeros((k, sem_id_dim), dtype=torch.long, device=dev) for _ in ctxs]
    logp = [torch.full((k,), NEG_LARGE, device=dev) for _ in ctxs]
    steps = [[] for _ in ctxs]
    for u in range(n):
        logp[u][0] = 0.0
    for i in range(sem_id_dim):
        prev = [g[:, :i] for g in gen]
        xs = [with_digits(W, ctx, p, num_embeddings, n_sem_layers) for ctx, p in zip(ctxs, prev)]
        fol = None if route_of is None else [route_of(u, prev[u]) for u in range(n)]
        logits, routes = forward(W, c, xs, ar, fol)
        for u in range(n):
            steps[u].append((prev[u], torch.stack([idx[:, -1] for idx, _, _ in routes[u]])))
            step = torch.log_softmax(logits[u][:, -1].float() / temperature, -1)
            step = step + INVALID_PENALTY * (~sets.valid_next(prev[u]))
            scores = (step + logp[u][:, None]).reshape(k * kk)
            if follow is None:
                order = torch.sort(scores, descending=True, stable=True).indices[:k]
            else:
                order = follow_near_ties(scores, gen[u], i, follow[u][i], k, ties)
            gen[u] = gen[u][torch.div(order, kk, rounding_mode="floor")].clone()
            gen[u][:, i] = order % kk
            logp[u] = scores[order]
    return [(g, lp, st) for g, lp, st in zip(gen, logp, steps)]
