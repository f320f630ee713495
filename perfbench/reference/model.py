"""Plain PyTorch reference of the two stages at a configuration's widths:
the stage-1 tokenizer's corpus table (encoder MLP, residual quantization by
the expanded L2 distance, the HiD-VAE's tag heads), and the stage-2
encoder-decoder's context encoder, teacher-forced scores, constrained beam
search and training loss. Functions over a {name: tensor} of weights, with
the casts of the published model: `Arith.dtype` is the compute dtype of
the dense layers (None: fp32), and `Arith.lower` rounds every product's
operands to a lower precision for the control ("tf32", "fp8").

Dropout draws follow the order and shapes in which the served model draws
them from a step's generator, so a train-mode forward here sees the same
masks. The flash route (contexts of 2,048 tokens or more) is not modelled:
no cell reaches it."""

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

NEG_FILL = torch.finfo(torch.float32).min
BEAMS = 32
NEG_LARGE = -1.0e9
INVALID_PENALTY = -10000.0
INPUT_DROPOUT = 0.5
MAX_TAG_SIZE = 1000
KEY_BASE = 1024  # every digit, tags included, is below this
TIE_REL = 1e-5  # a near tie: within 1e-5 of the scale, ~80 fp32 ulps
STEP_SALT = 0x5EED
TABLE_BLOCK = 8192  # items encoded at once by corpus_table


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


def round_tf32(t):
    """fp32 operands rounded to TF32's 10 mantissa bits (nearest); the
    gradient passes straight through."""
    if t.dtype != torch.float32:
        return t
    bits = t.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach()


def round_fp8(t):
    """Operands through float8 e4m3 with one scale per tensor; the gradient
    passes straight through."""
    x = t.detach().float()
    scale = 448.0 / x.abs().amax().clamp(min=1e-30)
    r = ((x * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
    return t + (r - t).detach()


@dataclass
class Arith:
    dtype: Optional[torch.dtype] = None
    lower: Optional[str] = None

    def op(self, t):
        if self.lower is None:
            return t
        if self.lower == "tf32":
            return round_tf32(t)
        if self.lower == "fp8":
            return round_fp8(t)
        raise ValueError(f"unknown lower precision {self.lower!r}")

    def linear(self, x, w, b=None):
        """A dense layer: input and weight cast to the compute dtype."""
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        return F.linear(self.op(x), self.op(w), b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.op(a), self.op(b))


def l2norm(x, eps=1e-12):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)), min=eps)


def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    y = (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)).to(x.dtype)
    return y * w


def dropout(x, p, g):
    if g is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=g, device=x.device, dtype=torch.float32) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------- stage 1: the corpus table ----------------

def encode_items(W, cfg, x, ar: Arith):
    """Encoder MLP (bias-free, SiLU between), L2-normalized where the
    codebooks are."""
    n = len(cfg["hidden_dims"]) + 1
    h = x.float()
    for i in range(n):
        h = ar.linear(h, W[f"encoder.dense_{i}.weight"])
        if i != n - 1:
            h = F.silu(h)
    if cfg["codebook_normalize"]:
        h = l2norm(h.float())
    return h.float()


def codebooks(W, cfg):
    """[L, K, D]; level 0 L2-normalized where the config says so."""
    cbs = []
    for i in range(cfg["n_layers"]):
        cb = W[f"quantize_{i}.embedding"]
        cbs.append(l2norm(cb) if i == 0 and cfg["codebook_normalize"] else cb)
    return torch.stack(cbs)


def quantize(x, cbs, ar: Arith):
    """Residual quantization: per level the nearest code by the expanded
    squared L2 distance (first index on ties). ids [B, L] int64."""
    res, ids = x, []
    for level in range(cbs.shape[0]):
        cb = cbs[level]
        dist = (torch.sum(res * res, -1, keepdim=True) + torch.sum(cb * cb, -1)[None]
                - 2.0 * ar.einsum("bd,kd->bk", res, cb))
        idx = torch.argmin(dist, dim=-1)
        ids.append(idx)
        res = res - cb[idx]
    return torch.stack(ids, dim=-1)


def _layer_norm(W, name, h):
    w, b = W[f"{name}.weight"], W[f"{name}.bias"]
    return F.layer_norm(h.float(), (h.shape[-1],), w, b, eps=1e-6)


def tag_logits(W, cfg, ids, cbs, ar: Arith):
    """Each tagged level's class logits [B, C] from the codes of the levels
    up to it."""
    out, embs = [], []
    for level in range(len(cfg.get("tag_class_counts") or [])):
        p = f"tag_predictor_{level}"

        def lin(name, h):
            return ar.linear(h, W[f"{p}.{name}.weight"], W[f"{p}.{name}.bias"])

        embs.append(cbs[level][ids[:, level]])
        x = torch.cat(embs, dim=-1)
        a = F.relu(lin("attn_0", x))
        a = F.gelu(lin("attn_1", a), approximate="tanh")
        h = x * torch.sigmoid(lin("attn_2", a))
        if level > 0:
            h = l2norm(h)
        h = F.relu(_layer_norm(W, f"{p}.feat_ln", lin("feat", h)))
        for blk in range(2):
            r = F.relu(_layer_norm(W, f"{p}.res{blk}_ln0", lin(f"res{blk}_0", h)))
            r = F.relu(lin(f"res{blk}_1", r))
            h = h + _layer_norm(W, f"{p}.res{blk}_ln1", r)
        c = F.relu(_layer_norm(W, f"{p}.cls_ln", lin("cls_0", h)))
        c = F.relu(lin("cls_1", c))
        out.append(lin("cls_out", c).float())
    return out


def predict_tags(W, cfg, ids, cbs, ar: Arith):
    """Each tagged level's most likely class (first on ties), or None."""
    preds = [torch.argmax(torch.softmax(lg, -1), dim=-1) for lg in tag_logits(W, cfg, ids,
                                                                               cbs, ar)]
    return torch.stack(preds, dim=-1) if preds else None


def corpus_table(W, cfg, features, ar: Arith = Arith()):
    """[N, D] int64 ID tuple of every item: semantic IDs, then tag IDs."""
    cbs = codebooks(W, cfg)
    out = []
    with exact_fp32(), torch.no_grad():
        for s in range(0, features.shape[0], TABLE_BLOCK):
            x = encode_items(W, cfg, features[s:s + TABLE_BLOCK], ar)
            ids = quantize(x, cbs, ar)
            tags = predict_tags(W, cfg, ids, cbs, ar)
            out.append(ids if tags is None else torch.cat([ids, tags], -1))
    return torch.cat(out)


def near_tie_rows(W, cfg, features, ref_table, table, tie=TIE_REL):
    """The rows where `table` differs from the reference's, split into near
    ties and the rest: a row is a near tie when, following its own codes
    level by level, each code's distance lies within `tie` times the
    distances' scale of the nearest code's, and each tag's logit within
    `tie` times the logits' scale of the best one. Two exact fp32 sweeps
    that sum in other orders can part only there. Returns (row indices of
    the near ties, the number of other differing rows)."""
    table = table.long()
    if table.shape != ref_table.shape:
        return table.new_zeros((0,)), int(ref_table.shape[0])
    rows = (table != ref_table).any(1).nonzero()[:, 0]
    if rows.numel() == 0:
        return rows, 0
    mine = table[rows]
    cbs = codebooks(W, cfg)
    k, n_sem = cfg["codebook_size"], cfg["n_layers"]
    ok = ((mine[:, :n_sem] >= 0) & (mine[:, :n_sem] < k)).all(1)
    codes = torch.where(ok[:, None], mine[:, :n_sem], torch.zeros_like(mine[:, :n_sem]))
    with exact_fp32(), torch.no_grad():
        res = encode_items(W, cfg, features[rows], Arith())
        for level in range(n_sem):
            cb = cbs[level]
            dist = (torch.sum(res * res, -1, keepdim=True) + torch.sum(cb * cb, -1)[None]
                    - 2.0 * (res @ cb.T))
            scale = torch.sum(res * res, -1) + torch.sum(cb * cb, -1).max()
            chosen = dist.gather(1, codes[:, level:level + 1])[:, 0]
            ok &= chosen - dist.min(1).values <= tie * scale
            res = res - cb[codes[:, level]]
        for level, logits in enumerate(tag_logits(W, cfg, codes, cbs, Arith())):
            tag = mine[:, n_sem + level]
            fits = (tag >= 0) & (tag < logits.shape[1])
            got = logits.gather(1, torch.clamp(tag, 0, logits.shape[1] - 1)[:, None])[:, 0]
            best = logits.max(1).values
            ok &= fits & (best - got <= tie * (logits.abs().max(1).values + 1.0))
    return rows[ok], int((~ok).sum())


def adopt_near_ties(W, cfg, features, ref_table, table):
    """(the reference's table with the near-tie rows of `table` taken over,
    the number of other differing rows). The stages after the table follow
    it, so that a near tie is judged once, here, and not again as a
    different history downstream."""
    ties, off = near_tie_rows(W, cfg, features, ref_table, table)
    merged = ref_table.clone()
    merged[ties] = table.long()[ties]
    return merged, off


# ---------------- stage 2: the encoder-decoder ----------------

def embedding_slots(cfg, ids, ttids, valid=None):
    """Row of the ID table of every token (semantic digits by level, tag
    digits by tag level after them, the last row for padding)."""
    k, n_sem = cfg["codebook_size"], cfg["n_layers"]
    n_tag = len(cfg.get("tag_class_counts") or [])
    pad = k * n_sem + MAX_TAG_SIZE * n_tag
    t, ids = ttids.long(), ids.long()
    is_sem = t < n_sem
    sem = t * k + torch.clamp(ids, 0, k - 1)
    tag = k * n_sem + (t - n_sem) * MAX_TAG_SIZE + torch.clamp(ids, 0, MAX_TAG_SIZE - 1)
    slots = torch.where(is_sem, sem, tag)
    ok = torch.where(is_sem, t < n_sem, (t - n_sem) < n_tag)
    slots = torch.where(ok, slots, torch.full_like(slots, pad))
    if valid is not None:
        slots = torch.where(valid, slots, torch.full_like(slots, pad))
    return slots, pad


def id_embedding(W, cfg, ids, ttids, valid=None):
    slots, pad = embedding_slots(cfg, ids, ttids, valid)
    e = W["sem_id_embedder.emb.weight"][slots]
    return torch.where((slots == pad)[..., None], torch.zeros_like(e), e)


def attention(W, p, x, kv, ar: Arith, *, cross=False, causal=False, kv_mask=None):
    """Multi-head attention as the model's block runs it: fp32 scores and
    softmax, weights in the input's dtype. With `cross` and more query rows
    than key rows, each key row serves a group of consecutive query rows."""
    h = W[f"{p}.proj.weight"].shape[0] // W["_head_dim"]
    if cross:
        q = ar.linear(x, W[f"{p}.q.weight"])
        k, v = ar.linear(kv, W[f"{p}.kv.weight"]).chunk(2, dim=-1)
    else:
        q, k, v = ar.linear(x, W[f"{p}.qkv.weight"]).chunk(3, dim=-1)

    def heads(t):
        b, n, c = t.shape
        return t.reshape(b, n, h, c // h).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scale = q.shape[-1] ** -0.5
    if cross and q.shape[0] != k.shape[0]:
        b = k.shape[0]
        g = q.shape[0] // b
        qg = q.reshape(b, g, *q.shape[1:])
        logits = ar.einsum("bghqd,bhkd->bghqk", qg.float(), k.float()) * scale
        if kv_mask is not None:
            logits = torch.where(kv_mask[:, None, None, None, :], logits,
                                 torch.full_like(logits, NEG_FILL))
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        out = ar.einsum("bghqk,bhkd->bghqd", w, v).reshape(b * g, *q.shape[1:])
    else:
        mask = None
        if causal:
            n = q.shape[2]
            mask = torch.tril(torch.ones((n, k.shape[2]), dtype=torch.bool,
                                         device=q.device))[None, None]
        if kv_mask is not None:
            pad = kv_mask[:, None, None, :]
            mask = pad if mask is None else mask & pad
        logits = ar.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        if mask is not None:
            logits = torch.where(mask, logits, torch.full_like(logits, NEG_FILL))
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        out = ar.einsum("bhqk,bhkd->bhqd", w, v)
    b, hh, n, d = out.shape
    return ar.linear(out.transpose(1, 2).reshape(b, n, hh * d), W[f"{p}.proj.weight"])


def block(W, p, x, ar: Arith, g, drop_p, *, causal, self_mask=None, ctx=None, ctx_mask=None):
    """Pre-norm block: self-attention, cross-attention (query: the block's
    input), SiLU feed-forward; dropout where the model applies it."""
    out = x + attention(W, f"{p}.attention", dropout(rms_norm(x, W[f"{p}.attn_norm.weight"]),
                                                     drop_p, g),
                        None, ar, causal=causal, kv_mask=self_mask)
    if ctx is not None:
        out = out + attention(
            W, f"{p}.cross_attention",
            dropout(rms_norm(x, W[f"{p}.cross_attn_norm.weight"]), drop_p, g), ctx, ar,
            cross=True, kv_mask=ctx_mask)
    h = ar.linear(rms_norm(out, W[f"{p}.ffn_norm.weight"]), W[f"{p}.ff.dense_0.weight"])
    h = dropout(F.silu(h), drop_p, g)
    h = ar.linear(h, W[f"{p}.ff.dense_1.weight"])
    return out + dropout(h, drop_p, g)


def encode_context(W, cfg, ar: Arith, user_ids, sem_ids, seq_mask, ttids, g=None,
                   drop_p=0.0):
    """The history's encoder output [B, 1 + T, A] and its mask."""
    user = W["user_id_embedder.emb.weight"][torch.remainder(user_ids.long(),
                                                            cfg["user_buckets"])]
    seq = id_embedding(W, cfg, sem_ids, ttids, seq_mask)
    b, t, _ = seq.shape
    ctx = torch.cat([user[:, None, :], W["wpe.weight"][:t][None] + seq], dim=1)
    mask = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=ctx.device), seq_mask], 1)
    ctx = dropout(rms_norm(ctx, W["norm.weight"]), INPUT_DROPOUT, g)
    x = ar.linear(ctx, W["in_proj_context.weight"])
    for i in range(cfg["attn_layers"] // 2):
        x = block(W, f"transformer.encoder.block_{i}", x, ar, g, drop_p, causal=False,
                  self_mask=mask)
    return x, mask


def decode_logits(W, cfg, ar: Arith, enc, mask, fut_ids, fut_tt, g=None, drop_p=0.0,
                  last_only=False):
    """Causal decoder over BOS + digits -> [R, n + 1 (or 1), K] logits; R
    may be a multiple of the context rows (beams)."""
    r = fut_ids.shape[0]
    fut = id_embedding(W, cfg, fut_ids, fut_tt) + W["tte.weight"][fut_tt.long()]
    bos = W["bos_emb"].expand(r, 1, W["bos_emb"].shape[0])
    x = torch.cat([bos, fut], dim=1)
    x = dropout(rms_norm(x, W["norm_cxt.weight"]), INPUT_DROPOUT, g)
    x = ar.linear(x, W["in_proj.weight"])
    for i in range(cfg["attn_layers"] // 2):
        x = block(W, f"transformer.decoder.block_{i}", x, ar, g, drop_p, causal=True,
                  ctx=enc, ctx_mask=mask)
    if last_only:
        x = x[:, -1:, :]
    return ar.linear(x, W["out_proj.weight"])


def with_head_dim(W, cfg):
    """The weights with the attention head width the blocks split by."""
    return {**W, "_head_dim": cfg["attn_embed_dim"] // cfg["attn_heads"]}


# ---------------- serving: prefix constraint, scores, beam search ----------------

class PrefixSets:
    """Which digit prefixes the corpus holds, by prefix length: sorted keys
    of table[:, :l] in base KEY_BASE."""

    def __init__(self, table, n_digits: int):
        self.n_digits = n_digits
        t = table.long()
        self.keys = []
        key = torch.zeros(t.shape[0], dtype=torch.long, device=t.device)
        for col in range(t.shape[1]):
            key = key * KEY_BASE + t[:, col]
            self.keys.append(torch.unique(key))
        self.full = key

    def valid_next(self, prefixes):
        """[R, K] bool: digit v may follow each prefix [R, i] (i >= 0)."""
        r, i = prefixes.shape
        key = torch.zeros(r, dtype=torch.long, device=prefixes.device)
        for col in range(i):
            key = key * KEY_BASE + prefixes[:, col].long()
        cand = key[:, None] * KEY_BASE + torch.arange(self.n_digits, device=key.device)[None]
        keys = self.keys[i]
        pos = torch.clamp(torch.searchsorted(keys, cand), max=keys.shape[0] - 1)
        return keys[pos] == cand


def score_tuples(W, cfg, ar: Arith, enc, mask, tuples, sets: PrefixSets, temperature=1.0):
    """Teacher-forced constrained log-probability of each tuple [B, k, D]
    (per digit: log-softmax at the temperature, INVALID_PENALTY where the
    prefix leaves the corpus), summed over the digits. [B, k]."""
    b, k, d = tuples.shape
    flat = tuples.reshape(b * k, d).long()
    tt = torch.arange(d, device=flat.device).repeat(b * k, 1)
    logits = decode_logits(W, cfg, ar, enc, mask, flat[:, :d - 1], tt[:, :d - 1])
    logp = torch.log_softmax(logits.float() / temperature, dim=-1)        # [R, d, K]
    score = torch.zeros(b * k, device=flat.device)
    for i in range(d):
        valid = sets.valid_next(flat[:, :i])
        step = logp[:, i, :] + INVALID_PENALTY * (~valid)
        score = score + step.gather(1, flat[:, i:i + 1])[:, 0]
    return score.reshape(b, k)


def prefix_keys(digits):
    """Base-KEY_BASE key of each digit prefix [..., i] -> [...]."""
    key = torch.zeros(digits.shape[:-1], dtype=torch.long, device=digits.device)
    for col in range(digits.shape[-1]):
        key = key * KEY_BASE + digits[..., col].long()
    return key


def follow_near_ties(scores, gen, i, follow, k):
    """The k candidates [B, k] a beam keeps at digit i, by descending score
    (lower index first among equal scores), with each candidate whose
    prefix begins a tuple of `follow` [B, m, D] taken ahead of the others
    whose scores lie within TIE_REL of the k-th's scale: where two exact
    fp32 searches can part by rounding alone, the reference keeps what the
    search it judges kept. Candidates above that band keep their places."""
    b, n = scores.shape
    kk = n // gen.shape[1]
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    edge = torch.gather(scores, 1, order[:, k - 1:k])
    band = TIE_REL * torch.clamp(edge.abs(), min=1.0)
    parent = prefix_keys(gen[:, :, :i])
    cand = (parent[:, :, None] * KEY_BASE
            + torch.arange(kk, device=scores.device)[None, None]).reshape(b, n)
    want = prefix_keys(follow[:, :, :i + 1].long())
    held = (cand[:, :, None] == want[:, None, :]).any(-1)
    sure = scores > edge + band
    near = held & ~sure & (scores >= edge - band)
    rank = torch.gather(2 * sure.long() + near.long(), 1, order)
    order = torch.gather(order, 1, torch.sort(rank, dim=-1, descending=True,
                                              stable=True).indices)
    chosen = torch.sort(order[:, :k], dim=-1).values
    top = torch.gather(scores, 1, chosen)
    return torch.gather(chosen, 1, torch.sort(top, dim=-1, descending=True,
                                              stable=True).indices)


def beam_search(W, cfg, ar: Arith, enc, mask, sets: PrefixSets, temperature=1.0,
                follow=None):
    """32-beam search constrained to the corpus: (ids [B, 32, D], scores
    [B, 32]), descending, lower index first among equal scores. With
    `follow`, the tuples [B, m, D] a search under judgement gave for the
    same rows, near ties at the beam's edge go its way (`follow_near_ties`)."""
    b = enc.shape[0]
    d, kk, k = len(sets.keys), cfg["codebook_size"], BEAMS
    dev = enc.device
    tt = torch.arange(d, device=dev).repeat(b * k, 1)
    gen = torch.zeros((b, k, d), dtype=torch.long, device=dev)
    logp = torch.full((b, k), NEG_LARGE, device=dev)
    logp[:, 0] = 0.0
    for i in range(d):
        prev = gen.reshape(b * k, d)[:, :i]
        logits = decode_logits(W, cfg, ar, enc, mask, prev, tt[:, :i], last_only=True)
        step = torch.log_softmax(logits[:, 0, :].float() / temperature, dim=-1)
        step = step + INVALID_PENALTY * (~sets.valid_next(prev))
        scores = (step + logp.reshape(b * k, 1)).reshape(b, k * kk)
        if follow is None:
            order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]
        else:
            order = follow_near_ties(scores, gen, i, follow, k)
        top = torch.gather(scores, 1, order)
        parent = torch.div(order, kk, rounding_mode="floor")
        gen = torch.gather(gen, 1, parent[..., None].expand(b, k, d)).clone()
        gen[:, :, i] = order % kk
        logp = top
    return gen, logp


def resolve(sets: PrefixSets, tuples):
    """The lowest corpus row holding each tuple [..., D], else -1."""
    key = prefix_keys(tuples)
    order = torch.sort(sets.full, stable=True)
    pos = torch.clamp(torch.searchsorted(order.values, key), max=order.values.shape[0] - 1)
    return torch.where(order.values[pos] == key, order.indices[pos], torch.full_like(key, -1))


def tokenize(table, user_ids, items, fut):
    """History items [B, N] (-1 padded) -> (user ids, sem ids [B, N*D],
    mask, token types, target tuple [B, D])."""
    n_items, d = table.shape
    b, n = items.shape
    valid = (items >= 0) & (items < n_items)
    ids = table[torch.where(valid, items, torch.zeros_like(items)).long()].reshape(b, n * d)
    mask = torch.repeat_interleave(items >= 0, d, dim=1)
    ids = torch.where(mask, ids, torch.full_like(ids, -1))
    tt = torch.arange(d, device=items.device).repeat(b, n)
    return user_ids, ids, mask, tt, table[torch.clamp(fut, 0, n_items - 1).long()]


def pad_histories(items, max_len: int):
    """The most recent `max_len` valid items of each row, in order, at the
    left; -1 after them."""
    items = items.long()
    b, n = items.shape
    valid = items >= 0
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True).indices
    packed = torch.gather(items, 1, order)
    counts = valid.sum(1)
    keep = torch.clamp(counts, max=max_len)
    src = counts[:, None] - keep[:, None] + torch.arange(max_len, device=items.device)[None]
    got = torch.gather(packed, 1, torch.clamp(src, 0, max(n - 1, 0)))
    inside = torch.arange(max_len, device=items.device)[None] < keep[:, None]
    return torch.where(inside, got, torch.full_like(got, -1))


# ---------------- training: sampling, loss, AdamW ----------------

def step_generator(seed: int, step: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0x7FFFFFFF) << 32 | STEP_SALT << 16) ^ (step & 0xFFFFFFFF))
    return g


def sample_batch(pool, table, batch_size: int, g, min_len: int = 3):
    """Rows drawn with replacement, a random window of each cropped (its
    last item the new target), tokenized by the table."""
    users, items, fut = pool
    dev = items.device
    idx = torch.randint(0, users.shape[0], (batch_size,), generator=g, device=dev)
    u, hist, target = users[idx], items[idx], fut[idx]
    u1 = torch.rand((batch_size,), generator=g, device=dev)
    u2 = torch.rand((batch_size,), generator=g, device=dev)
    b, n = hist.shape
    lengths = torch.sum(hist >= 0, dim=1).to(torch.int32)
    full = lengths + 1
    win = min_len + torch.floor(u1 * torch.clamp(full - min_len + 1, min=1)).to(torch.int32)
    win = torch.minimum(win, full)
    start = torch.floor(u2 * (full - win + 1)).to(torch.int32)
    cols = torch.arange(n, dtype=torch.int32, device=dev)[None]
    pos = start[:, None] + cols
    got = torch.gather(hist, 1, torch.clamp(pos, 0, n - 1).long())
    vals = torch.where(pos == lengths[:, None], target[:, None], got)
    new_items = torch.where(cols < (win - 1)[:, None], vals, torch.full_like(vals, -1))
    fpos = start + win - 1
    at = torch.gather(hist, 1, torch.clamp(fpos, 0, n - 1).long()[:, None])[:, 0]
    new_fut = torch.where(fpos == lengths, target, at)
    apply = full > min_len
    hist = torch.where(apply[:, None], new_items, hist)
    target = torch.where(apply, new_fut, target)
    return tokenize(table, u, hist, target)


def train_loss(W, cfg, ar: Arith, batch, g, drop_p):
    """Mean over rows of the summed per-digit cross-entropy; targets outside
    [0, K) are left out."""
    user_ids, ids, mask, tt, fut = batch
    enc, cmask = encode_context(W, cfg, ar, user_ids, ids, mask, tt, g, drop_p)
    d = fut.shape[1]
    ftt = torch.arange(d, device=fut.device).repeat(fut.shape[0], 1)
    logits = decode_logits(W, cfg, ar, enc, cmask, fut, ftt, g, drop_p)[:, :-1, :].float()
    target = fut.long()
    ignore = (target < 0) | (target >= cfg["codebook_size"])
    target = torch.where(ignore, torch.zeros_like(target), target)
    nll = -torch.gather(torch.log_softmax(logits, -1), -1, target[..., None])[..., 0]
    return torch.where(ignore, torch.zeros_like(nll), nll).sum(1).mean()


def train_steps(W0, cfg, ar: Arith, pool, table, seed: int, n_steps: int):
    """`n_steps` AdamW steps (betas 0.9 / 0.999, eps 1e-8, decoupled decay,
    the configuration's rate and decay) from the weights W0, each step's
    sample and dropout drawn from its generator. Returns (losses, the first
    step's gradients, the weights after the last step)."""
    lr, wd, p = cfg["learning_rate"], cfg["weight_decay"], cfg["dropout"]
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in W0.items() if v.is_floating_point()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for step in range(n_steps):
        g = step_generator(seed, step, table.device)
        batch = sample_batch(pool, table, cfg["batch_size"], g)
        loss = train_loss(with_head_dim(params, cfg), cfg, ar, batch, g, p)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: gr.detach().clone() for k, gr in zip(params, grads)}
        t = step + 1
        with torch.no_grad():
            for (k, w), gr in zip(params.items(), grads):
                w.mul_(1.0 - lr * wd)
                m[k].lerp_(gr, 0.1)
                v2[k].mul_(0.999).addcmul_(gr, gr, value=0.001)
                denom = (v2[k].sqrt() / math.sqrt(1.0 - 0.999 ** t)).add_(1e-8)
                w.addcdiv_(m[k], denom, value=-lr / (1.0 - 0.9 ** t))
    return losses, first, {k: w.detach() for k, w in params.items()}
