"""Stage-2 retrieval models and their constrained beam search (counterpart
of hidvae_tpu/models/retrieval.py). Shared (`RetrievalModel`): the beam
(fixed [B*k] shapes, the context run once, each beam's corpus range
narrowed by binary search, one new token a row a digit through the
topology's `encode_context` / `start_decode` / `decode_step`). Per
topology: `EncoderDecoderRetrievalModel` here (cross-attention through a
per-page `DecoderCache`; dropout from a generator given to `forward`;
`dtype` flax's; `remat`; tensor-parallel logits gathered along the
vocab) and the decoder-only `models/mla_moe.py`."""

import warnings
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch
from hidvae_tpu_torch.models.embedder import SemIdEmbedder, UserIdEmbedder
from hidvae_tpu_torch.models.layers import RMSNorm, dense
from hidvae_tpu_torch.models.transformer import DecoderCache, TransformerEncoderDecoder
from hidvae_tpu_torch.ops.dropout import dropout as drop
from hidvae_tpu_torch.ops.prefix_search import (
    first_digit_mask,
    narrow_range,
    trie_digit_mask,
    valid_digit_mask,
)
from hidvae_tpu_torch.parallel.collectives import gather_from_model
from hidvae_tpu_torch.utils.debug import count, note, span, tracing

BEAMS = 32
NEG_LARGE = -1.0e9
INVALID_PENALTY = -10000.0
INPUT_DROPOUT = 0.5  # hardcoded in the reference (retrieval.py:105)


@dataclass
class ModelOutput:
    loss: Optional[torch.Tensor]
    logits: torch.Tensor
    loss_d: Optional[torch.Tensor]


@dataclass
class GenerationOutput:
    sem_ids: torch.Tensor     # [B, k, D]
    log_probas: torch.Tensor  # [B, k]


def top_k_first_index(scores, k: int):
    """Top k along the last axis, descending; among equal scores the lower
    index comes first (the tie order of jax.lax.top_k)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(scores, -1, order), order


class RetrievalModel(nn.Module):
    """`num_embeddings` codes a digit, `sem_id_dim` digits; `encode_context`
    -> (context, mask [B, T]), `start_decode(context, mask, rows)` -> a
    cache of rows, `decode_step(cache, pos, sem_ids)` -> [rows, 1, K]."""

    def generate_next_sem_id(self, batch: TokenizedSeqBatch, prefix_index=None, *,
                             temperature: float = 1.0, top_k: bool = True, sample: bool = False,
                             generator: Optional[torch.Generator] = None, prefix_caps=None,
                             prefix_tries=None) -> GenerationOutput:
        """Prefix-constrained beam search over sem_id_dim digits: 32 beams,
        or one with `top_k=False` (retrieval.py:235). prefix_index: the sorted
        table (None: unconstrained); prefix_tries: {level: (starts, bitmaps)};
        other levels gather [Q, cap] ranges with `prefix_caps`. `sample=True` with
        a `generator` adds Gumbel noise to each digit's log-probabilities
        (retrieval.py:272-276)."""
        dev = batch.sem_ids.device
        with span("model.encode", device=dev):
            context = self.encode_context(batch)
        with span("model.beam", device=dev):
            return self._beam_search(context, batch.sem_ids.shape[0], temperature,
                                     BEAMS if top_k else 1, sample, generator, prefix_index,
                                     prefix_caps, prefix_tries)

    def _beam_search(self, context, b, temperature, k, sample, generator, prefix_index,
                     prefix_caps, prefix_tries) -> GenerationOutput:
        d = self.sem_id_dim
        kk = self.num_embeddings
        dev = context[1].device
        generated = torch.zeros((b, k, d), dtype=torch.int32, device=dev)
        log_probs = torch.full((b, k), NEG_LARGE, device=dev)
        log_probs[:, 0] = 0.0

        if prefix_index is not None:
            n_corpus = prefix_index.shape[0]
            lo = torch.zeros((b, k), dtype=torch.int32, device=dev)
            hi = torch.full((b, k), n_corpus, dtype=torch.int32, device=dev)
            step0_mask = first_digit_mask(prefix_index, kk)

        cache = self.start_decode(*context, b * k)
        parent_rows = torch.arange(b, device=dev)[:, None] * k
        for i in range(d):
            with span("model.beam.digit", digit=i):
                if tracing():  # rows alive (no off-catalog digit yet) and rows run
                    count("beam.live_rows", (log_probs > INVALID_PENALTY / 2).sum())
                    count("beam.rows", b * k)
                    count("beam.decoder_tokens", b * k)  # one new token a row
                    count("beam.cached_tokens", b * k * i)
                note("beam.prefixes", generated)  # the rows' digits before digit i
                prev = generated[:, :, i - 1].reshape(b * k, 1) if i else None
                logits_last = self.decode_step(cache, i, prev)
                step_logp = torch.log_softmax(logits_last[:, 0, :].float() / temperature, dim=-1)
                if sample and generator is not None:
                    u = torch.rand(step_logp.shape, generator=generator, device=dev)
                    step_logp = step_logp - torch.log(-torch.log(u + 1e-20) + 1e-20)

                if prefix_index is not None:
                    if i == 0:
                        valid = step0_mask[None, :].expand(b * k, kk)
                    elif prefix_tries is not None and prefix_tries.get(i) is not None:
                        starts_i, bitmaps_i = prefix_tries[i]
                        valid = trie_digit_mask(starts_i, bitmaps_i, lo.reshape(-1), hi.reshape(-1))
                        if bitmaps_i.shape[1] < kk:  # narrower stored vocab
                            valid = nn.functional.pad(valid, (0, kk - bitmaps_i.shape[1]))
                    else:
                        if prefix_caps is not None:
                            cap = int(prefix_caps[i - 1])
                        else:
                            # Heuristic only: a prefix with more than `cap` rows
                            # silently loses valid continuations.
                            cap = max(256, 4 * (n_corpus // max(kk ** i, 1)))
                            warnings.warn(
                                "generate_next_sem_id called without prefix_caps; "
                                f"using heuristic cap {cap} at digit {i} — pass "
                                "tokenizer.prefix_caps for exact constrained decoding",
                                stacklevel=3,  # the caller of generate_next_sem_id
                            )
                        cap = min(max(cap, 8), n_corpus)
                        valid = valid_digit_mask(prefix_index, lo.reshape(-1), hi.reshape(-1),
                                                 i, kk, cap)
                    step_logp = step_logp + INVALID_PENALTY * (~valid)

                scores = (step_logp + log_probs.reshape(b * k, 1)).reshape(b, k * kk)
                top_scores, top_idx = top_k_first_index(scores, k)
                parent = torch.div(top_idx, kk, rounding_mode="floor")
                digits = (top_idx % kk).to(torch.int32)

                generated = torch.gather(generated, 1, parent[..., None].expand(b, k, d)).clone()
                generated[:, :, i] = digits
                log_probs = top_scores
                if i + 1 < d:
                    cache.reorder((parent_rows + parent).reshape(-1), i + 1)

                if prefix_index is not None:
                    lo = torch.gather(lo, 1, parent)
                    hi = torch.gather(hi, 1, parent)
                    new_lo, new_hi = narrow_range(prefix_index, lo.reshape(-1), hi.reshape(-1),
                                                  i, digits.reshape(-1))
                    lo, hi = new_lo.reshape(b, k), new_hi.reshape(b, k)

        return GenerationOutput(sem_ids=generated, log_probas=log_probs)


class EncoderDecoderRetrievalModel(RetrievalModel):
    """Stage-2 retrieval model."""

    def __init__(self, embedding_dim: int, attn_dim: int, num_heads: int, n_layers: int,
                 num_embeddings: int, sem_id_dim: int, max_pos: int = 2048,
                 n_sem_layers: int = 3, use_interleaved_ids: bool = False,
                 dropout: float = 0.0, dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.attn_dim = attn_dim
        self.num_heads = num_heads
        self.n_layers = n_layers
        self.dtype = dtype
        self.num_embeddings = num_embeddings
        self.sem_id_dim = sem_id_dim
        self.bos_emb = nn.Parameter(torch.rand(embedding_dim))
        self.norm = RMSNorm(embedding_dim)
        self.norm_cxt = RMSNorm(embedding_dim)
        self.sem_id_embedder = SemIdEmbedder(
            num_embeddings, sem_id_dim, embedding_dim, n_sem_layers=n_sem_layers,
            use_interleaved_ids=use_interleaved_ids,
        )
        self.user_id_embedder = UserIdEmbedder(2000, embedding_dim)
        self.wpe = nn.Embedding(max_pos, embedding_dim)
        self.tte = nn.Embedding(sem_id_dim, embedding_dim)
        self.transformer = TransformerEncoderDecoder(
            attn_dim, num_heads, encoder_layers=n_layers // 2, decoder_layers=n_layers // 2,
            dropout=dropout, dtype=dtype, remat=remat)
        self.in_proj = nn.Linear(embedding_dim, attn_dim, bias=False)
        self.in_proj_context = nn.Linear(embedding_dim, attn_dim, bias=False)
        self.out_proj = nn.Linear(attn_dim, num_embeddings, bias=False)

    # ---- context (history) path ----

    def _context_embedding(self, batch: TokenizedSeqBatch, generator=None):
        user_emb = self.user_id_embedder(batch.user_ids)              # [B, E]
        seq_emb = self.sem_id_embedder(batch.sem_ids, batch.token_type_ids,
                                       batch.seq_mask)                # [B, T, E]
        b, t, _ = seq_emb.shape
        wpe = self.wpe(torch.arange(t, device=seq_emb.device))[None]
        ctx = torch.cat([user_emb[:, None, :], wpe + seq_emb], dim=1)
        ctx_mask = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=ctx.device),
                              batch.seq_mask], dim=1)
        ctx = drop(self.norm(ctx), INPUT_DROPOUT, generator)
        return dense(self.in_proj_context, ctx, self.dtype), ctx_mask

    def encode_context(self, batch: TokenizedSeqBatch, generator=None):
        """Run the encoder once over the history; beams reuse it."""
        ctx, ctx_mask = self._context_embedding(batch, generator)
        enc = self.transformer.encode(ctx, padding_mask=ctx_mask, generator=generator)
        return enc, ctx_mask

    # ---- target (future digits) path ----

    def _fut_embedding(self, sem_ids_fut, token_type_ids_fut, generator=None):
        b = sem_ids_fut.shape[0]
        fut_emb = self.sem_id_embedder(sem_ids_fut, token_type_ids_fut)
        tte = self.tte(token_type_ids_fut.long())
        bos = self.bos_emb.expand(b, 1, self.embedding_dim)
        x = torch.cat([bos, fut_emb + tte], dim=1)                    # [B, Df+1, E]
        x = drop(self.norm_cxt(x), INPUT_DROPOUT, generator)
        return dense(self.in_proj, x, self.dtype)

    def decode_logits(self, enc, ctx_mask, sem_ids_fut, token_type_ids_fut,
                      last_only: bool = False, generator=None):
        """Causal decoder over BOS + target digits -> [B, Df+1, K] logits.
        enc / ctx_mask may hold B rows while sem_ids_fut holds B*g beam rows."""
        x = self._fut_embedding(sem_ids_fut, token_type_ids_fut, generator)
        dec = self.transformer.decode(x, enc, context_padding_mask=ctx_mask,
                                      generator=generator)
        if last_only:
            dec = dec[:, -1:, :]
        return self._logits(dec)

    def _logits(self, dec):
        logits = dense(self.out_proj, dec, self.dtype)
        tp = getattr(self.out_proj, "tp", None)
        return logits if tp is None else gather_from_model(logits, tp)

    def decode_step(self, cache, pos: int, sem_ids=None):
        """Eval-mode logits [R, 1, K] at decoder position `pos` from one token
        a row (BOS at 0, else digit pos - 1 `sem_ids` [R, 1]), reading
        positions < pos from `cache` and writing `pos` there."""
        if pos == 0:
            x = self.bos_emb.repeat(cache.rows, 1, 1)
        else:
            tt = torch.full_like(sem_ids, pos - 1)
            x = self.sem_id_embedder(sem_ids, tt) + self.tte(tt.long())
        x = dense(self.in_proj, self.norm_cxt(x), self.dtype)
        for i, block in enumerate(self._decoder_blocks()):
            x = block.decode_step(x, cache, i, pos)
        return self._logits(x)

    def start_decode(self, enc, ctx_mask, rows: int) -> DecoderCache:
        """A cache of `rows` rows (a multiple of enc's) over sem_id_dim
        positions, holding each block's cross keys and values of `enc`."""
        cross = [block.cross_attention.cross_kv(enc) for block in self._decoder_blocks()]
        return DecoderCache(cross, ctx_mask, rows, self.sem_id_dim)

    def _decoder_blocks(self):
        dec = self.transformer.decoder
        return [getattr(dec, f"block_{i}") for i in range(dec.n_layers)]

    # ---- training / eval forward ----

    def forward(self, batch: TokenizedSeqBatch,
                generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Per-digit cross-entropy against sem_ids_fut (out-of-range targets
        ignored), summed a sample, batch mean; train mode with `generator`."""
        enc, ctx_mask = self.encode_context(batch, generator)
        logits_all = self.decode_logits(enc, ctx_mask, batch.sem_ids_fut,
                                        batch.token_type_ids_fut, generator=generator)
        logits = logits_all[:, :-1, :].float()
        target = batch.sem_ids_fut.long()
        ignore = (target < 0) | (target >= self.num_embeddings)
        valid_target = torch.where(ignore, torch.zeros_like(target), target)
        log_probs = torch.log_softmax(logits, dim=-1)
        token_loss = -torch.gather(log_probs, -1, valid_target[..., None])[..., 0]
        token_loss = torch.where(ignore, torch.zeros_like(token_loss), token_loss)
        return ModelOutput(loss=token_loss.sum(1).mean(), logits=logits_all,
                           loss_d=token_loss.mean(0))
