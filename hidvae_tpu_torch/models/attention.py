"""Multi-head attention (counterpart of hidvae_tpu/models/attention.py):
dense masking, or by the JAX rule (attention.py:152-162) `flash_attention`
for self-attention over 2048+ tokens with head width a multiple of 64
(kernels at 64 and 128 on the card, the plain version on the CPU)."""

from typing import Optional

import torch
from torch import nn

from hidvae_tpu_torch.models.layers import dense
from hidvae_tpu_torch.ops.flash_attention import SegmentIds, check_head_dim, flash_attention

FLASH_BLOCK = 128      # the JAX route pads the sequence to this multiple
FLASH_MIN_TOKENS = 2048  # the auto switch

NEG_FILL = torch.finfo(torch.float32).min


def dot_product_attention(q, k, v, *, mask=None):
    """q: [B, H, Nq, Dh]; k, v: [B, H, Nk, Dh]; mask broadcastable to
    [B, H, Nq, Nk] (True = attend)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_FILL))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def grouped_cross_attention(q, k, v, *, kv_padding_mask=None):
    """Cross-attention of q [B*g, H, Nq, Dh] over k, v [B, H, M, Dh], g
    query rows (a user's beams) a key row, k and v not repeated."""
    b = k.shape[0]
    g = q.shape[0] // b
    if q.shape[0] != b * g:
        raise ValueError(f"query batch {q.shape[0]} not a multiple of kv batch {b}")
    scale = q.shape[-1] ** -0.5
    qg = q.reshape(b, g, *q.shape[1:])
    logits = torch.einsum("bghqd,bhkd->bghqk", qg.float(), k.float()) * scale
    if kv_padding_mask is not None:
        logits = torch.where(kv_padding_mask[:, None, None, None, :], logits,
                             torch.full_like(logits, NEG_FILL))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bghqk,bhkd->bghqd", weights, v)
    return out.reshape(b * g, *out.shape[2:])


def flash_self_attention(q, k, v, kv_padding_mask, is_causal: bool, dtype):
    """`_flash_self_attention` (attention.py:75-101): padded to a multiple of
    128, padding segment 0 and valid tokens 1 for queries and keys, in the
    compute dtype, sliced back to n rows."""
    b, _, n, d = q.shape
    pad = (-n) % FLASH_BLOCK
    if pad:
        q, k, v = (nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    if kv_padding_mask is None:
        seg = torch.ones((b, n), dtype=torch.int32, device=q.device)
    else:
        seg = kv_padding_mask.to(torch.int32)
    seg = nn.functional.pad(seg, (0, pad))
    out = flash_attention(q.to(dtype), k.to(dtype), v.to(dtype),
                          segment_ids=SegmentIds(seg, seg), causal=is_causal,
                          sm_scale=d ** -0.5)
    return out[:, :, :n, :].to(dtype)


def takes_flash_route(head_dim: int, n_tokens: int, cross_attn: bool = False,
                      use_flash: Optional[bool] = None) -> bool:
    """The JAX switch (attention.py:152-162) less its TPU clause:
    self-attention over 2+ rows, head width a multiple of 64, at
    >= FLASH_MIN_TOKENS tokens (auto) or forced."""
    capable = not cross_attn and head_dim % 64 == 0 and n_tokens > 1
    if use_flash is None:
        return capable and n_tokens >= FLASH_MIN_TOKENS
    return use_flash and capable


def make_attention_mask(q_len: int, kv_len: int, *, causal: bool = False,
                        kv_padding_mask=None, device=None):
    """[B or 1, 1, Nq, Nk] bool mask, or None."""
    mask = None
    if causal:
        mask = torch.tril(torch.ones((q_len, kv_len), dtype=torch.bool, device=device))[None, None]
    if kv_padding_mask is not None:
        pad = kv_padding_mask[:, None, None, :]
        mask = pad if mask is None else (mask & pad)
    return mask


class MultiHeadAttention(nn.Module):
    """MHA with fused projections; `use_flash` None picks the route by the
    rule, True / False forces it; cross-attention is always dense, grouped
    over beams."""

    def __init__(self, d_in: int, d_out: int, num_heads: int, cross_attn: bool = False,
                 qkv_bias: bool = False, dtype=torch.float32,
                 use_flash: Optional[bool] = None):
        super().__init__()
        if d_out % num_heads:
            raise ValueError(f"d_out {d_out} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.cross_attn = cross_attn
        self.dtype = dtype
        self.use_flash = use_flash
        if cross_attn:
            self.q = nn.Linear(d_in, d_out, bias=qkv_bias)
            self.kv = nn.Linear(d_in, 2 * d_out, bias=qkv_bias)
        else:
            self.qkv = nn.Linear(d_in, 3 * d_out, bias=qkv_bias)
        self.proj = nn.Linear(d_out, d_out, bias=False)

    def _heads(self, t):
        b, n, c = t.shape
        return t.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def _merge(self, out):
        b, h, n, d = out.shape
        return dense(self.proj, out.transpose(1, 2).reshape(b, n, h * d), self.dtype)

    def cross_kv(self, x_kv):
        """The cross-attention's keys and values of x_kv, [B, H, M, Dh] each."""
        k, v = dense(self.kv, x_kv, self.dtype).chunk(2, dim=-1)
        return self._heads(k), self._heads(v)

    def cross(self, x, k, v, kv_padding_mask=None, is_causal: bool = False):
        """Cross-attention of x's queries over `cross_kv`'s keys and values."""
        q = self._heads(dense(self.q, x, self.dtype))
        if q.shape[0] != k.shape[0]:
            out = grouped_cross_attention(q, k, v, kv_padding_mask=kv_padding_mask)
        else:
            mask = make_attention_mask(q.shape[2], k.shape[2], causal=is_causal,
                                       kv_padding_mask=kv_padding_mask, device=q.device)
            out = dot_product_attention(q, k, v, mask=mask)
        return self._merge(out)

    def cached_self(self, x, cache, layer: int, pos: int):
        """Self-attention of one token a row (x [R, 1, C]) at `pos` over
        `cache`'s positions 0..pos: no mask is needed."""
        qkv = dense(self.qkv, x, self.dtype).reshape(x.shape[0], 3, self.num_heads, -1)
        k, v = cache.write(layer, pos, qkv[:, 1:].transpose(0, 1))
        return self._merge(dot_product_attention(qkv[:, 0, :, None], k, v))

    def forward(self, x, x_kv=None, *, kv_padding_mask: Optional[torch.Tensor] = None,
                is_causal: bool = True):
        if self.cross_attn:
            if x_kv is None:
                raise ValueError("cross attention requires x_kv")
            return self.cross(x, *self.cross_kv(x_kv), kv_padding_mask, is_causal)
        q, k, v = (self._heads(t) for t in dense(self.qkv, x, self.dtype).chunk(3, dim=-1))
        if takes_flash_route(q.shape[-1], q.shape[2], False, self.use_flash):
            check_head_dim(q.shape[-1], q.device.type)
            out = flash_self_attention(q, k, v, kv_padding_mask, is_causal, self.dtype)
        else:
            mask = make_attention_mask(q.shape[2], k.shape[2], causal=is_causal,
                                       kv_padding_mask=kv_padding_mask, device=q.device)
            out = dot_product_attention(q, k, v, mask=mask)
        return self._merge(out)
