"""Multi-head attention with dense padded masking (counterpart of
hidvae_tpu/models/attention.py, dense path).

Fused QKV projection for self-attention, split Q / KV for cross-attention,
softmax in fp32, written out as plain tensor ops. The flash path of the JAX
package (`_flash_self_attention`, a Pallas TPU kernel that its auto switch
takes only at >= 2048 tokens or with use_flash=True) is not ported yet: at
every shape the configs serve, the dense path runs.
"""

from typing import Optional

import torch
from torch import nn

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
    """Cross-attention where g query rows share each key/value row: q is
    [B*g, H, Nq, Dh], k and v stay [B, H, M, Dh] (g beams per user attend to
    one encoder output) with no repeat of k or v."""
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
    """MHA with fused projections; cross-attention with fewer key rows than
    query rows takes the grouped (beam) path."""

    def __init__(self, d_in: int, d_out: int, num_heads: int, cross_attn: bool = False,
                 qkv_bias: bool = False):
        super().__init__()
        if d_out % num_heads:
            raise ValueError(f"d_out {d_out} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.cross_attn = cross_attn
        if cross_attn:
            self.q = nn.Linear(d_in, d_out, bias=qkv_bias)
            self.kv = nn.Linear(d_in, 2 * d_out, bias=qkv_bias)
        else:
            self.qkv = nn.Linear(d_in, 3 * d_out, bias=qkv_bias)
        self.proj = nn.Linear(d_out, d_out, bias=False)

    def _heads(self, t):
        b, n, c = t.shape
        return t.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, x, x_kv=None, *, kv_padding_mask: Optional[torch.Tensor] = None,
                is_causal: bool = True):
        if self.cross_attn:
            if x_kv is None:
                raise ValueError("cross attention requires x_kv")
            q = self.q(x)
            k, v = self.kv(x_kv).chunk(2, dim=-1)
        else:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        q, k, v = self._heads(q), self._heads(k), self._heads(v)
        if self.cross_attn and q.shape[0] != k.shape[0]:
            out = grouped_cross_attention(q, k, v, kv_padding_mask=kv_padding_mask)
        else:
            mask = make_attention_mask(q.shape[2], k.shape[2], causal=is_causal,
                                       kv_padding_mask=kv_padding_mask, device=q.device)
            out = dot_product_attention(q, k, v, mask=mask)
        b, h, n, d = out.shape
        return self.proj(out.transpose(1, 2).reshape(b, n, h * d))
