"""Pre-norm transformer blocks and the encoder-decoder (counterpart of
hidvae_tpu/models/transformer.py). The cross-attention query is taken from
the block input x, not from the self-attention output (transformer.py:58).

Train mode is a dropout generator passed to forward: dropout then applies
where the JAX block applies it (transformer.py:51-71): on the normed input
of self-attention and of cross-attention, after each hidden SiLU of the
feed-forward MLP, and on the feed-forward output. Without a generator the
blocks run deterministically (eval). `use_flash` reaches the encoder's
self-attention only (`encoder_flash`, transformer.py:124-131)."""

from typing import Optional, Sequence

import torch
from torch import nn

from hidvae_tpu_torch.models.attention import MultiHeadAttention
from hidvae_tpu_torch.models.layers import MLP, RMSNorm
from hidvae_tpu_torch.ops.dropout import dropout as drop


class TransformerBlock(nn.Module):
    """Self-attention (+ cross-attention) + SiLU feed-forward, pre-norm."""

    def __init__(self, d_out: int, num_heads: int, do_cross_attn: bool = False,
                 mlp_hidden_dims: Sequence[int] = (1024,), is_causal: bool = True,
                 dropout: float = 0.0, dtype=torch.float32,
                 use_flash: Optional[bool] = None):
        super().__init__()
        self.is_causal = is_causal
        self.dropout = dropout
        self.attn_norm = RMSNorm(d_out)
        self.attention = MultiHeadAttention(d_out, d_out, num_heads, dtype=dtype,
                                            use_flash=use_flash)
        if do_cross_attn:
            self.cross_attn_norm = RMSNorm(d_out)
            self.cross_attention = MultiHeadAttention(d_out, d_out, num_heads, cross_attn=True,
                                                      dtype=dtype)
        else:
            self.cross_attention = None
        self.ffn_norm = RMSNorm(d_out)
        self.ff = MLP(d_out, mlp_hidden_dims, d_out, dropout=dropout, dtype=dtype)

    def forward(self, x, x_kv=None, self_padding_mask=None, kv_padding_mask=None,
                generator: Optional[torch.Generator] = None):
        p = self.dropout
        attn_out = x + self.attention(drop(self.attn_norm(x), p, generator),
                                      kv_padding_mask=self_padding_mask,
                                      is_causal=self.is_causal)
        if self.cross_attention is not None:
            attn_out = attn_out + self.cross_attention(
                drop(self.cross_attn_norm(x), p, generator), x_kv,
                kv_padding_mask=kv_padding_mask, is_causal=False,
            )
        ff = self.ff(self.ffn_norm(attn_out), generator)
        return attn_out + drop(ff, p, generator)


class TransformerStack(nn.Module):
    """N blocks, named block_0.. as in the flax module."""

    def __init__(self, d_out: int, num_heads: int, n_layers: int,
                 do_cross_attn: bool = False, is_causal: bool = True, dropout: float = 0.0,
                 dtype=torch.float32, use_flash: Optional[bool] = None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d_out, num_heads, do_cross_attn=do_cross_attn, is_causal=is_causal,
                dropout=dropout, dtype=dtype, use_flash=use_flash))

    def forward(self, x, context=None, *, self_padding_mask=None, kv_padding_mask=None,
                generator: Optional[torch.Generator] = None):
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, context, self_padding_mask, kv_padding_mask,
                                            generator)
        return x


class TransformerEncoderDecoder(nn.Module):
    """Non-causal encoder over the history + causal decoder with
    cross-attention to it."""

    def __init__(self, d_out: int, num_heads: int, encoder_layers: int, decoder_layers: int,
                 dropout: float = 0.0, dtype=torch.float32,
                 encoder_flash: Optional[bool] = None):
        super().__init__()
        self.encoder = TransformerStack(d_out, num_heads, encoder_layers,
                                        do_cross_attn=False, is_causal=False,
                                        dropout=dropout, dtype=dtype, use_flash=encoder_flash)
        self.decoder = TransformerStack(d_out, num_heads, decoder_layers,
                                        do_cross_attn=True, is_causal=True,
                                        dropout=dropout, dtype=dtype)

    def encode(self, context, *, padding_mask=None, generator=None):
        return self.encoder(context, self_padding_mask=padding_mask, generator=generator)

    def decode(self, x, context_encoded, *, context_padding_mask=None, generator=None):
        return self.decoder(x, context_encoded, self_padding_mask=None,
                            kv_padding_mask=context_padding_mask, generator=generator)
