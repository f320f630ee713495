"""Pre-norm transformer blocks and the encoder-decoder (counterpart of
hidvae_tpu/models/transformer.py), eval mode: dropout is a training op and
is left out. The cross-attention query is taken from the block input x,
not from the self-attention output (transformer.py:58)."""

from typing import Sequence

from torch import nn

from hidvae_tpu_torch.models.attention import MultiHeadAttention
from hidvae_tpu_torch.models.layers import MLP, RMSNorm


class TransformerBlock(nn.Module):
    """Self-attention (+ cross-attention) + SiLU feed-forward, pre-norm."""

    def __init__(self, d_out: int, num_heads: int, do_cross_attn: bool = False,
                 mlp_hidden_dims: Sequence[int] = (1024,), is_causal: bool = True):
        super().__init__()
        self.is_causal = is_causal
        self.attn_norm = RMSNorm(d_out)
        self.attention = MultiHeadAttention(d_out, d_out, num_heads)
        if do_cross_attn:
            self.cross_attn_norm = RMSNorm(d_out)
            self.cross_attention = MultiHeadAttention(d_out, d_out, num_heads, cross_attn=True)
        else:
            self.cross_attention = None
        self.ffn_norm = RMSNorm(d_out)
        self.ff = MLP(d_out, mlp_hidden_dims, d_out)

    def forward(self, x, x_kv=None, self_padding_mask=None, kv_padding_mask=None):
        attn_out = x + self.attention(self.attn_norm(x), kv_padding_mask=self_padding_mask,
                                      is_causal=self.is_causal)
        if self.cross_attention is not None:
            attn_out = attn_out + self.cross_attention(
                self.cross_attn_norm(x), x_kv, kv_padding_mask=kv_padding_mask,
                is_causal=False,
            )
        return attn_out + self.ff(self.ffn_norm(attn_out))


class TransformerStack(nn.Module):
    """N blocks, named block_0.. as in the flax module."""

    def __init__(self, d_out: int, num_heads: int, n_layers: int,
                 do_cross_attn: bool = False, is_causal: bool = True):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d_out, num_heads, do_cross_attn=do_cross_attn, is_causal=is_causal))

    def forward(self, x, context=None, *, self_padding_mask=None, kv_padding_mask=None):
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, context, self_padding_mask, kv_padding_mask)
        return x


class TransformerEncoderDecoder(nn.Module):
    """Non-causal encoder over the history + causal decoder with
    cross-attention to it."""

    def __init__(self, d_out: int, num_heads: int, encoder_layers: int, decoder_layers: int):
        super().__init__()
        self.encoder = TransformerStack(d_out, num_heads, encoder_layers,
                                        do_cross_attn=False, is_causal=False)
        self.decoder = TransformerStack(d_out, num_heads, decoder_layers,
                                        do_cross_attn=True, is_causal=True)

    def encode(self, context, *, padding_mask=None):
        return self.encoder(context, self_padding_mask=padding_mask)

    def decode(self, x, context_encoded, *, context_padding_mask=None):
        return self.decoder(x, context_encoded, self_padding_mask=None,
                            kv_padding_mask=context_padding_mask)
