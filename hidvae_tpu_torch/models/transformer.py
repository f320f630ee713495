"""Pre-norm transformer blocks and the encoder-decoder (counterpart of
hidvae_tpu/models/transformer.py; cross-attention's query the block
input, :58; dropout as JAX, :51-71). `remat` checkpoints each block,
`GeneratorReplay` giving the recompute the forward's masks. `DecoderCache`
and `decode_step` decode a token at a time (eval)."""

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hidvae_tpu_torch.models.attention import MultiHeadAttention
from hidvae_tpu_torch.models.layers import MLP, RMSNorm
from hidvae_tpu_torch.ops.dropout import RowShard, dropout as drop


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

    def decode_step(self, x, cache, layer: int, pos: int):
        """`forward` in eval mode for one new token a row at position `pos`."""
        attn_out = x + self.attention.cached_self(self.attn_norm(x), cache, layer, pos)
        attn_out = attn_out + self.cross_attention.cross(self.cross_attn_norm(x),
                                                         *cache.cross[layer], cache.ctx_mask)
        return attn_out + self.ff(self.ffn_norm(attn_out))


class DecoderCache:
    """Keys and values: cross [B, H, M, Dh] a layer, self of the positions
    so far [layers, 2, rows, H, positions, Dh]."""

    def __init__(self, cross, ctx_mask, rows: int, positions: int):
        self.cross, self.ctx_mask = cross, ctx_mask
        self.rows, self.positions = rows, positions
        self.self_kv = None

    def write(self, layer: int, pos: int, kv):
        """Store kv [2, rows, H, Dh] at `pos`; return keys and values 0..pos."""
        if self.self_kv is None:
            _, r, h, dh = kv.shape
            self.self_kv = kv.new_empty((len(self.cross), 2, r, h, self.positions, dh))
        self.self_kv[layer, :, :, :, pos] = kv
        return self.self_kv[layer, 0, :, :, :pos + 1], self.self_kv[layer, 1, :, :, :pos + 1]

    def reorder(self, rows, n: int):
        """Row r takes row rows[r]'s (its parent beam's) positions < n."""
        if self.self_kv is not None:
            self.self_kv[:, :, :, :, :n] = self.self_kv[:, :, rows, :, :n]


class GeneratorReplay:
    """A rematerialized block's dropout generator: the live one forward, a
    copy at the forward's starting state on recompute (None stays None; a
    RowShard keeps its rows)."""

    def __init__(self, generator):
        self.generator = generator
        live = generator.generator if isinstance(generator, RowShard) else generator
        self.state = None if live is None else live.get_state()
        self.runs = 0

    def __call__(self):
        self.runs += 1
        if self.generator is None or self.runs == 1:
            return self.generator
        sharded = isinstance(self.generator, RowShard)
        live = self.generator.generator if sharded else self.generator
        replay = torch.Generator(device=live.device)
        replay.set_state(self.state)
        return self.generator._replace(generator=replay) if sharded else replay


def remat_block(block, x, context, self_padding_mask, kv_padding_mask, generator):
    """`block(...)` under torch.utils.checkpoint with its generator replayed
    in the recompute. No default generator is read, so none is saved."""
    replay = GeneratorReplay(generator)
    return checkpoint(lambda *args: block(*args, replay()), x, context, self_padding_mask,
                      kv_padding_mask, use_reentrant=False, preserve_rng_state=False)


class TransformerStack(nn.Module):
    """N blocks, named block_0.. as in the flax module; with `remat`, each
    block is rematerialized while gradients are being recorded."""

    def __init__(self, d_out: int, num_heads: int, n_layers: int,
                 do_cross_attn: bool = False, is_causal: bool = True, dropout: float = 0.0,
                 dtype=torch.float32, use_flash: Optional[bool] = None, remat: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.remat = remat
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d_out, num_heads, do_cross_attn=do_cross_attn, is_causal=is_causal,
                dropout=dropout, dtype=dtype, use_flash=use_flash))

    def forward(self, x, context=None, *, self_padding_mask=None, kv_padding_mask=None,
                generator: Optional[torch.Generator] = None):
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.n_layers):
            block = getattr(self, f"block_{i}")
            if remat:
                x = remat_block(block, x, context, self_padding_mask, kv_padding_mask, generator)
            else:
                x = block(x, context, self_padding_mask, kv_padding_mask, generator)
        return x


class TransformerEncoderDecoder(nn.Module):
    """Non-causal encoder over the history + causal decoder with
    cross-attention to it."""

    def __init__(self, d_out: int, num_heads: int, encoder_layers: int, decoder_layers: int,
                 dropout: float = 0.0, dtype=torch.float32,
                 encoder_flash: Optional[bool] = None, remat: bool = False):
        super().__init__()
        self.encoder = TransformerStack(d_out, num_heads, encoder_layers,
                                        do_cross_attn=False, is_causal=False,
                                        dropout=dropout, dtype=dtype, use_flash=encoder_flash,
                                        remat=remat)
        self.decoder = TransformerStack(d_out, num_heads, decoder_layers,
                                        do_cross_attn=True, is_causal=True,
                                        dropout=dropout, dtype=dtype, remat=remat)

    def encode(self, context, *, padding_mask=None, generator=None):
        return self.encoder(context, self_padding_mask=padding_mask, generator=generator)

    def decode(self, x, context_encoded, *, context_padding_mask=None, generator=None):
        return self.decoder(x, context_encoded, self_padding_mask=None,
                            kv_padding_mask=context_padding_mask, generator=generator)
