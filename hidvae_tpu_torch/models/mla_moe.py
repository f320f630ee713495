"""Decoder-only retriever with DeepSeek-V3's block (deepseek_v3 keys):
latent attention (MLA), dense SwiGLU then sigmoid-routed and shared
experts; one causal stack over [user, history digits, BOS, digits],
padding taking no position. The prefill keeps each layer's latent prefix,
read uncopied by a user's beam rows; decode absorbs the query into the
latent. Parameters in `dtype` (the routing bias fp32); norms, rotary
embedding, router and softmax in fp32."""

import torch
from torch import nn
from torch.nn import functional as F

from hidvae_tpu_torch.models.embedder import SemIdEmbedder, UserIdEmbedder
from hidvae_tpu_torch.models.layers import RMSNorm
from hidvae_tpu_torch.models.retrieval import RetrievalModel
from hidvae_tpu_torch.ops.moe_experts import grouped_swiglu, grouped_swiglu_plain
from hidvae_tpu_torch.utils.debug import count, note, span, tracing

# deepseek_v3 values this block implements; others are refused
FIXED = {"q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
         "n_group": 1, "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
         "attention_bias": False}


def linear(n_in, n_out, dtype):
    return nn.Linear(n_in, n_out, bias=False, dtype=dtype)


def rope(x, pos, theta):
    """x [..., T, (heads,) d] rotated at positions [..., T] in fp32; pairs
    (x[2j], x[2j + 1]) laid out de-interleaved, as deepseek_v3."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = pos.float()[(...,) + (None,) * (x.dim() - pos.dim())] * inv
    xf = x.float()
    a, b = xf[..., 0::2], xf[..., 1::2]
    cos, sin = ang.cos(), ang.sin()
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x))."""

    def __init__(self, dim, width, dtype):
        super().__init__()
        self.gate_proj, self.up_proj = linear(dim, width, dtype), linear(dim, width, dtype)
        self.down_proj = linear(width, dim, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LatentAttention(nn.Module):
    def __init__(self, c, dtype):
        super().__init__()
        self.h, self.dn, self.dr = (c["num_attention_heads"], c["qk_nope_head_dim"],
                                    c["qk_rope_head_dim"])
        self.dv, self.r, self.theta = c["v_head_dim"], c["kv_lora_rank"], c["rope_theta"]
        self.scale = (self.dn + self.dr) ** -0.5
        dim, h = c["hidden_size"], self.h
        self.q_proj = linear(dim, h * (self.dn + self.dr), dtype)
        self.kv_a_proj_with_mqa = linear(dim, self.r + self.dr, dtype)
        self.kv_a_layernorm = RMSNorm(self.r, c["rms_norm_eps"], dtype)
        self.kv_b_proj = linear(self.r, h * (self.dn + self.dv), dtype)
        self.o_proj = linear(h * self.dv, dim, dtype)

    def _q_latent(self, x, pos):
        """(q_nope, rotated q_pe, the latent: normed c_kv | rotated k_pe)."""
        q = self.q_proj(x).unflatten(-1, (self.h, self.dn + self.dr))
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.r, self.dr], -1)
        lat = torch.cat([self.kv_a_layernorm(c), rope(k_pe, pos, self.theta)], -1)
        return q[..., :self.dn], rope(q[..., self.dn:], pos, self.theta), lat

    def prefill(self, x, pos, mask):
        """Causal attention over x [B, P, C] (keys where `mask`), keys and
        values decompressed. (output, latent)."""
        q_nope, q_pe, lat = self._q_latent(x, pos)
        kv = self.kv_b_proj(lat[..., :self.r]).unflatten(-1, (self.h, self.dn + self.dv))
        k_pe = lat[..., None, self.r:].expand(*q_pe.shape)
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
        k = torch.cat([kv[..., :self.dn], k_pe], -1).transpose(1, 2)
        n = x.shape[1]
        keep = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device)) & mask[:, None,
                                                                                        None]
        s = torch.where(keep, (q @ k.transpose(-1, -2)).float() * self.scale, -torch.inf)
        o = torch.softmax(s, -1).to(x.dtype) @ kv[..., self.dn:].transpose(1, 2)
        return self.o_proj(o.transpose(1, 2).flatten(2)), lat

    def decode(self, x, pos, cache, layer, step):
        """One new token a row, x [R, 1, C] at positions `pos` [R], over the
        user's latent prefix and the row's own latents, query absorbed."""
        q_nope, q_pe, lat = self._q_latent(x, pos[:, None])
        own = cache.write(layer, step, lat[:, 0])                        # [R, n, r + dr]
        w = self.kv_b_proj.weight.view(self.h, self.dn + self.dv, self.r)
        q = torch.cat([torch.einsum("rhd,hdc->rhc", q_nope[:, 0], w[:, :self.dn]),
                       q_pe[:, 0]], -1)                                   # [R, h, r + dr]
        pre, mask = cache.prefix[layer], cache.mask                      # [B, P, r + dr]
        b, p = mask.shape
        qg = q.view(b, -1, self.h, q.shape[-1])
        s_pre = torch.einsum("bghc,bpc->bghp", qg, pre).float()
        s_pre = torch.where(mask[:, None, None], s_pre, -torch.inf).flatten(0, 1)
        s = torch.cat([s_pre, torch.einsum("rhc,rjc->rhj", q, own).float()], -1) * self.scale
        a = torch.softmax(s, -1).to(x.dtype)
        o = (torch.einsum("bghp,bpc->bghc", a[..., :p].reshape(*qg.shape[:3], p),
                          pre[..., :self.r]).flatten(0, 1).float()
             + torch.einsum("rhj,rjc->rhc", a[..., p:], own[..., :self.r]).float())
        o = torch.einsum("rhc,hvc->rhv", o.to(x.dtype), w[:, self.dn:])
        return self.o_proj(o.flatten(1))[:, None]


class MoE(nn.Module):
    """Top k of sigmoid scores + bias (noaux_tc), weighted by the chosen
    scores over their sum times `routed_scaling_factor`, no token dropped,
    plus the shared experts; the routed rows sorted by expert, no padding,
    no host wait, through ops/moe_experts.py (kernels on CUDA)."""

    def __init__(self, c, dtype):
        super().__init__()
        dim, width, e = c["hidden_size"], c["moe_intermediate_size"], c["n_routed_experts"]
        self.k, self.scaling = c["num_experts_per_tok"], c["routed_scaling_factor"]
        self.norm_topk = c["norm_topk_prob"]
        self.gate = nn.Module()
        self.gate.weight = nn.Parameter(torch.empty((e, dim), dtype=dtype))
        self.gate.register_buffer("e_score_correction_bias", torch.zeros(e))
        self.experts = nn.Module()
        self.experts.gate_up_proj = nn.Parameter(torch.empty((e, 2 * width, dim), dtype=dtype))
        self.experts.down_proj = nn.Parameter(torch.empty((e, dim, width), dtype=dtype))
        self.shared_experts = SwiGLU(dim, width * c["n_shared_experts"], dtype)

    def route(self, x):
        """(chosen experts [T, k], their weights [T, k] fp32) of x [T, C]."""
        s = torch.sigmoid(F.linear(x.float(), self.gate.weight.float()))
        idx = torch.topk(s + self.gate.e_score_correction_bias, self.k, dim=-1).indices
        w = s.gather(1, idx)
        if self.norm_topk:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * self.scaling

    def forward(self, x):
        t = x.shape[0]
        idx, w = self.route(x)
        note("moe.experts", idx)
        flat = idx.flatten()
        order = torch.argsort(flat, stable=True)
        rows = torch.bincount(flat, minlength=self.experts.down_proj.shape[0])
        if tracing():
            count("moe.tokens", t)
            count("moe.routed_rows", t * self.k)
            count("moe.max_expert_rows", rows.max())
        ends = torch.cumsum(rows, 0, dtype=torch.int32)
        experts = grouped_swiglu if x.is_cuda else grouped_swiglu_plain
        return experts(x, w, order, ends, self.experts.gate_up_proj, self.experts.down_proj,
                       self.shared_experts(x))


class Layer(nn.Module):
    def __init__(self, c, i, dtype):
        super().__init__()
        eps = c["rms_norm_eps"]
        self.input_layernorm = RMSNorm(c["hidden_size"], eps, dtype)
        self.self_attn = LatentAttention(c, dtype)
        self.post_attention_layernorm = RMSNorm(c["hidden_size"], eps, dtype)
        self.is_moe = i >= c["first_k_dense_replace"]
        self.mlp = MoE(c, dtype) if self.is_moe else SwiGLU(
            c["hidden_size"], c["intermediate_size"], dtype)

    def ffn(self, x):
        with span("model.moe" if self.is_moe else "model.ffn"):
            return self.mlp(self.post_attention_layernorm(x))


class LatentCache:
    """Each layer's history prefix [B, P, r + dr] and mask [B, P], shared by
    a user's beam rows, and each row's own latents [layers, rows, pos, r + dr]."""

    def __init__(self, prefix, mask, rows: int, positions: int):
        self.prefix, self.mask, self.rows = prefix, mask, rows
        self.base = mask.sum(1).repeat_interleave(rows // mask.shape[0])  # BOS's position
        self.own = prefix[0].new_empty((len(prefix), rows, positions, prefix[0].shape[-1]))

    def write(self, layer: int, pos: int, lat):
        """Store lat [rows, r + dr] at `pos`; return the row's latents 0..pos."""
        self.own[layer, :, pos] = lat
        return self.own[layer, :, :pos + 1]

    def reorder(self, rows, n: int):
        """Row r takes row rows[r]'s (its parent beam's) positions < n."""
        self.own[:, :, :n] = self.own[:, rows, :n]


class MlaMoeRetrievalModel(RetrievalModel):
    """The retriever over `num_embeddings` codes a digit and `sem_id_dim`
    digits (`n_sem_layers` semantic), its block from `config`."""

    def __init__(self, config: dict, num_embeddings: int, sem_id_dim: int,
                 n_sem_layers: int = 3, user_buckets: int = 2000, dtype=torch.bfloat16):
        super().__init__()
        wrong = {k: config.get(k) for k, v in FIXED.items() if config.get(k, v) != v}
        if wrong:
            raise ValueError(f"this block implements {FIXED}, not {wrong}")
        dim = config["hidden_size"]
        self.num_embeddings, self.sem_id_dim, self.dtype = num_embeddings, sem_id_dim, dtype
        self.sem_id_embedder = SemIdEmbedder(num_embeddings, sem_id_dim, dim,
                                             n_sem_layers=n_sem_layers).to(dtype)
        self.user_id_embedder = UserIdEmbedder(user_buckets, dim).to(dtype)
        self.bos_emb = nn.Parameter(torch.zeros(dim, dtype=dtype))
        self.layers = nn.ModuleList(Layer(config, i, dtype)
                                    for i in range(config["num_hidden_layers"]))
        self.norm = RMSNorm(dim, config["rms_norm_eps"], dtype)
        self.out_proj = linear(dim, num_embeddings, dtype)

    def encode_context(self, batch):
        """Prefill of [user, history]: (latent prefixes, mask [B, 1 + T])."""
        mask = torch.cat([torch.ones_like(batch.seq_mask[:, :1]), batch.seq_mask], 1)
        x = torch.cat([self.user_id_embedder(batch.user_ids)[:, None],
                       self.sem_id_embedder(batch.sem_ids, batch.token_type_ids,
                                            batch.seq_mask)], 1)
        pos = torch.cumsum(mask, 1) - 1
        valid = mask.flatten().nonzero()[:, 0]
        prefix = []
        for layer in self.layers:
            with span("model.mla"):
                attn, lat = layer.self_attn.prefill(layer.input_layernorm(x), pos, mask)
            x = (x + attn).flatten(0, 1)
            h = x[valid]
            x = x.index_copy(0, valid, h + layer.ffn(h)).view(attn.shape)
            prefix.append(lat)
        return prefix, mask

    def start_decode(self, prefix, mask, rows: int) -> LatentCache:
        return LatentCache(prefix, mask, rows, self.sem_id_dim)

    def decode_step(self, cache, pos: int, sem_ids=None):
        """Logits [R, 1, K] of one token a row: BOS at `pos` 0, else digit
        pos - 1 `sem_ids` [R, 1]."""
        if pos == 0:
            x = self.bos_emb.expand(cache.rows, 1, -1)
        else:
            x = self.sem_id_embedder(sem_ids, torch.full_like(sem_ids, pos - 1))
        at = cache.base + pos
        for i, layer in enumerate(self.layers):
            with span("model.mla"):
                x = x + layer.self_attn.decode(layer.input_layernorm(x), at, cache, i, pos)
            x = x + layer.ffn(x[:, 0])[:, None]
        return self.out_proj(self.norm(x))
