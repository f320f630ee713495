"""Names, shapes and initial distributions of every weight of the two
stages at a configuration's widths. The benchmark makes the weights from
this list (harness/weights.py) and hands the same tensors to the port, by
name, and to the reference."""


def _linear(out, name, fan_in, fan_out, bias=False):
    out.append((f"{name}.weight", (fan_out, fan_in), "linear"))
    if bias:
        out.append((f"{name}.bias", (fan_out,), "zeros"))


def _layer_norm(out, name, dim):
    out.append((f"{name}.weight", (dim,), "ones"))
    out.append((f"{name}.bias", (dim,), "zeros"))


def tag_predictor_dims(cfg, level):
    """(input, hidden, mid) widths of the tag head of `level`."""
    d = cfg["embed_dim"] * (level + 1)
    hidden = cfg["hidden_dims"][0] // 2 * (level + 1)
    return d, hidden, int(hidden * 0.9)


def vae_spec(cfg):
    """The stage-1 model: encoder and decoder MLPs, codebooks and, for the
    HiD-VAE, each tagged level's predictor and projector."""
    out = []
    dims = [cfg["input_dim"], *cfg["hidden_dims"], cfg["embed_dim"]]
    for i in range(cfg["n_layers"]):
        out.append((f"quantize_{i}.embedding", (cfg["codebook_size"], cfg["embed_dim"]),
                    "codebook"))
    for i in range(len(dims) - 1):
        _linear(out, f"encoder.dense_{i}", dims[i], dims[i + 1])
    rdims = dims[::-1]
    for i in range(len(rdims) - 1):
        _linear(out, f"decoder.dense_{i}", rdims[i], rdims[i + 1])
    for level, n_cls in enumerate(cfg.get("tag_class_counts") or []):
        d, hidden, mid = tag_predictor_dims(cfg, level)
        p = f"tag_predictor_{level}"
        _linear(out, f"{p}.attn_0", d, d // 4, True)
        _linear(out, f"{p}.attn_1", d // 4, d // 2, True)
        _linear(out, f"{p}.attn_2", d // 2, d, True)
        _linear(out, f"{p}.feat", d, hidden, True)
        for blk in range(2):
            _linear(out, f"{p}.res{blk}_0", hidden, mid, True)
            _linear(out, f"{p}.res{blk}_1", mid, hidden, True)
        _linear(out, f"{p}.cls_0", hidden, mid, True)
        _linear(out, f"{p}.cls_1", mid, mid // 2, True)
        _linear(out, f"{p}.cls_out", mid // 2, n_cls, True)
        _layer_norm(out, f"{p}.feat_ln", hidden)
        for blk in range(2):
            _layer_norm(out, f"{p}.res{blk}_ln0", mid)
            _layer_norm(out, f"{p}.res{blk}_ln1", hidden)
        _layer_norm(out, f"{p}.cls_ln", mid)
        q = f"tag_projector_{level}"
        width = cfg["hidden_dims"][0]
        _linear(out, f"{q}.dense_0", cfg["tag_embed_dim"], width, True)
        out += [(f"{q}.bn.weight", (width,), "ones"), (f"{q}.bn.bias", (width,), "zeros"),
                (f"{q}.bn.running_mean", (width,), "zeros"),
                (f"{q}.bn.running_var", (width,), "ones"),
                (f"{q}.bn.num_batches_tracked", (), "count")]
        _linear(out, f"{q}.dense_1", width, cfg["embed_dim"] * (level + 1), True)
        if cfg["codebook_normalize"]:
            _layer_norm(out, f"{q}.ln", cfg["embed_dim"] * (level + 1))
    return out


def sem_id_dim(cfg):
    """Digits of an item's ID tuple: the semantic levels, then one tag per
    tagged level where the tuple concatenates them."""
    return cfg["n_layers"] + len(cfg.get("tag_class_counts") or [])


def embedding_rows(cfg):
    """Rows of the ID embedding table: K per semantic level, 1,000 per tag
    level, and the padding row."""
    return cfg["codebook_size"] * cfg["n_layers"] + 1000 * len(
        cfg.get("tag_class_counts") or []) + 1


def decoder_spec(cfg):
    """The stage-2 encoder-decoder."""
    e, a, k, d = cfg["decoder_embed_dim"], cfg["attn_embed_dim"], cfg["codebook_size"], \
        sem_id_dim(cfg)
    f = cfg["ffn_dim"]
    out = [("bos_emb", (e,), "embed"), ("norm.weight", (e,), "ones"),
           ("norm_cxt.weight", (e,), "ones"),
           ("sem_id_embedder.emb.weight", (embedding_rows(cfg), e), "embed"),
           ("user_id_embedder.emb.weight", (cfg["user_buckets"], e), "embed"),
           ("wpe.weight", (cfg["max_seq_len"] * d, e), "embed"),
           ("tte.weight", (d, e), "embed")]
    for stack, cross in (("encoder", False), ("decoder", True)):
        for i in range(cfg["attn_layers"] // 2):
            p = f"transformer.{stack}.block_{i}"
            out.append((f"{p}.attn_norm.weight", (a,), "ones"))
            _linear(out, f"{p}.attention.qkv", a, 3 * a)
            _linear(out, f"{p}.attention.proj", a, a)
            if cross:
                out.append((f"{p}.cross_attn_norm.weight", (a,), "ones"))
                _linear(out, f"{p}.cross_attention.q", a, a)
                _linear(out, f"{p}.cross_attention.kv", a, 2 * a)
                _linear(out, f"{p}.cross_attention.proj", a, a)
            out.append((f"{p}.ffn_norm.weight", (a,), "ones"))
            _linear(out, f"{p}.ff.dense_0", a, f)
            _linear(out, f"{p}.ff.dense_1", f, a)
    _linear(out, "in_proj", e, a)
    _linear(out, "in_proj_context", e, a)
    _linear(out, "out_proj", a, k)
    return out
