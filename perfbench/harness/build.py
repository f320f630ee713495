"""The port's objects, built through the port's own constructors as its
trainer and engine build them, holding the benchmark's seeded weights.
Only this module, the traffic kinds and the metric readers import the
port."""

import torch

from hidvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from hidvae_tpu_torch.train.transformer import _build_tokenizer


def tokenizer(cfg, vae_weights, device):
    """The frozen stage-1 tokenizer of `train/transformer.py`, its model
    holding `vae_weights`."""
    tok = _build_tokenizer(
        use_h_tokenizer=cfg["tokenizer"] == "hidvae", pretrained_rqvae_path=None,
        vae_input_dim=cfg["input_dim"], vae_embed_dim=cfg["embed_dim"],
        vae_hidden_dims=tuple(cfg["hidden_dims"]), vae_codebook_size=cfg["codebook_size"],
        vae_n_layers=cfg["n_layers"], vae_n_cat_feats=0,
        vae_codebook_normalize=cfg["codebook_normalize"], vae_sim_vq=False,
        tag_class_counts=cfg.get("tag_class_counts"), tag_embed_dim=cfg["tag_embed_dim"],
        use_dedup_dim=False, use_concatenated_ids=cfg.get("use_concatenated_ids", False),
        use_interleaved_ids=False, commitment_weight=0.25, device=device)
    tok.rq_vae.load_state_dict(vae_weights, strict=True)
    return tok


def decoder(cfg, weights, sem_id_dim: int, dtype, device):
    """The stage-2 model as `train/transformer.py` `build_model` makes it
    (max_pos = window * digits), built on the device and loaded with
    `weights` instead of its host-side initializer."""
    with torch.device(device):
        model = EncoderDecoderRetrievalModel(
            cfg["decoder_embed_dim"], cfg["attn_embed_dim"], cfg["attn_heads"],
            cfg["attn_layers"], cfg["codebook_size"], sem_id_dim,
            max_pos=cfg["max_seq_len"] * sem_id_dim, n_sem_layers=cfg["n_layers"],
            use_interleaved_ids=False, dropout=cfg["dropout"], dtype=dtype)
    model.load_state_dict(weights, strict=True)
    return model
