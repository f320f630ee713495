"""Small sizes of the four cells for the CPU tests: every width cut, the
structure (levels, tags, concatenated IDs, heads, blocks) kept."""

import torch

torch.set_num_threads(2)

TINY_CONFIG = {"input_dim": 32, "hidden_dims": [16, 16], "embed_dim": 8, "codebook_size": 16,
               "tag_embed_dim": 16, "decoder_embed_dim": 16, "attn_embed_dim": 32,
               "attn_heads": 2, "attn_layers": 2, "n_items": 300, "max_seq_len": 5,
               "batch_size": 8}
TINY_TRAFFIC = {"page_users": 8, "distinct_pages": 4, "history_window": 5,
                "lengths": {"dist": "geometric", "min": 1, "mean": 3, "max": 5},
                "check_pages": 2, "trace_seconds": 0.3, "pool_sequences": 40,
                "chunk_steps": 2}
# The benchmark's cells, and the training kind on the HiD-VAE configuration
# ("<cell>+amazon_hidvae": the ML-32M training cell's mix over Amazon's
# configuration), which no cell of its own runs.
CELLS = ("amazon_hidvae.serve_b256", "ml32m_rqvae.serve_b256", "ml32m_rqvae.train_b64",
         "ml32m_rqvae.train_b64+amazon_hidvae")
AMAZON = {"name": "amazon_hidvae", "tokenizer": "hidvae", "embed_dim": 8,
          "codebook_normalize": True, "tag_class_counts": [3, 5, 7],
          "use_concatenated_ids": True, "dropout": 0.3}


def cell_of(case):
    return case.split("+")[0]


def overrides(case):
    cfg = dict(TINY_CONFIG)
    if "amazon_hidvae" in case:
        cfg.update(AMAZON)
    return {"config": cfg, "traffic": dict(TINY_TRAFFIC)}
