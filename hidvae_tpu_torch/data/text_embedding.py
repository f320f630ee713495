"""Text embeddings (a copy of hidvae_tpu/data/text_embedding.py):
sentence_transformers if a local copy loads (offline), else the hash
fallback bit for bit; JAX's cache names."""

import hashlib
import logging
import os
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger("hidvae_tpu_torch.data.text_embedding")

T5_MODEL = "sentence-transformers/sentence-t5-xl"
BGE_ZH_MODEL = "BAAI/bge-base-zh-v1.5"  # KuaiRand's Chinese captions (data/kuairand.py)


def _token_vector(tok: str, dim: int) -> np.ndarray:
    h = int.from_bytes(hashlib.sha256(tok.encode("utf-8")).digest()[:8], "little")
    return np.random.RandomState(h % (2 ** 31)).randn(dim).astype(np.float32)


def _hash_embedding(texts: Sequence[str], dim: int) -> np.ndarray:
    """Unit-norm sum of a seeded normal vector per lower-cased token
    (text_embedding.py:27-43), each drawn once, summed position by position
    in the JAX loop's order."""
    tokens = [str(t).lower().split() for t in texts]
    vocab = {}
    for toks in tokens:
        for tok in toks:
            vocab.setdefault(tok, len(vocab))
    table = np.zeros((len(vocab), dim), np.float32)
    for tok, i in vocab.items():
        table[i] = _token_vector(tok, dim)
    lengths = np.array([len(t) for t in tokens], np.int64)
    idx = np.zeros((len(texts), int(lengths.max(initial=0))), np.int64)
    for r, toks in enumerate(tokens):
        idx[r, :len(toks)] = [vocab[t] for t in toks]
    out = np.zeros((len(texts), dim), np.float32)
    for c in range(idx.shape[1]):
        rows = np.nonzero(lengths > c)[0]
        out[rows] += table[idx[rows, c]]
    norms = np.linalg.norm(out, axis=-1, keepdims=True)
    out /= np.maximum(norms, 1e-6)
    return out


def encode_text_feature(texts: Sequence[str], model_name: str = T5_MODEL, *, dim: int = 768,
                        batch_size: int = 64, cache_dir: Optional[str] = None) -> np.ndarray:
    """Encode texts to [n, dim] float32 (text_embedding.py:46-92). Sets
    `encode_text_feature.encoder` to what made them: "cache", the model's
    name or "hash"."""
    texts = [str(t) for t in texts]
    cache_path = None
    if cache_dir:
        digest = hashlib.sha256(
            (model_name + "\x00" + "\x00".join(texts)).encode("utf-8")).hexdigest()[:24]
        cache_path = os.path.join(cache_dir, f"textemb_{digest}.npy")
        if os.path.exists(cache_path):
            encode_text_feature.encoder = "cache"
            return np.load(cache_path)
    try:
        # Offline before the import: a missing model fails at once, a
        # locally cached one still loads.
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        from sentence_transformers import SentenceTransformer

        emb = SentenceTransformer(model_name).encode(
            texts, batch_size=batch_size, show_progress_bar=True, convert_to_numpy=True,
        ).astype(np.float32)
        encode_text_feature.encoder = model_name
    except Exception as e:
        if os.environ.get("HIDVAE_REQUIRE_TEXT_MODEL") == "1":
            raise
        logger.warning(f"SentenceTransformer '{model_name}' unavailable ({e}); falling back "
                       "to deterministic hash embeddings (set HIDVAE_REQUIRE_TEXT_MODEL=1 to "
                       "fail instead).")
        emb = _hash_embedding(texts, dim)
        encode_text_feature.encoder = "hash"
    if cache_path:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(cache_path, emb)
    return emb


encode_text_feature.encoder = None
