"""Does the train-mode forward see the audit's colliding pairs, at the
fixed params of a stage-1 checkpoint? (counterpart of scripts/diag_mining.py)

    python3 scripts/torch_diag_mining.py CHECKPOINT [DATASET_ROOT] [--device cpu]

CHECKPOINT: an exported HiD-VAE checkpoint; DATASET_ROOT (default
dataset/synthetic_xl) holds processed/synthetic.npz. Prints four rates."""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hidvae_tpu_torch.data.processed import ItemData, RecDataset  # noqa: E402
from hidvae_tpu_torch.ops.rq_assign import rq_assign_auto  # noqa: E402
from hidvae_tpu_torch.train.transformer import _build_tokenizer  # noqa: E402
from hidvae_tpu_torch.utils.runtime import full_fp32  # noqa: E402

# The JAX script's tokenizer (configs/h_rqvae_synthetic_xxl_m.gin's widths);
# the checkpoint's recorded structure wins where it differs.
WIDTHS = dict(vae_input_dim=768, vae_embed_dim=32, vae_hidden_dims=(512, 256, 128),
              vae_codebook_size=256, vae_n_layers=4, vae_n_cat_feats=0,
              vae_codebook_normalize=True, vae_sim_vq=False, tag_class_counts=None,
              tag_embed_dim=768)


def harvest_pairs(ids, n_pairs=128, seed=0):
    """Adjacent rows of the stable sort by ID tuple that share their tuple:
    (all pairs found, `n_pairs` of them drawn by RandomState(seed))."""
    _, inverse = np.unique(ids, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    a, b = order[:-1], order[1:]
    same = inverse[a] == inverse[b]
    pa, pb = a[same], b[same]
    sel = np.random.RandomState(seed).choice(len(pa), min(n_pairs, len(pa)), replace=False)
    return len(pa), pa[sel], pb[sel]


BATCH = 1024  # rows of the train-mode forward


def diag(checkpoint, root="dataset/synthetic_xl", n=50_000, device=None, chunk=1000,
         widths=WIDTHS):
    tok = _build_tokenizer(use_h_tokenizer=True, pretrained_rqvae_path=checkpoint,
                           use_dedup_dim=False, use_concatenated_ids=True,
                           use_interleaved_ids=False, commitment_weight=0.4, device=device,
                           **widths)
    model, dev = tok.hrq_vae, tok.device
    items = ItemData(root, RecDataset.SYNTHETIC, train_test_split="train")
    feats = items.item_features[:n]
    n = len(feats)
    with torch.inference_mode(), full_fp32():  # eval mode: the audit's IDs
        cbs = model.stacked_codebooks()
        ids_eval = torch.cat([
            rq_assign_auto(model.encode(torch.as_tensor(feats[s:s + chunk], device=dev)), cbs)[0]
            for s in range(0, n, chunk)]).cpu().numpy()
    found, pa, pb = harvest_pairs(ids_eval)
    print(f"colliding pairs found (eval mode, {n} items): {found}")
    p = len(pa)
    pair_idx = np.stack([pa, pb], 1).reshape(-1)
    rest = np.random.RandomState(1).randint(0, n, BATCH - 2 * p)
    bx = torch.as_tensor(feats[np.concatenate([pair_idx, rest])], device=dev)
    # The train-mode forward the uniqueness loss sees, at the same params.
    g = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad(), full_fp32():
        ids_train = model.get_semantic_ids(model.encode(bx), None, None, 1.0, train=True,
                                           generator=g).sem_ids.cpu().numpy()
    tp = ids_train[:2 * p].reshape(p, 2, -1)
    ev = ids_eval[pair_idx].reshape(p, 2, -1)
    rates = {
        "pairs equal under eval-mode ids": np.all(ev[:, 0] == ev[:, 1], axis=-1).mean(),
        "pairs equal under TRAIN-mode ids": np.all(tp[:, 0] == tp[:, 1], axis=-1).mean(),
        "row-level train-vs-eval id agreement":
            np.all(ids_train[:2 * p] == ids_eval[pair_idx], axis=-1).mean(),
    }
    for k, v in rates.items():
        print(f"{k}: {v:.3f}")
    rates["in-batch p_unique (train mode)"] = len(np.unique(ids_train, axis=0)) / BATCH
    print(f"in-batch p_unique (train mode): {rates['in-batch p_unique (train mode)']:.4f}")
    return dict(ids_eval=ids_eval, pairs=(pa, pb), found=found,
                rates={k: float(v) for k, v in rates.items()})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint", nargs="?", default=(
        "out/hrqvae/synthetic_xl4m/hrqvae_SYNTHETIC_20260820_091526/latest"))
    parser.add_argument("root", nargs="?", default="dataset/synthetic_xl")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return diag(args.checkpoint, args.root, device=args.device)


if __name__ == "__main__":
    main()
