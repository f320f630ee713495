"""Inspect a processed dataset or a short stage-1 run (counterpart of
scripts/view_processed_dataset.py, view_train_{hrqvae,rqvae}.py):

    python3 scripts/torch_view.py processed ROOT [--dataset D] [--split S]
        [--samples 3] [--plots DIR]
    python3 scripts/torch_view.py train-hrqvae|train-rqvae [--iterations N]
        [--root DIR] [--out DIR] [--device cpu]

The train subcommands write a 500-item corpus under --root when missing."""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hidvae_tpu_torch.data.processed import (  # noqa: E402
    ItemData,
    RecDataset,
    SeqData,
    processed_path,
)

BAR = "#5B7FCE"


def plot_tag_distribution(ti, out_dir):
    """tags_per_item.png, tag_level_coverage.png, tag_top_classes.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    n_items, n_levels = ti.shape

    def save(fig, name):
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, name), dpi=100)
        plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 4.5))
    counts = np.bincount((ti >= 0).sum(axis=1), minlength=n_levels + 1)
    ax.bar(range(n_levels + 1), counts, color=BAR, width=0.72)
    for x, v in enumerate(counts):
        if v:
            ax.text(x, v, f"{v / n_items:.1%}", ha="center", va="bottom", fontsize=9)
    ax.set(xlabel="non-empty tags per item", ylabel="items", title="Tag completeness")
    save(fig, "tags_per_item.png")
    coverage = [(ti[:, l] >= 0).mean() * 100 for l in range(n_levels)]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.bar(range(1, n_levels + 1), coverage, color=BAR, width=0.6)
    for x, v in enumerate(coverage):
        ax.text(x + 1, v + 1, f"{v:.1f}%", ha="center", fontsize=9)
    ax.set(xlabel="tag level", ylabel="coverage (%)", ylim=(0, 105),
           xticks=range(1, n_levels + 1), title="Tag coverage per level")
    save(fig, "tag_level_coverage.png")
    fig, axes = plt.subplots(1, n_levels, figsize=(5.5 * n_levels, 4.5))
    for l, ax in enumerate(np.atleast_1d(axes)):
        valid = ti[:, l][ti[:, l] >= 0]
        if len(valid):
            uniq, counts = np.unique(valid, return_counts=True)
            order = np.argsort(counts)[::-1][:10]
            ax.barh(range(len(order))[::-1], counts[order], color=BAR, height=0.72)
            ax.set_yticks(range(len(order))[::-1])
            ax.set_yticklabels([f"id {uniq[i]}" for i in order], fontsize=9)
            ax.set(title=f"level {l + 1}: top classes ({len(uniq)} total)", xlabel="items")
    save(fig, "tag_top_classes.png")
    print(f"tag distribution charts -> {out_dir}")


def processed(args):
    dataset = RecDataset[args.dataset]
    items, train_items, eval_items = (
        ItemData(args.root, dataset, train_test_split=s, split=args.split)
        for s in ("all", "train", "eval"))
    print(f"== ItemData ({dataset.name}) ==")
    print(f"items: {len(items)} (train {len(train_items)} / eval {len(eval_items)})")
    print(f"feature dim: {items.feature_dim}")
    norms = np.linalg.norm(items.item_features, axis=-1)
    print(f"feature norms: mean={norms.mean():.4f} min={norms.min():.4f} "
          f"max={norms.max():.4f}")
    if items.has_tags:
        ti = items.tags_indices
        print("\n== Tags ==")
        print(f"tag levels: {ti.shape[1]}, tags_emb: {items.tags_emb.shape}")
        for level in range(ti.shape[1]):
            col = ti[:, level]
            valid = col[col >= 0]
            uniq, counts = (np.unique(valid, return_counts=True)
                            if len(valid) else (np.array([]), np.array([])))
            print(f"  level {level}: {len(uniq)} classes, missing {(col < 0).mean():.1%}, "
                  f"count range [{counts.min() if len(counts) else 0}, "
                  f"{counts.max() if len(counts) else 0}]")
        per_item = (ti >= 0).sum(axis=1)
        print(f"  avg non-empty tags per item: {per_item.mean():.2f} "
              f"(complete {np.mean(per_item == ti.shape[1]):.1%})")
        if args.plots:
            plot_tag_distribution(ti, args.plots)
    for is_train, name in [(True, "train"), (False, "eval")]:
        seq = SeqData(args.root, dataset, is_train=is_train, split=args.split)
        lengths = (seq.items >= 0).sum(axis=1)
        print(f"\n== SeqData ({name}) ==")
        print(f"sequences: {len(seq)}, max_len {seq.max_seq_len}")
        print(f"history length quantiles: "
              f"{np.percentile(lengths, [25, 50, 75, 90, 100]).astype(int).tolist()}")
        for i in range(min(args.samples, len(seq))):
            hist = [int(x) for x in seq.items[i] if x >= 0]
            print(f"  user {seq.users[i]}: {hist[:8]}{'...' if len(hist) > 8 else ''} "
                  f"-> {seq.fut[i]}")


def train_run(trainer, args, **kwargs):
    """The view scripts' corpus (written if missing) and trainer at their widths."""
    from hidvae_tpu_torch.data.synthetic import build_synthetic

    path = processed_path(args.root, RecDataset.SYNTHETIC)
    if not os.path.exists(path):
        build_synthetic(n_items=500, n_users=100, feature_dim=64, tag_dim=32,
                        max_seq_len=10).save(path)
    every = max(args.iterations, 1)
    result = trainer.train(
        iterations=args.iterations, batch_size=32, learning_rate=1e-3,
        dataset_folder=args.root, dataset=RecDataset.SYNTHETIC, save_dir_root=args.out,
        eval_every=every, save_model_every=every, vae_input_dim=64, vae_n_cat_feats=0,
        vae_hidden_dims=(64, 32), vae_embed_dim=16, vae_codebook_size=64, eval_batches=2,
        log_every=1, make_plots=False, device=args.device, **kwargs)
    hist = result["history"]
    print("\n== Final metrics ==")
    print(f"loss: {hist['total_loss'][0]:.4f} -> {hist['total_loss'][-1]:.4f}")
    return result, hist, ItemData(args.root, RecDataset.SYNTHETIC, train_test_split="all")


def train_hrqvae(args):
    from hidvae_tpu_torch.data.schemas import SeqBatch
    from hidvae_tpu_torch.tokenizer.h_semids import HSemanticIdTokenizer
    from hidvae_tpu_torch.train import hidvae
    from hidvae_tpu_torch.train.tags import apply_tag_remap, compute_rare_tag_remap

    result, hist, items = train_run(hidvae, args, tag_embed_dim=32, rare_tag_threshold=3,
                                    use_focal_loss=True, id_repetition_threshold=1.0)
    print(f"tag accuracy: {hist['tag_pred_accuracy'][-1]:.4f}")
    print(f"remapped tag_class_counts: {result['tag_class_counts']}")
    print(f"rare tags collapsed per level: "
          f"{ {k: len(v) for k, v in result['rare_tags'].items()} }")
    tok = HSemanticIdTokenizer(result["model"], n_layers=3, codebook_size=64,
                               tag_class_counts=result["tag_class_counts"],
                               use_concatenated_ids=True, device=args.device)
    corpus = tok.precompute_corpus_ids(items.item_features)
    print(f"\ncorpus IDs (concat layout, [s1 s2 s3 t1 t2 t3]): {tuple(corpus.shape)}")
    print(corpus[:5].cpu().numpy())

    seq = SeqData(args.root, RecDataset.SYNTHETIC, is_train=False)
    idx = np.arange(min(5, len(seq)))
    ids = torch.as_tensor(seq.items[idx].astype(np.int32), device=tok.device)
    tokenized = tok(SeqBatch(
        user_ids=torch.as_tensor(seq.users[idx].astype(np.int32), device=tok.device), ids=ids,
        ids_fut=torch.as_tensor(seq.fut[idx].astype(np.int32)[:, None], device=tok.device),
        x=None, x_fut=None, seq_mask=ids >= 0))
    print(f"\ntokenized eval batch: sem_ids {tuple(tokenized.sem_ids.shape)}, "
          f"fut {tuple(tokenized.sem_ids_fut.shape)}")

    # The rare-tag remap replayed on the truth, into the model's label space.
    train_items = ItemData(args.root, RecDataset.SYNTHETIC, train_test_split="train")
    orig_counts = [int(train_items.tags_indices[:, i].max()) + 1 for i in range(3)]
    _, id_mappings, _ = compute_rare_tag_remap(train_items.tags_indices, orig_counts,
                                               rare_tag_threshold=3)
    truth = apply_tag_remap(items.tags_indices, id_mappings)[:5]
    preds = tok.predict_tags(items.item_features[:5])
    print("\ntag predictions vs ground truth (remapped space, first 5 items):")
    for i in range(5):
        print(f"  item {i}: pred {preds['predictions'][i].tolist()} "
              f"(conf {preds['confidences'][i].cpu().numpy().round(2).tolist()}) "
              f"vs truth {truth[i].tolist()}")
    return dict(result=result, items=items, corpus=corpus, truth=truth, preds=preds)


def train_rqvae(args):
    from hidvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
    from hidvae_tpu_torch.train import rqvae

    result, hist, items = train_run(rqvae, args, use_dedup_dim=True)
    if hist["repetition_rate"]:
        print(f"repetition rate: {hist['repetition_rate'][-1]:.4f}")
    print(f"checkpoints: {result['saved_paths']}")
    tok = SemanticIdTokenizer(result["model"], n_layers=3, codebook_size=64,
                              use_dedup_dim=True, device=args.device)
    corpus = tok.precompute_corpus_ids(items.item_features)
    print(f"\ncorpus IDs {tuple(corpus.shape)} (last col = dedup rank):")
    print(corpus[:5].cpu().numpy())
    print(f"max duplicates: {int(corpus[:, -1].max()) + 1}")
    return dict(result=result, items=items, corpus=corpus)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("processed")
    p.add_argument("root", help="dataset folder (containing processed/)")
    p.add_argument("--dataset", default="SYNTHETIC", choices=[d.name for d in RecDataset])
    p.add_argument("--split", default="")
    p.add_argument("--samples", type=int, default=3)
    p.add_argument("--plots", default=None, metavar="DIR",
                   help="also write tag-distribution charts here")
    p.set_defaults(func=processed)
    for name, fn, iterations in (("train-hrqvae", train_hrqvae, 30),
                                 ("train-rqvae", train_rqvae, 20)):
        p = sub.add_parser(name)
        p.add_argument("--iterations", type=int, default=iterations)
        p.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "hidvae_view_ds"))
        p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "hidvae_view_out"))
        p.add_argument("--device", default=None, help="cuda (default) or cpu")
        p.set_defaults(func=fn)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
