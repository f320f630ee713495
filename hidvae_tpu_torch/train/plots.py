"""End-of-run plots (counterpart of hidvae_tpu/train/plots.py); without
matplotlib a run trains all the same and logs the failure."""

import os


def save_plots(plot, history: dict, save_dir: str, log):
    """`plot(history, save_dir/plots)`; plots are optional (no metric
    depends on them), so a failure is logged and the run goes on."""
    try:
        plot(history, os.path.join(save_dir, "plots"))
    except Exception as e:
        log.warning(f"Plotting failed: {e}")


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_series(ax, xs, ys, title, ylabel="value"):
    ax.plot(xs, ys)
    ax.set_title(title)
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)


def plot_hidvae_history(history: dict, out_dir: str):
    """Write losses.png and diversity.png into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    xs = history["iterations"]
    if not xs:
        return
    plt = _pyplot()
    fig, axes = plt.subplots(2, 3, figsize=(18, 10))
    for ax, key, title in (
        (axes[0, 0], "total_loss", "total loss"),
        (axes[0, 1], "reconstruction_loss", "reconstruction loss"),
        (axes[0, 2], "rqvae_loss", "rq-vae loss"),
        (axes[1, 0], "tag_align_loss", "tag alignment loss"),
        (axes[1, 1], "tag_pred_loss", "tag prediction loss"),
    ):
        _plot_series(ax, xs, history[key], title)
    _plot_series(axes[1, 2], xs, history["tag_pred_accuracy"], "tag accuracy", "accuracy")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "losses.png"), dpi=100)
    plt.close(fig)

    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    for level, series in enumerate(history.get("emb_norms", [])):
        if series:
            axes[0].plot(xs[: len(series)], series, label=f"layer {level}")
    axes[0].set_title("embedding norms")
    axes[0].legend()
    exs = history.get("eval_iterations", [])
    for level, series in enumerate(history.get("codebook_usage", [])):
        if series:
            axes[1].plot(exs[: len(series)], series, label=f"layer {level}")
    axes[1].set_title("codebook usage")
    axes[1].legend()
    if history.get("rqvae_entropy"):
        axes[2].plot(exs[: len(history["rqvae_entropy"])], history["rqvae_entropy"],
                     label="entropy")
        ax2 = axes[2].twinx()
        ax2.plot(exs[: len(history["max_id_duplicates"])], history["max_id_duplicates"],
                 "r--", label="max dups")
        axes[2].set_title("ID diversity")
    for ax in axes:
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "diversity.png"), dpi=100)
    plt.close(fig)


def plot_rqvae_history(history: dict, out_dir: str):
    """Write losses.png (total, reconstruction and RQ-VAE loss) into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    xs = history["iterations"]
    if not xs:
        return
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    for ax, key, title in ((axes[0], "total_loss", "total loss"),
                           (axes[1], "reconstruction_loss", "reconstruction loss"),
                           (axes[2], "rqvae_loss", "rq-vae loss")):
        _plot_series(ax, xs, history[key], title)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "losses.png"), dpi=100)
    plt.close(fig)


def plot_transformer_history(history: dict, out_dir: str):
    """Write losses.png and, when the run had full evals, eval_metrics.png
    into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    xs = history.get("iterations", [])
    if not xs:
        return
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    _plot_series(axes[0], xs, history["train_loss"], "train loss")
    exs = history.get("eval_iterations", [])
    if exs:
        _plot_series(axes[1], exs, history["eval_loss"], "eval loss")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "losses.png"), dpi=100)
    plt.close(fig)

    fxs = history.get("full_eval_iterations", [])
    fms = history.get("full_eval_metrics", [])
    if not fxs or not fms:
        return
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    last_dim = max((int(k.rsplit(":", 1)[1]) for k in fms[0] if "_slice_:" in k), default=0)
    for prefix, ax, title in (
        ("h@", axes[0], "hit rate (full-tuple slice)"),
        ("ndcg@", axes[1], "NDCG (full-tuple slice)"),
    ):
        for k_at in (1, 5, 10):
            key = f"{prefix}{k_at}_slice_:{last_dim}"
            series = [m.get(key) for m in fms]
            if any(v is not None for v in series):
                ax.plot(fxs, series, marker="o", label=key)
        ax.set_title(title)
        ax.set_xlabel("iteration")
        ax.grid(True, alpha=0.3)
        ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "eval_metrics.png"), dpi=100)
    plt.close(fig)
