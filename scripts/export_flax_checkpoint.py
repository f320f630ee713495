"""Export an Orbax checkpoint of the JAX package for the PyTorch port.

    python scripts/export_flax_checkpoint.py SRC DST [--opt-state]

SRC is a checkpoint directory that hidvae_tpu.train.common.save_checkpoint
wrote (a stage-1 `latest` or a stage-2 `checkpoint_N`). DST becomes an
exported checkpoint, the format hidvae_tpu_torch/bridge.py reads:
`arrays.npz`, the checkpoint's leaves flattened under "/"-joined keys
("params/...", "batch_stats/...", "step"), and `meta.json` copied byte for
byte. Optimizer state ("opt_state/...", named as flax's to_state_dict
names the optax state) is carried only with `--opt-state`: serving needs
none of it, and the port's stage-2 trainer reads it to resume a JAX run
on the card (scripts/torch_train_transformer.py --resume DST).

The checkpoint is restored raw, with no target, as the lenient branch of
restore_checkpoint restores it (hidvae_tpu/train/common.py:345-346), so no
model needs to be built. Runs where JAX and Orbax are installed; the port
itself never reads Orbax.
"""

import argparse
import os
import shutil

import numpy as np

META_FILE = "meta.json"
ARRAYS_FILE = "arrays.npz"


def export_checkpoint(src: str, dst: str, opt_state: bool = False) -> dict:
    """Write the export of Orbax checkpoint `src` into directory `dst`, with
    the optimizer state when `opt_state`; returns the flat arrays written."""
    import orbax.checkpoint as ocp
    from flax import traverse_util

    with ocp.PyTreeCheckpointer() as ckptr:
        raw = ckptr.restore(os.path.abspath(src))
    flat = traverse_util.flatten_dict(raw, sep="/")
    arrays = {k: np.asarray(v) for k, v in flat.items()
              if opt_state or not k.startswith("opt_state")}
    os.makedirs(dst, exist_ok=True)
    np.savez(os.path.join(dst, ARRAYS_FILE), **arrays)
    meta = os.path.join(src, META_FILE)
    if os.path.exists(meta):
        shutil.copyfile(meta, os.path.join(dst, META_FILE))
    return arrays


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", help="Orbax checkpoint directory")
    ap.add_argument("dst", help="directory to write arrays.npz and meta.json into")
    ap.add_argument("--opt-state", action="store_true",
                    help="carry the optimizer state (to resume the run with the port)")
    args = ap.parse_args()
    arrays = export_checkpoint(args.src, args.dst, opt_state=args.opt_state)
    n_bytes = sum(a.nbytes for a in arrays.values())
    print(f"exported {len(arrays)} leaves ({n_bytes / 2**20:.1f} MiB) to {args.dst}")


if __name__ == "__main__":
    main()
