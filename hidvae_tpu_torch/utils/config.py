"""Command-line plumbing of the port's trainers (counterpart of
hidvae_tpu/utils/config.py): bind a gin file's `train.*` values to a
trainer's keywords with the port's ginlite and call it."""

import argparse

from hidvae_tpu_torch.utils.ginlite import bind_to_kwargs, parse_gin_file


def parse_config_and_run(train_fn, argv=None, **overrides):
    """`train_fn(**kwargs)` bound from the gin file in `argv` (default the
    command line); an unknown binding raises, as gin; overrides not None
    replace bindings."""
    parser = argparse.ArgumentParser()
    parser.add_argument("config_path", type=str, help="Path to gin config file.")
    args = parser.parse_args(argv)
    kwargs = bind_to_kwargs(parse_gin_file(args.config_path), "train", train_fn)
    kwargs.update({k: v for k, v in overrides.items() if v is not None})
    return train_fn(**kwargs)
