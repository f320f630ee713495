"""Train the stage-2 decoder with the PyTorch port from a gin config
(counterpart of train_transformer.py, the same gin surface):

    python scripts/torch_train_transformer.py CONFIG.gin \
        [--stage1 EXPORTED_STAGE1] [--resume EXPORTED_CHECKPOINT] [--device cpu]

`--stage1` overrides `train.pretrained_rqvae_path`, `--resume`
`train.pretrained_decoder_path`; under torchrun `--model-shards k` trains
on a (N / k, k) mesh."""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config_path", help="decoder gin config")
    ap.add_argument("--stage1", default=None, help="exported stage-1 (tokenizer) checkpoint dir")
    ap.add_argument("--resume", default=None, help="exported decoder checkpoint to resume from")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--model-shards", type=int, default=None,
                    help="tensor-parallel ranks of the mesh (train.n_model_shards)")
    args = ap.parse_args(argv)

    from hidvae_tpu_torch.parallel.mesh import torchrun_group
    from hidvae_tpu_torch.train.transformer import train
    from hidvae_tpu_torch.utils.config import parse_config_and_run

    with torchrun_group(args.device) as device:
        result = parse_config_and_run(
            train, [args.config_path], pretrained_rqvae_path=args.stage1,
            pretrained_decoder_path=args.resume, device=device,
            n_model_shards=args.model_shards)
    if result["mesh"].is_main:
        print(f"trained to step {result['step']} on mesh {result['mesh'].shape}; "
              f"checkpoints {result['saved_paths']}")
    return result


if __name__ == "__main__":
    main()
