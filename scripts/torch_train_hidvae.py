"""Train the stage-1 HiD-VAE tokenizer with the PyTorch port from a gin
config (counterpart of train_hidvae.py, the same gin surface):

    python scripts/torch_train_hidvae.py CONFIG.gin [--resume CHECKPOINT] [--device cpu]

`--resume` overrides `train.pretrained_hrqvae_path`; under torchrun it is
data-parallel."""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config_path", help="stage-1 gin config")
    ap.add_argument("--resume", default=None, help="stage-1 checkpoint to resume from")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from hidvae_tpu_torch.parallel.mesh import torchrun_group
    from hidvae_tpu_torch.train.hidvae import train
    from hidvae_tpu_torch.utils.config import parse_config_and_run

    with torchrun_group(args.device) as device:
        result = parse_config_and_run(train, [args.config_path],
                                      pretrained_hrqvae_path=args.resume, device=device)
    if result["mesh"].is_main:
        print(f"trained to step {result['step']}; tag_class_counts {result['tag_class_counts']}; "
              f"checkpoints {result['saved_paths']}")
    return result


if __name__ == "__main__":
    main()
