"""Train the stage-1 plain RQ-VAE tokenizer with the PyTorch port from a
gin config (counterpart of train_rqvae.py, the same gin surface):

    python scripts/torch_train_rqvae.py CONFIG.gin [--resume CHECKPOINT] [--device cpu]

`--resume` overrides `train.pretrained_rqvae_path`; under torchrun it is
data-parallel."""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config_path", help="plain RQ-VAE gin config")
    ap.add_argument("--resume", default=None, help="RQ-VAE checkpoint to resume from")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from hidvae_tpu_torch.parallel.mesh import torchrun_group
    from hidvae_tpu_torch.train.rqvae import train
    from hidvae_tpu_torch.utils.config import parse_config_and_run

    with torchrun_group(args.device) as device:
        result = parse_config_and_run(train, [args.config_path],
                                      pretrained_rqvae_path=args.resume, device=device)
    if result["mesh"].is_main:
        print(f"trained to step {result['step']}; repetition rate "
              f"{result['history']['repetition_rate'][-1:]}; checkpoints {result['saved_paths']}")
    return result


if __name__ == "__main__":
    main()
