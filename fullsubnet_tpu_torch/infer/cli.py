"""Inference entry point (counterpart of ``fullsubnet_tpu/infer/cli.py``):

    python -m fullsubnet_tpu_torch.infer.cli \
        -C recipes/dns_interspeech_2020/fullsubnet/inference.toml \
        -M /path/to/best_model.tar -O /path/to/output [--device cuda]

``--device`` defaults to ``cuda`` and fails if no card is present;
``--device cpu`` runs the plain CPU path.
"""

import argparse

from fullsubnet_tpu_torch.config import load_config
from fullsubnet_tpu_torch.infer.inferencer import Inferencer


def main(argv=None):
    parser = argparse.ArgumentParser(description="FullSubNet inference (PyTorch/CUDA)")
    parser.add_argument(
        "-C", "--configuration", type=str, required=True,
        help="Config file (*.toml).",
    )
    parser.add_argument(
        "-M", "--model_checkpoint_path", type=str, required=True,
        help="Checkpoint: torch .tar/.pth with the reference keys.",
    )
    parser.add_argument(
        "-O", "--output_dir", type=str, required=True,
        help="Where enhanced (and noisy copies) are written.",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to run on (default: cuda; raises without a card).",
    )
    args = parser.parse_args(argv)

    config = load_config(args.configuration)
    Inferencer(config, args.model_checkpoint_path, args.output_dir, device=args.device)()


if __name__ == "__main__":
    main()
