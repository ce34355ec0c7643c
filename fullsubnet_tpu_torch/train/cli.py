"""Training entry point (counterpart of ``fullsubnet_tpu/train/cli.py``):

    python -m fullsubnet_tpu_torch.train.cli \
        -C recipes/dns_interspeech_2020/fullsubnet/train.toml [-R] [-V] [-P path] [-O dir] [--device cuda]

``--device`` defaults to ``cuda`` and fails if no card is present;
``--device cpu`` runs the plain CPU path. ``-V`` runs one validation
epoch of the weights at hand (from ``-R`` or ``-P``) and trains nothing.

Data-parallel training runs one process per GPU (``parallel/mesh.py``;
``batch_size`` is the global batch), launched either by
``torch.distributed.run``::

    python -m torch.distributed.run --nproc_per_node 8 \
        -m fullsubnet_tpu_torch.train.cli -C train.toml

(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), or once per process with the JAX CLI's flags
``--coordinator host:port --num-processes N --process-id I`` (any of them,
or ``FULLSUBNET_DISTRIBUTED=1``, asks for a distributed launch). The
backend is NCCL on ``cuda:LOCAL_RANK`` for ``--device cuda``, gloo for
``--device cpu``; a failed rendezvous or NCCL start raises.
"""

import argparse
import os
import random

import numpy as np
import torch

from fullsubnet_tpu_torch.config import experiment_name_from_config_path, load_config
from fullsubnet_tpu_torch.parallel.mesh import init_from_launch, wants_distributed
from fullsubnet_tpu_torch.train.trainer import Trainer


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser(description="FullSubNet training (PyTorch/CUDA)")
    parser.add_argument(
        "-C", "--configuration", required=True, type=str,
        help="Configuration (*.toml).",
    )
    parser.add_argument(
        "-R", "--resume", action="store_true",
        help="Resume the experiment from its latest checkpoint.",
    )
    parser.add_argument(
        "-V", "--only_validation", action="store_true",
        help="Only run validation.",
    )
    parser.add_argument(
        "-P", "--preloaded_model_path", type=str, default=None,
        help="Warm-start weights (torch .tar/.pth).",
    )
    parser.add_argument(
        "-O", "--output_dir", type=str, default=None,
        help="Override meta.save_dir.",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to train on (default: cuda; raises without a card).",
    )
    parser.add_argument(
        "--coordinator", type=str, default=None,
        help="Distributed rendezvous address host:port (else MASTER_ADDR/MASTER_PORT).",
    )
    parser.add_argument(
        "--num-processes", type=int, default=None,
        help="Total process count of a distributed launch (else WORLD_SIZE).",
    )
    parser.add_argument(
        "--process-id", type=int, default=None,
        help="This process's rank in a distributed launch (else RANK).",
    )
    args = parser.parse_args(argv)
    if args.preloaded_model_path is not None and args.resume:
        parser.error("The 'resume' conflicts with 'preloaded_model_path'.")

    device = args.device
    if wants_distributed(args.coordinator, args.num_processes, args.process_id, os.environ):
        device = init_from_launch(args.device, args.coordinator, args.num_processes,
                                  args.process_id)

    config = load_config(args.configuration)
    seed = int(config.get("meta", {}).get("seed", 0))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    trainer = Trainer(
        config=config,
        resume=args.resume,
        only_validation=args.only_validation,
        preloaded_model_path=args.preloaded_model_path,
        output_dir=args.output_dir,
        experiment_name=experiment_name_from_config_path(args.configuration),
        device=device,
    )
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
