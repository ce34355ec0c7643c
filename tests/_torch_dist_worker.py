"""One rank of the port's data-parallel Trainer on the CPU, for
tests/test_torch_distributed.py.

    python tests/_torch_dist_worker.py SPEC.json RANK

Joins a gloo process group (``SPEC["init"]``, ``SPEC["world"]`` ranks),
runs the tasks of the spec and writes what it saw to
``SPEC["out"]/rank<RANK>.pt``. The rank processes import torch and the
port only: JAX is the parent's, and a child importing it could wait
minutes on a TPU plugin (tests/conftest.py removes it in the parent
alone).
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


def _trainer(cfg_path, out, accum=None):
    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    config = load_config(cfg_path)
    if accum is not None:
        config["trainer"]["train"]["grad_accum_steps"] = accum
    return Trainer(config, output_dir=str(out), device="cpu")


def main(spec_path: str, rank: int) -> None:
    spec = json.loads(Path(spec_path).read_text())
    world = spec["world"]
    dist.init_process_group("gloo", init_method=spec["init"], rank=rank, world_size=world)
    weights = torch.load(spec["weights"], weights_only=True)
    out = Path(spec["out"])
    seen = {"rank": rank, "steps": {}}

    # steps on this rank's contiguous share of each global batch
    for name, case in spec["steps"].items():
        trainer = _trainer(spec["config"], out / f"steps_{rank}", case["accum"])
        trainer.model.load_state_dict(weights)
        batches = np.load(case["batches"])
        noisy, clean = batches["noisy"], batches["clean"]
        local = noisy.shape[1] // world
        rows = slice(rank * local, (rank + 1) * local)
        losses = [float(trainer.train_step(torch.from_numpy(n[rows]), torch.from_numpy(c[rows])))
                  for n, c in zip(noisy, clean)]
        seen["steps"][name] = {
            "losses": losses,
            "split": trainer.accum_split(noisy.shape[1]),
            "params": {k: v.clone() for k, v in trainer.model.state_dict().items()},
        }

    # one sharded validation epoch
    trainer = _trainer(spec["validation_config"], out / f"validation_{rank}")
    trainer.model.load_state_dict(weights)
    seen["validation_score"] = trainer._validation_epoch(1)
    seen["validation_scalars"] = dict(trainer.scalars[1])

    # one epoch of the train loop, each rank in an output directory of its own
    trainer = _trainer(spec["config"], out / f"train_{rank}")
    trainer.model.load_state_dict(weights)
    trainer.train()
    seen["trained"] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    seen["epoch_losses"] = dict(trainer.epoch_losses)
    seen["steps_trained"] = trainer.steps
    torch.save(seen, out / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
