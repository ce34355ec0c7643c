"""Data-parallel training over ``torch.distributed`` (counterpart of the
training half of ``fullsubnet_tpu/parallel/mesh.py``).

The JAX package shards the batch over the ``data`` axis of a device mesh
and XLA sums the gradients; here one process drives one GPU, every
process holds the whole model, and the gradients are averaged over the
processes once a step with one all-reduce of a flat fp32 buffer (the
counterpart of XLA's psum). Processes join a process group that the
train CLI sets up from its flags or from ``torch.distributed.run``'s
environment (``init_from_launch``): NCCL for CUDA, gloo for the CPU.

``[trainer.mesh]``: ``data`` absent or equal to the number of processes;
``slices`` must divide ``data`` and changes nothing (NCCL builds its own
rings); ``subband`` > 1, the sub-band axis, is not ported (ROADMAP A.25).
"""

from __future__ import annotations

import os
from collections.abc import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist


def local_shard_info() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def check_mesh(mesh_cfg: Mapping, world: int) -> None:
    """Check ``[trainer.mesh]`` against ``world`` processes."""
    if int(mesh_cfg.get("subband", 1)) > 1:
        raise NotImplementedError(
            "[trainer.mesh] subband > 1 (the sub-band stage split over several "
            "GPUs) is not ported yet (ROADMAP A.25)"
        )
    data = int(mesh_cfg["data"]) if mesh_cfg.get("data") else world
    if data != world:
        raise ValueError(
            f"[trainer.mesh] data = {data} must equal the number of processes "
            f"({world}): each process drives one GPU on the data axis"
        )
    slices = int(mesh_cfg.get("slices", 1))
    if slices < 1 or data % slices != 0:
        raise ValueError(
            f"data axis ({data}) must be divisible by the slice count ({slices})"
        )


def _collective_device() -> torch.device:
    """Where a host value goes for a collective: the current card for
    NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def psum_across_processes(arr: np.ndarray) -> np.ndarray:
    """Element-wise sum of a host array over all processes, in float64
    (the array itself with one process)."""
    if local_shard_info()[1] == 1:
        return arr
    t = torch.as_tensor(np.asarray(arr, np.float64), device=_collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def all_reduce_mean_(params: Sequence[torch.nn.Parameter], loss: torch.Tensor) -> torch.Tensor:
    """Average each parameter's ``.grad`` (fp32, in place) and ``loss`` over
    the processes with one all-reduce of one flat buffer; returns the mean
    loss. Every process has the same graph, so the same parameters have
    gradients."""
    world = local_shard_info()[1]
    if world == 1:
        return loss
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[offset]


def wants_distributed(coordinator, num_processes, process_id, environ: Mapping) -> bool:
    """The JAX CLI's rule: any explicit distributed flag, or
    ``FULLSUBNET_DISTRIBUTED=1``; also a launch by ``torch.distributed.run``
    (``WORLD_SIZE`` set), how a CUDA cluster is discovered."""
    return (
        coordinator is not None
        or num_processes is not None
        or process_id is not None
        or environ.get("FULLSUBNET_DISTRIBUTED", "").lower() in ("1", "true")
        or "WORLD_SIZE" in environ
    )


def init_from_launch(device: str, coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> torch.device:
    """Join the process group of a distributed launch and return the
    device this process trains on.

    The rank and world size come from ``process_id`` / ``num_processes``,
    else from ``RANK`` / ``WORLD_SIZE``; the rendezvous from
    ``coordinator`` (host:port, TCP), else ``MASTER_ADDR`` /
    ``MASTER_PORT``. On ``cuda`` the backend is NCCL on ``cuda:LOCAL_RANK``
    (``LOCAL_RANK``, else the rank modulo the cards), on ``cpu`` gloo. A
    failed rendezvous or NCCL start raises: there is no single-process
    fallback. A process that has joined a group already keeps it."""
    from fullsubnet_tpu_torch.utils import resolve_device

    environ = os.environ
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = environ.get("LOCAL_RANK")
        if local is None:
            rank = process_id if process_id is not None else environ.get("RANK", 0)
            local = int(rank) % torch.cuda.device_count()
        dev = torch.device("cuda", int(local))
    if dist.is_initialized():
        return dev
    rank = process_id if process_id is not None else environ.get("RANK")
    world = num_processes if num_processes is not None else environ.get("WORLD_SIZE")
    if rank is None or world is None:
        raise ValueError(
            "a distributed launch needs this process's rank and the world size: "
            "pass --process-id and --num-processes, or start under "
            "torch.distributed.run (RANK, WORLD_SIZE)"
        )
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
    elif "MASTER_ADDR" in environ and "MASTER_PORT" in environ:
        init_method = f"tcp://{environ['MASTER_ADDR']}:{environ['MASTER_PORT']}"
    else:
        raise ValueError(
            "a distributed launch needs the rendezvous address: pass --coordinator "
            "host:port, or set MASTER_ADDR and MASTER_PORT"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, rank=int(rank),
                                world_size=int(world), device_id=dev)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, rank=int(rank),
                                world_size=int(world))
    else:
        raise ValueError(f"no process-group backend for device {str(dev)!r}")
    # NCCL connects lazily: one all-reduce now, so that a broken group
    # fails here and not in the first step
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != int(world):
        raise RuntimeError(f"the process group's probe summed to {probe.item()}, not {world}")
    return dev
