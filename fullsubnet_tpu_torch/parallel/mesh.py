"""Device meshes and data parallelism (counterpart of
``fullsubnet_tpu/parallel/mesh.py``).

Two halves. **Training** runs over ``torch.distributed``: the JAX package
shards the batch over the ``data`` axis of a device mesh and XLA sums the
gradients; here one process drives one GPU, every process holds the whole
model, and the gradients are averaged over the processes once a step with
one all-reduce of a flat fp32 buffer (the counterpart of XLA's psum).
Processes join a process group that the train CLI sets up from its flags
or from ``torch.distributed.run``'s environment (``init_from_launch``):
NCCL for CUDA, gloo for the CPU.

``[trainer.mesh]``: ``data`` absent or equal to the number of processes;
``slices`` must divide ``data`` and changes nothing (NCCL builds its own
rings); ``subband`` > 1, the sub-band axis, is not ported (ROADMAP A.25).

**Inference** runs in one process over the cards of one host:
:func:`make_mesh` lays devices out as a (data, subband) grid,
:func:`shard_batch` cuts a batch into one contiguous slice of rows for each
``data`` index, on its device, and :func:`replicate` puts one copy of a
state dict on each distinct device (``parallel/inference.py`` runs the
enhancer over them). The sub-band axis is not ported here either: the JAX
package splits the sub-band rows over ``subband`` only where B·F divides
the mesh, which the flagship's F = 257, a prime, never does past B, and
where it does the split gives the rows a split of the batch gives.
"""

from __future__ import annotations

import dataclasses
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
            "GPUs) is not ported (ROADMAP A.25)"
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


# ---------------------------------------------------------------------------
# the inference half: a mesh of devices in one process
# ---------------------------------------------------------------------------

_SUBBAND_NOT_PORTED = (
    "a mesh with subband > 1 (the sub-band rows split over several GPUs) is not ported "
    "(ROADMAP A.25): split the batch over the data axis"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, subband) grid of devices, ``devices[d][s]`` (the JAX
    package's ``jax.sharding.Mesh`` over the axes ("data", "subband")). A
    device may stand at more than one place."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "subband": len(self.devices[0])}

    @property
    def data_devices(self) -> tuple[torch.device, ...]:
        """The device of each ``data`` index, in order (subband is 1)."""
        return tuple(row[0] for row in self.devices)

    @property
    def distinct_devices(self) -> tuple[torch.device, ...]:
        """Each device of the mesh once, in mesh order."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))


def _mesh_check(cond: bool, msg: str) -> None:
    """The JAX function's assertions, with its words, raised also under
    ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def make_mesh(num_data: int | None = None, num_subband: int = 1, devices=None,
              num_slices: int = 1) -> Mesh:
    """A (data, subband) mesh over ``devices``: by default every CUDA card
    torch sees (none raises, as ``utils.resolve_device`` does); the CPU only
    where the caller names it. ``num_data`` defaults to as many as
    ``devices`` give. A device may appear more than once in ``devices``:
    a mesh of four ``"cpu"`` entries splits a batch four ways on the CPU
    (the JAX tests' virtual 8-device CPU mesh), and the one card twice
    splits it in two on one card. ``num_slices`` must divide ``data`` and
    changes nothing (NCCL and peer copies build their own routes).
    ``num_subband`` > 1 raises: the sub-band axis is not ported (A.25)."""
    from fullsubnet_tpu_torch.utils import resolve_device

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            resolve_device("cuda")  # raises: no card
    devices = [resolve_device(d) for d in devices]
    # a card named without its index is the current one
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    if num_data is None:
        num_data = len(devices) // num_subband
    _mesh_check(num_data >= 1 and num_subband >= 1,
                f"mesh {num_data}x{num_subband} is empty — num_subband ({num_subband}) exceeds "
                f"the {len(devices)} available devices?")
    _mesh_check(num_data * num_subband <= len(devices),
                f"mesh {num_data}x{num_subband} needs {num_data * num_subband} devices but only "
                f"{len(devices)} are available")
    if num_slices > 1:
        _mesh_check(num_data % num_slices == 0,
                    f"data axis ({num_data}) must be divisible by the slice count ({num_slices}) "
                    "— sub-band parallelism must not cross DCN")
    if num_subband > 1:
        raise NotImplementedError(_SUBBAND_NOT_PORTED)
    return Mesh(tuple((d,) for d in devices[:num_data]))


def _tree_map(fn, tree):
    """``fn`` over the tensors of a tensor, a mapping or a list or tuple
    of them (the JAX package's ``jax.tree.map`` over a batch or state)."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def data_axis(mesh: Mesh) -> int:
    """The size of the mesh's ``data`` axis; a ``subband`` axis above 1
    raises (A.25)."""
    if mesh.shape["subband"] != 1:
        raise NotImplementedError(_SUBBAND_NOT_PORTED)
    return mesh.shape["data"]


def batch_slices(batch, mesh: Mesh) -> list:
    """The rows of each ``data`` index: ``batch`` (a tensor, or a mapping,
    list or tuple of tensors, each [B, ...]) cut into contiguous views of
    B / data rows, in row order, left where they are. B must be a multiple
    of ``data`` (the JAX package's ``in_shardings`` refuse it otherwise)."""
    rows = {t.shape[0] for t in _leaves(batch)}
    if len(rows) != 1:
        raise ValueError(f"the batch's tensors have different row counts: {sorted(rows)}")
    rows, data = rows.pop(), data_axis(mesh)
    if rows % data:
        raise ValueError(f"a batch of {rows} rows does not split over the mesh's data axis of "
                         f"{data}: B must be a multiple of it")
    per = rows // data
    return [_tree_map(lambda t: t[i * per : (i + 1) * per], batch)  # noqa: B023
            for i in range(data)]


def _leaves(tree) -> list[torch.Tensor]:
    out = []
    _tree_map(out.append, tree)
    return out


def shard_batch(batch, mesh: Mesh) -> list:
    """``batch`` split over the ``data`` axis (the JAX package's
    ``shard_batch`` under ``batch_sharding``): one contiguous slice of
    B / data rows for each ``data`` index, in row order, each on that
    index's device. B must be a multiple of ``data``."""
    return [_tree_map(lambda t: t.to(dev), part)  # noqa: B023
            for part, dev in zip(batch_slices(batch, mesh), mesh.data_devices)]


def replicate(state, mesh: Mesh) -> dict:
    """One copy of ``state`` (a tensor, or a mapping, list or tuple of
    them, as a state dict) on each distinct device of the mesh, by device
    (the JAX package's ``replicate`` under ``replicated_sharding``)."""
    return {dev: _tree_map(lambda t: t.to(dev), state)  # noqa: B023
            for dev in mesh.distinct_devices}
