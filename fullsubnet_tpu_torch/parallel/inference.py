"""Multi-card inference (counterpart of ``fullsubnet_tpu/parallel/inference.py``).

:func:`make_parallel_enhancer` returns the whole enhancement pipeline (wave
-> STFT -> FullSubNet -> cIRM decompression -> complex mask -> iSTFT ->
wave) with the batch split over the ``data`` axis of a mesh
(``parallel/mesh.py``): each ``data`` index enhances its contiguous slice of
rows on its device, with its own copy of the weights, and the slices are
gathered in row order on the mesh's first device. The JAX package compiles
one SPMD program; here one host thread for each slice (as
``torch.nn.parallel.parallel_apply`` runs them) launches that slice's work
on its card's current stream, so that the host launches for one card never
wait on another card. On a card the stacks run K1 (K1-bf16 under a bf16
``compute_dtype``); on the CPU their plain versions.

Only the ``data`` axis is ported: a mesh with ``subband`` > 1 raises
(ROADMAP A.25, ``parallel/mesh.py``).

The model and the kernel wrappers of ``ops/subband_lstm.py`` read no host
value, so a thread's launches run ahead of its card, and a thread waits
only on its own card: where a batch or ``true_len`` given on the host is
copied to the card (a copy from pageable memory returns once the card has
read it), where the caching allocator first takes memory from the card,
and, in the plain form, at its last step: ``torch.istft`` checks the
window's overlap-add envelope on the host (the bucketed form's masked
iSTFT does not), so that thread returns when its card has finished.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time

import torch

from fullsubnet_tpu_torch.infer.inferencer import bucketed_enhance, full_band_crm_mask
from fullsubnet_tpu_torch.parallel.mesh import Mesh, batch_slices, data_axis


def kernel_libraries() -> tuple:
    """The kernel libraries the enhancer's path can launch from: K1's GEMM
    and walk, K1-bf16's GEMM and its walk's three forms."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    return ops.fwd_library, ops.tc_library, ops.fwd_tc_library, ops.train_fwd_library


def load_kernel_libraries() -> None:
    """Build and load :func:`kernel_libraries` once, in the calling thread:
    the libraries load at first use with no lock, and two threads that both
    built one would write the same files."""
    for library in kernel_libraries():
        library()


class ParallelEnhancer:
    """What :func:`make_parallel_enhancer` returns: call it as the JAX
    function is called. ``weight_loads`` counts the copies of a weight set
    onto a device; ``enqueue_seconds`` holds each slice's host time (its
    thread's launches) of the last call."""

    def __init__(self, model, mesh: Mesh, acoustics: dict, compute_dtype: torch.dtype,
                 bucketed: bool):
        data_axis(mesh)  # subband > 1 raises
        self.mesh = mesh
        self.acoustics = acoustics
        self.compute_dtype = None if compute_dtype == torch.float32 else compute_dtype
        self.bucketed = bucketed
        # one replica of the model a distinct device, its storage allocated
        # there uninitialised: weights cross only with a weight set
        self.replicas = {dev: copy.deepcopy(model).to_empty(device=dev).eval()
                         for dev in mesh.distinct_devices}
        self.weight_loads = 0
        self.enqueue_seconds: list[float] = []
        self._weights_key = None
        self._weights = None
        if any(dev.type == "cuda" for dev in self.replicas):
            load_kernel_libraries()

    def _load(self, params: dict) -> None:
        """Copy ``params`` (a port state dict) onto every device, unless it
        is the weight set already there: the same dict holding the same
        tensors, none changed in place since (inference tensors have no
        version counter and are taken as unchanged)."""
        key = (id(params), tuple((id(v), 0 if v.is_inference() else v._version)
                                 for v in params.values()))
        if key == self._weights_key:
            return
        self._weights_key, self._weights = None, None
        with torch.no_grad():
            for replica in self.replicas.values():
                replica.load_state_dict(params)
                self.weight_loads += 1
        # the dict and its tensors are held so that no other object takes
        # one of their ids
        self._weights_key, self._weights = key, (params, list(params.values()))

    def _enhance(self, replica, noisy: torch.Tensor, true_len: torch.Tensor | None):
        if self.bucketed:
            return bucketed_enhance(replica, self.acoustics, noisy, true_len)
        return full_band_crm_mask(replica, self.acoustics, noisy, self.compute_dtype)

    def shards(self, params: dict, noisy: torch.Tensor,
               true_len: torch.Tensor | None = None) -> list[torch.Tensor]:
        """Each ``data`` index's enhanced rows on its device, in row order,
        before the gather; launched, not waited for. A slice that raises
        raises here, after every thread has ended."""
        self._load(params)
        batch = (noisy,) if true_len is None else (noisy, true_len.reshape(-1).expand(
            noisy.shape[0]))
        slices = batch_slices(batch, self.mesh)
        devices = self.mesh.data_devices
        # each thread launches on the stream its card has in the calling thread
        streams = {dev: torch.cuda.current_stream(dev) for dev in set(devices)
                   if dev.type == "cuda"}
        seconds = [0.0] * len(slices)

        outs: list = [None] * len(slices)
        errors: list = [None] * len(slices)

        def run(i: int) -> None:
            dev = devices[i]
            t0 = time.perf_counter()
            try:
                with torch.inference_mode(), _on(dev, streams.get(dev)):
                    rows = [t.to(dev) for t in slices[i]]
                    outs[i] = self._enhance(self.replicas[dev], rows[0],
                                            rows[1] if self.bucketed else None)
            except Exception as err:  # the thread's boundary: raised in the caller
                errors[i] = err
            seconds[i] = time.perf_counter() - t0

        if len(slices) == 1:
            run(0)
        else:
            threads = [threading.Thread(target=run, args=(i,), name=f"enhance-{i}-{dev}")
                       for i, dev in enumerate(devices)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
        self.enqueue_seconds = seconds
        for err in errors:
            if err is not None:
                raise err
        return outs

    def gather(self, outs: list[torch.Tensor]) -> torch.Tensor:
        """The slices joined in row order on the mesh's first device."""
        first = self.mesh.data_devices[0]
        with torch.inference_mode():
            return torch.cat([o.to(first) for o in outs])

    def __call__(self, params: dict, noisy: torch.Tensor,
                 true_len: torch.Tensor | None = None) -> torch.Tensor:
        if self.bucketed != (true_len is not None):
            raise TypeError("the bucketed enhancer takes (params, noisy [B, bucket], true_len "
                            "[B]); the plain one (params, noisy [B, T])")
        return self.gather(self.shards(params, noisy, true_len))


@contextlib.contextmanager
def _on(dev: torch.device, stream):
    """Launch on ``dev`` and ``stream`` (a CUDA device), or as the caller
    does (the CPU)."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def make_parallel_enhancer(model, mesh: Mesh, n_fft: int = 512, hop_length: int = 256,
                           win_length: int = 512, compute_dtype: torch.dtype = torch.float32,
                           bucketed: bool = False) -> ParallelEnhancer:
    """Enhancement with the batch split over the mesh's ``data`` axis:
    ``fn(params, noisy [B, T]) -> enhanced [B, T]``, ``params`` a port state
    dict of ``model`` (the keys ``checkpoint.state_dict_from_jax_params``
    gives and ``load_state_dict`` takes). B must be a multiple of the
    ``data`` axis; the output is one tensor on the mesh's first device, in
    row order. The magnitude is cast to ``compute_dtype`` before the model
    (bf16: the stacks on K1-bf16) and the cRM back to fp32 after it. The
    weights cross to each device once for each weight set, not on every
    call.

    ``bucketed=True`` returns ``fn(params, noisy [B, bucket], true_len [B])
    -> enhanced [B, bucket]`` over ``infer.inferencer.bucketed_enhance``
    (per-row true lengths, each row's prefix equal to its unpadded run; no
    ``compute_dtype``, as in the JAX package)."""
    if bucketed and compute_dtype != torch.float32:
        raise ValueError("the bucketed enhancer takes no compute_dtype, as in the JAX package")
    acoustics = {"n_fft": n_fft, "hop_length": hop_length, "win_length": win_length}
    return ParallelEnhancer(model, mesh, acoustics, compute_dtype, bucketed)
