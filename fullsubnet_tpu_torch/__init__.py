"""fullsubnet_tpu_torch — the PyTorch/CUDA port of ``fullsubnet_tpu``.

The JAX package stays the reference; every module here is the
counterpart of the JAX module of the same path and is tested against it
on the CPU. What exists so far is the flagship FullSubNet inference path
(exact-length or batched and length-masked) and its training step and
loop with validation, with the LSTM cell of the recipes or the GRU cell
(``sequence_model = "GRU"``):

- ``acoustics`` — STFT/iSTFT on ``torch.stft``, cIRM masks, the two
  Laplace norms and the offline one's masked form, ``freq_unfold``,
  ``drop_band`` and the numpy waveform helpers of the data pipeline;
- ``nn``        — the plain stacked LSTM and GRU and ``SequenceModel``;
- ``ops``       — the fused LSTM or GRU scan + Linear head: hand-written
  CUDA kernels for Hopper (``sm_90a``), the inference forward (K1,
  K1-GRU), the training forward with state stashes (K2, K2-GRU) and the
  per-layer backward (K3, K4), each beside its plain PyTorch version, and
  the ``torch.autograd.Function`` that joins a training forward and a
  layer backward;
- ``models``    — ``FullSubNet`` (unfused forward, with drop_band and
  ``valid_frames``);
- ``data``      — wav I/O, the on-the-fly training mixtures, the
  validation pairs, the inference listing and the training loader;
- ``metrics``, ``pesq`` — SI-SDR, STOI and the numpy P.862 PESQ;
- ``train``     — the losses, the ``Trainer`` (with validation) and its CLI;
- ``infer``     — the ``full_band_crm_mask`` Inferencer (exact-length or
  batched) and its CLI.

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
