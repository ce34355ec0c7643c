"""fullsubnet_tpu_torch — the PyTorch/CUDA port of ``fullsubnet_tpu``.

The JAX package stays the reference; every module here is the
counterpart of the JAX module of the same path and is tested against it
on the CPU. The port runs everything the JAX package does offline, for
every model family, with the LSTM cell of the recipes or the GRU cell
(``sequence_model = "GRU"``):

- ``acoustics`` — STFT/iSTFT on ``torch.stft`` (with a frame mask), cIRM
  masks, the six norms and the offline ones' masked forms, the mel
  filterbank, ``freq_unfold``, ``drop_band`` and the other feature
  functions, the numpy waveform helpers, the RIR utilities;
- ``nn``        — the plain stacked LSTM and GRU, ``SequenceModel``, the
  weight init, the causal conv blocks and the cumulative feature norms;
- ``ops``       — the fused LSTM or GRU scan + Linear head: hand-written
  CUDA kernels for Hopper (``sm_90a``), the inference forward (K1,
  K1-GRU), the training forward with state stashes (K2, K2-GRU) and the
  per-layer backward (K3, K4), each beside its plain PyTorch version, and
  the ``torch.autograd.Function`` that joins a training forward and a
  layer backward;
- ``models``    — ``FullSubNet``, the full-band and sub-band baselines,
  Fast FullSubNet and Improved FullSubNet (16 and 48 kHz), with
  length-masked forms (``valid_frames``, ``valid_samples``);
- ``data``      — wav I/O, the on-the-fly training mixtures (mixed on the
  host, or shipped as components and mixed on the device), the validation
  pairs, the inference listing and the sharded training loader;
- ``metrics``, ``pesq`` — SI-SDR, STOI and the numpy P.862 PESQ;
- ``train``     — the losses, the ``Trainer`` (with validation and
  gradient accumulation) and its CLI;
- ``parallel``  — data-parallel training over ``torch.distributed`` (NCCL
  or gloo): the process group of a launch, the gradient all-reduce, the
  cross-process sums of validation;
- ``infer``     — the Inferencer with the six strategies (exact-length or
  batched) and its CLI, the streaming engines and their hosts;
- ``serving``   — the inference paths exported with ``torch.export`` (K1's
  stages inside as registered operators), served without the model code;
- ``tools``     — the offline tools (``calculate_metrics``, ``find_wavs``,
  ``delete_silence``, ``preprocessing_dataset``) and ``xlsx``, the
  workbook writer ``calculate_metrics`` uses;
- ``native``    — the host mixer (the C++ SNR mix and window energies,
  built with g++ at first use) the training set mixes with;
- ``roofline``, ``profiling`` — analytic FLOPs and bytes with the H100's
  peaks (``mfu``, the kernels' bounds), and ``torch.profiler`` traces,
  spans and timing.

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
