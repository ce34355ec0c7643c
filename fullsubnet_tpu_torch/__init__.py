"""fullsubnet_tpu_torch — the PyTorch/CUDA port of ``fullsubnet_tpu``.

The JAX package stays the reference; every module here is the
counterpart of the JAX module of the same path and is tested against it
on the CPU. What exists so far is the flagship FullSubNet inference
path:

- ``acoustics`` — STFT/iSTFT on ``torch.stft``, cIRM masks, the two
  Laplace norms and ``freq_unfold``;
- ``nn``        — the plain stacked LSTM and ``SequenceModel``;
- ``ops``       — the fused LSTM-scan + Linear head: a hand-written CUDA
  kernel for Hopper (``sm_90a``) and its plain PyTorch version;
- ``models``    — ``FullSubNet`` (unfused inference forward);
- ``infer``     — the ``full_band_crm_mask`` Inferencer and its CLI.

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
