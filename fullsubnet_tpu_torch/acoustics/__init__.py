"""DSP on torch tensors: STFT/iSTFT, cIRM masks, norms, unfold."""
