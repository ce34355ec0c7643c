"""Fast FullSubNet, the mel-domain FullSubNet (counterpart of
``fullsubnet_tpu/models/fast_fullsubnet.py``; the reference's
``recipes/dns_interspeech_2020/fast_fullsubnet/model.py:11-202``).

The encoder F_l2m (a head-less LSTM of 384 units, then 257 units with a
ReLU head to the mel bins) runs on the HTK mel magnitudes; the sub-band
bottleneck S runs on time-downsampled mel units (frame 0, then block
means of ``shrink_size`` frames, the last block possibly partial), B·M
rows of 12 inputs; the decoder F_m2l (a head-less 512-unit LSTM, then a
512-unit one with a head to 2F) emits the full-resolution cRM. Every
stack runs through the fused scan op: on a CUDA tensor K1 at inference,
K2 and K3 under autograd; the 257-unit stack runs there zero-padded to
272 units (``ops.subband_lstm.pad_stack``).

The mel projection promotes to the filterbank's float32, as the JAX
package's einsum does: under the bf16 training policy the stacks still
see float32 inputs, and so compute at float32 there too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fullsubnet_tpu_torch.acoustics.feature import freq_unfold
from fullsubnet_tpu_torch.acoustics.filterbank import mel_filterbank
from fullsubnet_tpu_torch.acoustics.norm import (
    gaussian_norm_from_stats,
    laplace_norm_from_stats,
    masked_offline_norm,
    norm_wrapper,
    offline_gaussian_norm,
    offline_laplace_norm,
)
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel


class MelScale(nn.Module):
    """The mel filterbank [F, M] as the persistent buffer ``fb``, under the
    reference's state-dict key ``mel_scale.fb`` (torchaudio's ``MelScale``)."""

    def __init__(self, fb: torch.Tensor):
        super().__init__()
        self.register_buffer("fb", fb)


class FastFullSubNet(nn.Module):
    def __init__(
        self,
        look_ahead: int = 2,
        shrink_size: int = 2,
        sequence_model: str = "LSTM",
        num_mels: int = 64,
        encoder_input_size: int = 257,
        bottleneck_hidden_size: int = 384,
        bottleneck_num_layers: int = 2,
        noisy_input_num_neighbors: int = 5,
        encoder_output_num_neighbors: int = 0,
        norm_type: str = "offline_laplace_norm",
        sample_rate: int = 16000,
        generator: torch.Generator | None = None,
    ):
        """``generator`` seeds the random initial weights (default: a
        generator seeded with 0)."""
        super().__init__()
        if sequence_model not in ("GRU", "LSTM"):
            raise ValueError("FastFullSubNet only supports GRU and LSTM.")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.look_ahead = look_ahead
        self.shrink_size = shrink_size
        self.num_mels = num_mels
        self.num_freqs = encoder_input_size
        self.noisy_input_num_neighbors = noisy_input_num_neighbors
        self.enc_output_num_neighbors = encoder_output_num_neighbors
        self.norm = norm_wrapper(norm_type)

        def stack(f_in, out, hidden, layers, act):
            return SequenceModel(f_in, out, hidden, layers, False, sequence_model, act,
                                 generator=generator)

        # F_l2m (the encoder): hidden sizes fixed, as in the reference
        self.encoder = nn.ModuleList([
            stack(num_mels, 0, 384, 1, None),
            stack(384, num_mels, 257, 1, "ReLU"),
        ])
        # S (the bottleneck)
        self.bottleneck = stack(
            (noisy_input_num_neighbors * 2 + 1) + (encoder_output_num_neighbors * 2 + 1),
            1, bottleneck_hidden_size, bottleneck_num_layers, "ReLU",
        )
        # F_m2l (the decoder)
        self.decoder_lstm = nn.ModuleList([
            stack(num_mels + num_mels, 0, 512, 1, None),
            stack(512, encoder_input_size * 2, 512, 1, None),
        ])
        self.mel_scale = MelScale(torch.from_numpy(
            mel_filterbank(encoder_input_size, num_mels, sample_rate, 0.0, sample_rate / 2)
        ))

    # -- time down/up-sampling (reference :108-140) ---------------------

    def real_time_downsampling(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, F, T] -> [B, C, F, ceil((T-1)/shrink)+1]: frame 0, then the
        means of blocks of ``shrink_size`` frames, the last block the
        remainder (a whole block where the frames divide evenly)."""
        s = self.shrink_size
        rest = x[..., 1:]
        n_rest = x.shape[-1] - 1
        n_full, r = divmod(n_rest, s)
        whole = (n_full - 1) * s if r == 0 else n_full * s
        body = rest[..., :whole].unflatten(-1, (whole // s, s)).mean(dim=-1)
        last = rest[..., whole:].mean(dim=-1, keepdim=True)
        return torch.cat([x[..., 0:1], body, last], dim=-1)

    def real_time_upsampling(self, x: torch.Tensor, target_len: int | None = None) -> torch.Tensor:
        """Each frame repeated ``shrink_size`` times along T, cut to
        ``target_len``."""
        out = torch.repeat_interleave(x, self.shrink_size, dim=-1)
        return out[..., :target_len] if target_len else out

    def _masked_down_norm(self, bn_shrunk, bn_input, vt, s: int):
        """The offline norm of the bottleneck's downsampled units in a
        zero-padded, length-bucketed run, with the unpadded run's
        statistics (JAX ``_masked_down_norm``): that run downsamples ``vt``
        frames into 1 + n_full + (r > 0) blocks, the last a partial tail of
        r = (vt - 1) % s frames, which the padded run's framing never
        forms; its mean is rebuilt here from the frame-clock units
        ``bn_input`` [B, M, unit, T] (its square enters the Gaussian
        norm's sum of squares), and the statistics divide by the true
        block count. Blocks past n_full take the same statistics; they feed
        the causal bottleneck only after every block a real output needs.
        A causal norm is exact as it is."""
        if self.norm not in (offline_laplace_norm, offline_gaussian_norm):
            return self.norm(bn_shrunk)
        b, m, unit, t_down = bn_shrunk.shape
        t = bn_input.shape[-1]
        n_rest = vt - 1  # [b]
        n_full = torch.div(n_rest, s, rounding_mode="floor")
        r = n_rest % s
        has_tail = (r > 0).to(torch.float32)
        t_down_u = 1.0 + n_full.to(torch.float32) + has_tail  # [b]

        # blocks 0..n_full match the unpadded run (they read no pad frame)
        dm = (torch.arange(t_down, device=vt.device)[None, :] <= n_full[:, None])
        dm = dm.to(torch.float32)[:, None, None, :]
        # the unpadded run's partial tail block: the mean of the real frames
        # [1 + n_full·s, vt) of the frame-clock units
        frames = torch.arange(t, device=vt.device)[None, :]
        fmask = ((frames >= (1 + n_full * s)[:, None]) & (frames < vt[:, None])).to(torch.float32)
        r_safe = torch.clamp(r.to(torch.float32), min=1.0)
        tail = torch.sum(bn_input * fmask[:, None, None, :], dim=-1) / r_safe[:, None, None]
        tail = tail * has_tail[:, None, None]  # [B, M, unit]

        count = (m * unit) * t_down_u[:, None, None, None]
        total = (torch.sum(bn_shrunk * dm, dim=(1, 2, 3), keepdim=True)
                 + torch.sum(tail, dim=(1, 2), keepdim=True)[..., None])
        if self.norm is offline_laplace_norm:
            return laplace_norm_from_stats(bn_shrunk, total, count)
        sumsq = (torch.sum(torch.square(bn_shrunk) * dm, dim=(1, 2, 3), keepdim=True)
                 + torch.sum(torch.square(tail), dim=(1, 2), keepdim=True)[..., None])
        return gaussian_norm_from_stats(bn_shrunk, total, sumsq, count)

    def forward(
        self,
        mix_mag: torch.Tensor,
        dropping_band: bool = True,
        valid_frames: int | torch.Tensor | None = None,
    ) -> torch.Tensor:
        """mix_mag [B, 1, F, T] -> cRM [B, 2, F, T]. ``dropping_band`` is
        taken for the trainer's and inferencer's one calling convention;
        this model has no drop_band.

        ``valid_frames`` (a count, or a [B] tensor of counts) marks a
        zero-padded, length-bucketed input, as ``FullSubNet.forward`` takes
        it: the offline norm's statistics at both clocks (the mel frames,
        and the downsampled blocks with the unpadded run's partial tail)
        cover each row's true frames, so the real frames' outputs equal an
        unpadded run's. The caller zeroes the padded frames and discards
        the outputs past them."""
        del dropping_band
        if mix_mag.ndim != 4:
            raise ValueError(f"mix_mag must be [B, 1, F, T], got {tuple(mix_mag.shape)}")
        x = F.pad(mix_mag, (0, self.look_ahead))
        batch_size, num_channels, num_freqs, num_frames = x.shape
        if num_channels != 1:
            raise ValueError("FastFullSubNet takes a magnitude feature.")

        vt = frame_mask = None
        norm = self.norm
        if valid_frames is not None:
            vt = torch.as_tensor(valid_frames, device=x.device).reshape(-1) + self.look_ahead
            frame_mask = (torch.arange(num_frames, device=x.device)[None, :] < vt[:, None])
            valid_total = vt.to(torch.float32)[:, None, None, None]
            # causal norms return None: zero-padded tails leave them exact
            norm = masked_offline_norm(self.norm, valid_total) or norm

        # the mel projection [B, C, F, T] -> [B, C, M, T], promoted to the
        # filterbank's dtype as jnp.einsum promotes
        fb = self.mel_scale.fb
        mix_mel = torch.einsum("bcft,fm->bcmt", x.to(torch.promote_types(x.dtype, fb.dtype)), fb)

        # F_l2m
        enc = norm(mix_mel).reshape(batch_size, -1, num_frames)
        enc = self.encoder[1](self.encoder[0](enc))
        enc_output = enc.reshape(batch_size, num_channels, -1, num_frames)
        if frame_mask is not None:
            # the pad frames' encoder outputs would reach the downsampled
            # blocks and the bottleneck's statistics
            enc_output = enc_output * frame_mask.to(enc_output.dtype)[:, None, None, :]

        # the noisy mel and the encoder output unfolded into sub-band units
        mix_unfold = freq_unfold(mix_mel, self.noisy_input_num_neighbors).reshape(
            batch_size, self.num_mels, self.noisy_input_num_neighbors * 2 + 1, num_frames
        )
        enc_unfold = freq_unfold(enc_output, self.enc_output_num_neighbors).reshape(
            batch_size, self.num_mels, self.enc_output_num_neighbors * 2 + 1, num_frames
        )
        bn_input = torch.cat([mix_unfold, enc_unfold], dim=2)
        unit = bn_input.shape[2]

        # the bottleneck, on the time-downsampled units
        bn_shrunk = self.real_time_downsampling(bn_input)
        if vt is not None:
            bn_shrunk = self._masked_down_norm(bn_shrunk, bn_input, vt, self.shrink_size)
        else:
            bn_shrunk = self.norm(bn_shrunk)
        bn_out = self.bottleneck(bn_shrunk.reshape(batch_size * self.num_mels, unit, -1))
        bn_out = bn_out.reshape(batch_size, self.num_mels, 1, -1).permute(0, 2, 1, 3)
        bn_out = self.real_time_upsampling(bn_out, target_len=num_frames)  # [B, 1, M, T]

        # F_m2l
        dec_input = torch.cat([enc_output, bn_out], dim=2).reshape(batch_size, -1, num_frames)
        dec = self.decoder_lstm[1](self.decoder_lstm[0](dec_input))
        dec_output = dec.reshape(batch_size, 2, num_freqs, num_frames)
        return dec_output[..., self.look_ahead :]
