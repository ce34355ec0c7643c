"""FullSubNet — the flagship full-band + sub-band fusion model
(counterpart of ``fullsubnet_tpu/models/fullsubnet.py``).

The unfused forward: pad the look-ahead frames, normalise, run the
full-band stage over B rows of F features, unfold the magnitude and the
full-band output along frequency, normalise again, drop bands (training
batches), and run ONE shared sub-band stage batched over all its rows.
Both stages run through the fused scan op, with the LSTM cell or the GRU
cell (``sequence_model``): on a CUDA tensor K1 or K1-GRU at inference,
K2 and K3 or K2-GRU and K4 under autograd.

``valid_frames`` takes length-bucketed inputs: zero-padded batches whose
rows have their own true frame counts.

The fused sub-band stage (the JAX package's ``_fused_subband_stage`` and
``_pallas_subband``) takes the forward where the JAX package's gate does:
the norm is offline or cumulative Laplace, the sub-band stack has no
activation, and the model trains (autograd records the call) or, without
drop_band, the unfold would pass ``_FUSED_SB_THRESHOLD`` elements. It
builds the normalised sub-band input once, straight from the
reflect-padded spectra, in the op's [T, B·F', unit] layout and the input's
type: the norm's statistics without the unfold (``_sb_norm_mu``), drop_band
as group-strided views (``_group_rows``, ``_unit_view``), then one copy and
one division. Its stack call passes the sub-band stage's share of the card
(``_TRAIN_STASH_SHARE``), above which the op chunks its stash over time.
Not ported: the JAX package's row groups, its remat'd-scan fallback and its
mesh hooks, which are v5e capacity and TPU-mesh logic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fullsubnet_tpu_torch.acoustics.feature import drop_band, drops_band, freq_unfold
from fullsubnet_tpu_torch.acoustics.norm import (
    cumulative_laplace_norm,
    masked_offline_norm,
    norm_wrapper,
    offline_laplace_norm,
)
from fullsubnet_tpu_torch.constant import EPSILON
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel
from fullsubnet_tpu_torch.ops.subband_lstm import fused_subband_lstm, stash_budget_bytes

# the norms whose statistics the fused sub-band stage computes without the
# unfold (the JAX package's ``_norms_fusable``)
FUSABLE_NORMS = (offline_laplace_norm, cumulative_laplace_norm)


def _unit_view(arr_pad: torch.Tensor, num_neighbors: int, group: int, groups: int,
               bands: int) -> torch.Tensor:
    """The unfold of a reflect-padded source [B', F + 2n, T] as a view
    [T, B', bands, 2n + 1]: band k's unit u reads padded bin group + k·groups
    + u (drop_band's group-strided selection; every bin with one group), as
    the JAX package's ``_unit_slices`` slices it."""
    units = arr_pad.permute(2, 0, 1).unfold(2, 2 * num_neighbors + 1, 1)
    return units[:, :, group : group + (bands - 1) * groups + 1 : groups]


class FullSubNet(nn.Module):
    # above this many unfolded elements (B·F·(2N+1)·T) inference takes the
    # fused sub-band stage, which never builds the [B, F, 2N+1, T] unfold
    _FUSED_SB_THRESHOLD = 2**28
    # the share of the card's memory the sub-band stage's training call may
    # hold before the op chunks its stash over time: the JAX package's 10.5
    # GiB of a 16 GiB v5e (``_PALLAS_TRAIN_STASH_BUDGET``): the one stage
    # whose stash may own most of the card
    _TRAIN_STASH_SHARE = 10.5 / 16
    # the sub-band stage's time chunk in training: None lets the share above
    # pick it; an int forces the op's ``time_chunk`` (0: the full stash)
    subband_time_chunk: int | None = None

    def __init__(
        self,
        num_freqs: int = 257,
        look_ahead: int = 2,
        sequence_model: str = "LSTM",
        fb_num_neighbors: int = 0,
        sb_num_neighbors: int = 15,
        fb_output_activate_function: str | None = "ReLU",
        sb_output_activate_function: str | None = None,
        fb_model_hidden_size: int = 512,
        sb_model_hidden_size: int = 384,
        norm_type: str = "offline_laplace_norm",
        num_groups_in_drop_band: int = 2,
        generator: torch.Generator | None = None,
    ):
        """``num_groups_in_drop_band`` is drop_band's group count (see
        ``forward``). ``generator`` seeds the random initial weights
        (default: a generator seeded with 0)."""
        super().__init__()
        if sequence_model not in ("GRU", "LSTM"):
            raise ValueError("FullSubNet only supports GRU and LSTM.")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_freqs = num_freqs
        self.look_ahead = look_ahead
        self.fb_num_neighbors = fb_num_neighbors
        self.sb_num_neighbors = sb_num_neighbors
        self.num_groups_in_drop_band = num_groups_in_drop_band
        self.norm = norm_wrapper(norm_type)

        self.fb_model = SequenceModel(
            input_size=num_freqs,
            output_size=num_freqs,
            hidden_size=fb_model_hidden_size,
            num_layers=2,
            bidirectional=False,
            sequence_model=sequence_model,
            output_activate_function=fb_output_activate_function,
            generator=generator,
        )
        self.sb_model = SequenceModel(
            input_size=(sb_num_neighbors * 2 + 1) + (fb_num_neighbors * 2 + 1),
            output_size=2,
            hidden_size=sb_model_hidden_size,
            num_layers=2,
            bidirectional=False,
            sequence_model=sequence_model,
            output_activate_function=sb_output_activate_function,
            generator=generator,
        )

    def forward(
        self,
        noisy_mag: torch.Tensor,
        dropping_band: bool = True,
        valid_frames: int | torch.Tensor | None = None,
        band_rows: tuple[int, int] | None = None,
    ) -> torch.Tensor:
        """noisy_mag [B, 1, F, T] -> cRM [B, 2, F', T].

        F' = F unless drop_band applies: ``dropping_band`` and
        ``B > num_groups_in_drop_band > 1``, the JAX package's gate. Then
        the sub-band stage sees only F // G frequencies per sample, group
        by group, and F' = F // G (samples regrouped group-major), as in
        training. Inference passes ``dropping_band=False``.
        ``band_rows`` = (row offset, batch rows) says that these B rows are
        a slice of a larger training batch (a rank's share of a microbatch):
        the gate and each row's group are then that batch's
        (``acoustics.feature.drop_band``).

        ``valid_frames`` (a count, or a [B] tensor of counts) marks a
        zero-padded, length-bucketed input: row b's first
        ``valid_frames[b]`` frames are real, and its output there equals
        an unpadded run's. The caller zeroes the padded frames and
        discards the outputs past them. The offline norm takes the true
        count, including the model's own look-ahead frames; the full-band
        output is zeroed past them before the sub-band norm. Such calls
        are inference-shaped: drop_band must not apply.
        """
        if noisy_mag.ndim != 4:
            raise ValueError(f"noisy_mag must be [B, 1, F, T], got {tuple(noisy_mag.shape)}")
        x = F.pad(noisy_mag, (0, self.look_ahead))
        batch_size, num_channels, num_freqs, num_frames = x.shape
        if num_channels != 1:
            raise ValueError("FullSubNet takes the mag feature as input.")
        groups = self.num_groups_in_drop_band
        drop = dropping_band and drops_band(batch_size, groups, band_rows)

        norm, frame_mask, real = self.norm, None, None
        if valid_frames is not None:
            if drop:
                raise ValueError("valid_frames calls are inference-shaped: pass dropping_band=False")
            real = torch.as_tensor(valid_frames, device=x.device).reshape(-1) + self.look_ahead
            frame_mask = (torch.arange(num_frames, device=x.device) < real[:, None]).to(x.dtype)
            # causal norms return None: zero-padded tails leave them exact
            norm = masked_offline_norm(self.norm, real.to(torch.float32)[:, None, None, None]) or norm

        # Full-band stage
        fb_input = norm(x).reshape(batch_size, num_freqs, num_frames)
        fb_output = self.fb_model(fb_input).reshape(batch_size, 1, num_freqs, num_frames)
        if frame_mask is not None:
            # the padded frames' outputs (the biases) would reach the
            # sub-band norm's statistics
            fb_output = fb_output * frame_mask[:, None, None, :]

        fb_unit = self.fb_num_neighbors * 2 + 1
        sb_unit = self.sb_num_neighbors * 2 + 1
        # the JAX package's gate: the fused stage for every training step
        # and for big inference batches, where its norm is fusable
        fusable = (not self.sb_model.output_activate_function
                   and self.norm in FUSABLE_NORMS
                   and (not drop or batch_size % groups == 0))
        training = torch.is_grad_enabled() and (
            fb_output.requires_grad or any(p.requires_grad for p in self.sb_model.parameters()))
        unfold_elems = batch_size * num_freqs * (sb_unit + fb_unit) * num_frames
        if fusable and (training or (not drop and unfold_elems > self._FUSED_SB_THRESHOLD)):
            sb_mask = self._fused_subband_stage(
                x, fb_output, groups if drop else 1, band_rows,
                None if real is None else real.to(torch.float32))
            return sb_mask[..., self.look_ahead :]

        # Unfold: [B, F, fb_unit, T] and [B, F, sb_unit, T]
        fb_unfolded = freq_unfold(fb_output, self.fb_num_neighbors).reshape(
            batch_size, num_freqs, fb_unit, num_frames
        )
        noisy_unfolded = freq_unfold(x, self.sb_num_neighbors).reshape(
            batch_size, num_freqs, sb_unit, num_frames
        )
        sb_input = norm(torch.cat([noisy_unfolded, fb_unfolded], dim=2))
        if drop:
            # drop after the full-spectrum norm, as the reference does
            sb_input = drop_band(sb_input.transpose(1, 2), groups, band_rows).transpose(1, 2)
            num_freqs = sb_input.shape[1]
        sb_input = sb_input.reshape(batch_size * num_freqs, sb_unit + fb_unit, num_frames)

        # One shared sub-band stack batched over all frequencies
        sb_mask = self.sb_model(sb_input)  # [B*F, 2, T]
        sb_mask = sb_mask.reshape(batch_size, num_freqs, 2, num_frames).permute(0, 2, 1, 3)
        return sb_mask[..., self.look_ahead :]

    # ------------------------------------------------------------------
    # the fused sub-band stage
    # ------------------------------------------------------------------

    def _sb_norm_mu(self, noisy_pad, fb_pad, f: int, valid_total_frames=None):
        """The sub-band norm's mean without the unfold, fp32, as the JAX
        package's ``_sb_norm_mu``: noisy_pad [B, F + 2N_sb, T] and fb_pad
        [B, F + 2N_fb, T] the reflect-padded sources. Offline Laplace: each
        source's unfold sum is its bins' sum weighted by the windows each bin
        falls in, over F·unit·T (T the true frame count per row where
        ``valid_total_frames`` [b] is given: the sources are zero past it)
        -> [B]. Cumulative Laplace: per (row, band) the running mean of the
        unit's sums over time -> [B, F, T]. Differentiable, so the gradient
        reaches the full-band stage through it, as through the unfused
        norm's mean."""
        n_sb, n_fb = self.sb_num_neighbors, self.fb_num_neighbors
        unit = (2 * n_sb + 1) + (2 * n_fb + 1)
        t = noisy_pad.shape[-1]
        sources = ((noisy_pad, n_sb), (fb_pad, n_fb))
        if self.norm is offline_laplace_norm:
            total = 0.0
            for arr, n in sources:
                # padded bin i falls in the windows u = max(0, i - f + 1) ..
                # min(2n, i); counted on the device, so no host copy waits
                # for the card's queue
                i = torch.arange(arr.shape[1], device=arr.device)
                counts = (i.clamp(max=2 * n) - (i - f + 1).clamp(min=0) + 1).float()
                bins = arr.sum(dim=2, dtype=torch.float32)  # [B, F + 2n]
                total = total + (bins * counts).sum(dim=1)
            frames = t if valid_total_frames is None else valid_total_frames
            return total / (f * unit * frames) + 1e-5  # [B]
        unit_sum = sum(arr.unfold(1, 2 * n + 1, 1).sum(dim=-1, dtype=torch.float32)
                       for arr, n in sources)  # [B, F, T]
        counts_t = torch.arange(unit, unit * t + 1, unit, dtype=torch.float32,
                                device=noisy_pad.device)
        return torch.cumsum(unit_sum, dim=-1) / counts_t + EPSILON

    @staticmethod
    def _group_rows(group: int, groups: int, rows: int, band_rows) -> slice:
        """The rows of drop_band's group ``group`` among ``rows`` (the JAX
        package's ``_group_selection``): a row's group is its index in its
        batch modulo G, the batch being ``band_rows`` = (row offset, rows)
        where these rows are a slice of one (``acoustics.feature.drop_band``;
        JAX takes the local index)."""
        offset = 0 if band_rows is None else band_rows[0]
        return slice((group - offset) % groups, rows, groups)

    def _subband_input(self, noisy_pad, fb_pad, f: int, mu, groups: int, band_rows):
        """The normalised sub-band input [T, B·F', unit] in the sources' type,
        F' = F // G: per drop_band group (one without it) its rows' bands
        as views of both padded sources (``_unit_view``), joined into one
        tensor group-major (drop_band's row order), then divided by mu, the
        rows' and bands' own."""
        b, _, t = noisy_pad.shape
        bands = f // groups
        pieces, mus = [], []
        for g in range(groups):
            rows = self._group_rows(g, groups, b, band_rows)
            views = [_unit_view(arr[rows], n, g, groups, bands) for arr, n in
                     ((noisy_pad, self.sb_num_neighbors), (fb_pad, self.fb_num_neighbors))]
            pieces.append(torch.cat(views, dim=-1))  # [T, B/G, F', unit]
            mus.append(mu[rows] if mu.ndim == 1 else mu[rows, g : g + (bands - 1) * groups + 1 :
                                                      groups])
        sb_in = pieces[0] if groups == 1 else torch.cat(pieces, dim=1)  # [T, B, F', unit]
        del pieces
        mu = mus[0] if groups == 1 else torch.cat(mus)
        mu = mu[None, :, None, None] if mu.ndim == 1 else mu.permute(2, 0, 1)[..., None]
        sb_in = sb_in.div_(mu.to(sb_in.dtype))
        return sb_in.reshape(t, b * bands, sb_in.shape[-1])

    def _kernel_subband(self, noisy_pad, fb_pad, f: int, mu, groups: int = 1, band_rows=None,
                        time_chunk: int | None = None):
        """The sub-band stage on the fused input (the JAX package's
        ``_pallas_subband`` without row groups or mesh hooks): the stack over
        ``_subband_input``'s [T, B·F', unit] rows, under the stage's share of
        the card (or ``time_chunk``) -> [B, 2, F', T] float32."""
        b, _, t = noisy_pad.shape
        sb_in = self._subband_input(noisy_pad, fb_pad, f, mu, groups, band_rows)
        sbm = self.sb_model
        out = fused_subband_lstm(
            sb_in, *sbm.sequence_model.layers(), sbm._head(),
            stash_budget=stash_budget_bytes(self._TRAIN_STASH_SHARE, sb_in.device),
            time_chunk=time_chunk,
        )  # [T, B·F', 2]
        return out.reshape(t, b, f // groups, -1).permute(1, 3, 2, 0)

    def _fused_subband_stage(self, x, fb_output, groups: int = 1, band_rows=None,
                             valid_total_frames=None):
        """The fused sub-band stage: x and fb_output [B, 1, F, T] (the
        look-ahead frames included) reflect-padded along frequency, the
        norm's mean from them (``_sb_norm_mu``), then ``_kernel_subband``
        with drop_band's ``groups`` (1: none) -> [B, 2, F // groups, T]."""
        f = x.shape[2]
        n_sb, n_fb = self.sb_num_neighbors, self.fb_num_neighbors
        noisy_pad = F.pad(x[:, 0], (0, 0, n_sb, n_sb), mode="reflect")
        fb_pad = fb_output[:, 0]
        if n_fb > 0:
            fb_pad = F.pad(fb_pad, (0, 0, n_fb, n_fb), mode="reflect")
        mu = self._sb_norm_mu(noisy_pad, fb_pad, f, valid_total_frames)
        return self._kernel_subband(noisy_pad, fb_pad, f, mu, groups, band_rows,
                                    self.subband_time_chunk)
