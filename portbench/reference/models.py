"""FullSubNet (Hao et al., ICASSP 2021, arXiv:2010.15508) and Fast
FullSubNet (Hao and Li, arXiv:2212.09019) in plain PyTorch, written from
the published models (Audio-WestlakeU/FullSubNet,
``recipes/dns_interspeech_2020/{fullsubnet,fast_fullsubnet}/model.py``).

Weights are a flat dict under the published state-dict keys
(``<stack>.sequence_model.weight_ih_l0``, ``<stack>.fc_output_layer.weight``,
``mel_scale.fb``). Every LSTM is unrolled step by step, PyTorch's gate order
(i, f, g, o), each product through ``precision.matmul``. Only what the
recipes use is written: LSTM cells, the offline Laplace norm.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from portbench.reference import dsp
from portbench.reference.precision import matmul

FAMILIES = ("fullsubnet", "fast_fullsubnet")


@dataclass(frozen=True)
class Stack:
    """One LSTM stack with its optional Linear head (``out`` 0: none)."""

    prefix: str
    f_in: int
    hidden: int
    layers: int
    out: int
    act: str | None


def _check(args: dict) -> None:
    if args.get("sequence_model", "LSTM") != "LSTM":
        raise NotImplementedError("the reference writes the LSTM cell only")
    if args.get("norm_type", "offline_laplace_norm") != "offline_laplace_norm":
        raise NotImplementedError("the reference writes the offline Laplace norm only")


def stacks(family: str, args: dict) -> list[Stack]:
    """The stacks of ``family`` built from its ``[model.args]``, in the
    order the forward runs them."""
    _check(args)
    if family == "fullsubnet":
        f = args["num_freqs"]
        unit = 2 * args["sb_num_neighbors"] + 1 + 2 * args["fb_num_neighbors"] + 1
        act = lambda key: args.get(key) or None  # noqa: E731  (TOML's false: none)
        return [Stack("fb_model", f, args["fb_model_hidden_size"], 2, f,
                      act("fb_output_activate_function")),
                Stack("sb_model", unit, args["sb_model_hidden_size"], 2, 2,
                      act("sb_output_activate_function"))]
    if family == "fast_fullsubnet":
        m, f = args["num_mels"], args["encoder_input_size"]
        unit = 2 * args["noisy_input_num_neighbors"] + 1 + 2 * args["encoder_output_num_neighbors"] + 1
        return [Stack("encoder.0", m, 384, 1, 0, None),
                Stack("encoder.1", 384, 257, 1, m, "ReLU"),
                Stack("bottleneck", unit, args["bottleneck_hidden_size"],
                      args["bottleneck_num_layers"], 1, "ReLU"),
                Stack("decoder_lstm.0", 2 * m, 512, 1, 0, None),
                Stack("decoder_lstm.1", 512, 512, 1, 2 * f, None)]
    raise ValueError(f"no reference for {family!r}")


def weight_shapes(family: str, args: dict) -> dict[str, tuple[tuple[int, ...], float]]:
    """Every trained tensor's (shape, bound): PyTorch's default init draws
    it from U(-bound, bound), bound = 1 / sqrt(the stack's hidden size)."""
    out = {}
    for st in stacks(family, args):
        bound = st.hidden ** -0.5
        for k in range(st.layers):
            f_in = st.f_in if k == 0 else st.hidden
            for name, shape in ((f"weight_ih_l{k}", (4 * st.hidden, f_in)),
                                (f"weight_hh_l{k}", (4 * st.hidden, st.hidden)),
                                (f"bias_ih_l{k}", (4 * st.hidden,)),
                                (f"bias_hh_l{k}", (4 * st.hidden,))):
                out[f"{st.prefix}.sequence_model.{name}"] = shape, bound
        if st.out:
            out[f"{st.prefix}.fc_output_layer.weight"] = (st.out, st.hidden), bound
            out[f"{st.prefix}.fc_output_layer.bias"] = (st.out,), bound
    return out


def buffers(family: str, args: dict, sr: int) -> dict[str, torch.Tensor]:
    """The model's fixed tensors: Fast FullSubNet's mel filterbank."""
    if family == "fast_fullsubnet":
        return {"mel_scale.fb": dsp.mel_filterbank(args["encoder_input_size"], args["num_mels"], sr)}
    return {}


_ACT = {None: lambda x: x, "ReLU": torch.relu, "Tanh": torch.tanh}


def run_stack(w: dict, st: Stack, x: torch.Tensor, precision: str) -> torch.Tensor:
    """x [N, T, f_in] -> [N, T, out] (the head and its activation applied),
    or the top layer's h [N, T, H] for a stack without a head."""
    p = f"{st.prefix}.sequence_model."
    layers = [(w[f"{p}weight_ih_l{k}"].T, w[f"{p}weight_hh_l{k}"].T,
               w[f"{p}bias_ih_l{k}"] + w[f"{p}bias_hh_l{k}"]) for k in range(st.layers)]
    head = ((w[f"{st.prefix}.fc_output_layer.weight"].T, w[f"{st.prefix}.fc_output_layer.bias"])
            if st.out else None)
    n, t, _ = x.shape
    h = [x.new_zeros(n, st.hidden) for _ in layers]
    c = [x.new_zeros(n, st.hidden) for _ in layers]
    outs = []
    for s in range(t):
        inp = x[:, s]
        for k, (w_ih, w_hh, b) in enumerate(layers):
            gates = matmul(inp, w_ih, precision) + matmul(h[k], w_hh, precision) + b
            i, f, g, o = gates.chunk(4, dim=1)
            c[k] = torch.sigmoid(f) * c[k] + torch.sigmoid(i) * torch.tanh(g)
            h[k] = inp = torch.sigmoid(o) * torch.tanh(c[k])
        if head is not None:
            inp = _ACT[st.act](matmul(inp, head[0], precision) + head[1])
        outs.append(inp)
    return torch.stack(outs, dim=1)


def fullsubnet(w: dict, args: dict, mag: torch.Tensor, drop: bool, precision: str) -> torch.Tensor:
    """mag [B, 1, F, T] -> cRM [B, 2, F', T] (F' = F // G under drop_band)."""
    fb_st, sb_st = stacks("fullsubnet", args)
    look_ahead, groups = args["look_ahead"], args["num_groups_in_drop_band"]
    x = F.pad(mag, (0, look_ahead))
    b, _, f, t = x.shape
    fb_out = run_stack(w, fb_st, dsp.laplace_norm(x)[:, 0].transpose(1, 2), precision)
    fb_out = fb_out.transpose(1, 2)[:, None]  # [B, 1, F, T]
    sb_in = dsp.laplace_norm(torch.cat([dsp.unfold(x, args["sb_num_neighbors"]),
                                        dsp.unfold(fb_out, args["fb_num_neighbors"])], dim=2))
    if drop:
        sb_in = dsp.drop_band(sb_in.transpose(1, 2), groups).transpose(1, 2)
        f = sb_in.shape[1]
    rows = sb_in.reshape(b * f, sb_st.f_in, t).transpose(1, 2)
    crm = run_stack(w, sb_st, rows, precision).reshape(b, f, t, 2).permute(0, 3, 1, 2)
    return crm[..., look_ahead:]


def _downsample(x: torch.Tensor, shrink: int) -> torch.Tensor:
    """Frame 0, then the mean of each block of ``shrink`` frames (the last
    block what is left)."""
    blocks = torch.split(x[..., 1:], shrink, dim=-1)
    return torch.cat([x[..., 0:1]] + [blk.mean(dim=-1, keepdim=True) for blk in blocks], dim=-1)


def fast_fullsubnet(w: dict, args: dict, mag: torch.Tensor, precision: str) -> torch.Tensor:
    """mag [B, 1, F, T] -> cRM [B, 2, F, T]."""
    enc0, enc1, bottleneck, dec0, dec1 = stacks("fast_fullsubnet", args)
    look_ahead, shrink, m = args["look_ahead"], args["shrink_size"], args["num_mels"]
    x = F.pad(mag, (0, look_ahead))
    b, _, f, t = x.shape
    mel = matmul(x[:, 0].transpose(1, 2).reshape(b * t, f), w["mel_scale.fb"], precision)
    mel = mel.reshape(b, t, m).transpose(1, 2)[:, None]  # [B, 1, M, T]
    enc = run_stack(w, enc0, dsp.laplace_norm(mel)[:, 0].transpose(1, 2), precision)
    enc_out = run_stack(w, enc1, enc, precision).transpose(1, 2)[:, None]  # [B, 1, M, T]
    units = torch.cat([dsp.unfold(mel, args["noisy_input_num_neighbors"]),
                       dsp.unfold(enc_out, args["encoder_output_num_neighbors"])], dim=2)
    shrunk = dsp.laplace_norm(_downsample(units, shrink))  # [B, M, unit, T']
    bn = run_stack(w, bottleneck, shrunk.reshape(b * m, units.shape[2], -1).transpose(1, 2),
                   precision)  # [B·M, T', 1]
    bn = bn.reshape(b, m, -1)[:, None].repeat_interleave(shrink, dim=-1)[..., :t]
    dec_in = torch.cat([enc_out, bn], dim=2)[:, 0].transpose(1, 2)  # [B, T, 2M]
    dec = run_stack(w, dec1, run_stack(w, dec0, dec_in, precision), precision)
    return dec.transpose(1, 2).reshape(b, 2, f, t)[..., look_ahead:]


def forward(family: str, w: dict, args: dict, mag: torch.Tensor, drop: bool,
            precision: str) -> torch.Tensor:
    """The family's cRM of a magnitude [B, 1, F, T]; ``drop``: the training
    forward's drop_band (FullSubNet only)."""
    if family == "fullsubnet":
        return fullsubnet(w, args, mag, drop, precision)
    return fast_fullsubnet(w, args, mag, precision)


def drop_groups(family: str, args: dict, batch: int) -> int:
    """drop_band's group count in a training batch of ``batch`` rows, 1
    where it does not apply (more than one group, more rows than groups)."""
    groups = args.get("num_groups_in_drop_band", 1) if family == "fullsubnet" else 1
    return groups if groups > 1 and batch > groups else 1
