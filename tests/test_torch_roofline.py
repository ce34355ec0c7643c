"""The port's analytic counts (``fullsubnet_tpu_torch/roofline.py``) against
the JAX package's (``fullsubnet_tpu/roofline.py``) for every model family,
each model built from its recipe's ``[model]`` section at small widths in
both packages (the JAX models without their init: the counts read only
the stacks' attributes); the kernel helpers the smoke's bound column reads;
and the device-dependent parts on the CPU."""

import numpy as np
import pytest
import torch

from fullsubnet_tpu import roofline as jax_roofline
from fullsubnet_tpu.config import build_model as jax_build_model
from fullsubnet_tpu_torch import roofline
from fullsubnet_tpu_torch.config import build_model

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

SMALL_FULLSUBNET = dict(num_freqs=33, look_ahead=2, fb_num_neighbors=0, sb_num_neighbors=3,
                        fb_output_activate_function="ReLU", sb_output_activate_function=False,
                        fb_model_hidden_size=16, sb_model_hidden_size=8,
                        num_groups_in_drop_band=2)
FAMILIES = {
    "FullSubNet LSTM": ("fullsubnet", dict(SMALL_FULLSUBNET, sequence_model="LSTM")),
    "FullSubNet GRU": ("fullsubnet", dict(SMALL_FULLSUBNET, sequence_model="GRU")),
    "full-band baseline": ("fullband_baseline.model.Model",
                           dict(num_freqs=33, look_ahead=2, sequence_model="LSTM",
                                output_activate_function=False, hidden_size=16)),
    "sub-band baseline": ("subband_baseline.model.Model",
                          dict(num_neighbors=15, look_ahead=2, sequence_model="GRU",
                               hidden_size=12, num_layers=2, output_activate_function=False,
                               num_groups_in_drop_band=2)),
    "Fast FullSubNet": ("fast_fullsubnet.model.Model",
                        dict(look_ahead=2, shrink_size=3, sequence_model="LSTM", num_mels=8,
                             encoder_input_size=33, bottleneck_hidden_size=12,
                             bottleneck_num_layers=2, noisy_input_num_neighbors=5,
                             encoder_output_num_neighbors=0)),
    "Improved 16 kHz": ("improved_fullsubnet.model.Model",
                        dict(n_fft=512, hop_length=128, win_length=512, num_freqs=257,
                             freq_cutoffs=[20, 80], sb_num_center_freqs=[1, 4, 8],
                             sb_num_neighbor_freqs=[15, 15, 15], fb_num_center_freqs=[1, 4, 8],
                             fb_num_neighbor_freqs=[15, 15, 15], fb_hidden_size=16,
                             sb_hidden_size=8, sequence_model="LSTM",
                             fb_output_activate_function=False,
                             sb_output_activate_function=False)),
    "Improved 48 kHz": ("improved_fullsubnet.model.Model",
                        dict(n_fft=960, hop_length=480, win_length=960, num_freqs=481,
                             freq_cutoffs=[20, 120, 240], sb_num_center_freqs=[1, 4, 20, 60],
                             sb_num_neighbor_freqs=[15, 15, 15, 15],
                             fb_num_center_freqs=[1, 4, 20, 60],
                             fb_num_neighbor_freqs=[15, 15, 15, 15], fb_hidden_size=16,
                             sb_hidden_size=8, sequence_model="GRU",
                             fb_output_activate_function=False,
                             sb_output_activate_function=False)),
}


def _models(family):
    path, args = FAMILIES[family]
    port, _ = build_model({"model": {"path": path, "args": dict(args)}})
    jax, _ = jax_build_model({"model": {"path": path, "args": dict(args)}})
    return port, jax


@pytest.mark.parametrize("drop_groups", [1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_counts_equal_the_jax_modules(family, drop_groups):
    port, jax = _models(family)
    for batch, frames in ((1, 9), (3, 40)):
        assert (roofline.model_fwd_flops(port, batch, frames, drop_groups)
                == jax_roofline.model_fwd_flops(jax, batch, frames, drop_groups) > 0)
        for itemsize in (2, 4):
            assert (roofline.model_min_bytes(port, batch, frames, itemsize, drop_groups)
                    == jax_roofline.model_min_bytes(jax, batch, frames, itemsize, drop_groups)
                    > 0)
    stages = list(roofline._stages(port, 3, 40, drop_groups))
    jax_stages = list(jax_roofline._stages(jax, 3, 40, drop_groups))
    assert [(r, s) for _, r, s in stages] == [(r, s) for _, r, s in jax_stages]
    for (sm, r, s), (jsm, _, _) in zip(stages, jax_stages, strict=True):
        assert roofline.seq_model_flops(sm, r, s) == jax_roofline.seq_model_flops(jsm, r, s)
        assert (roofline.seq_model_io_elems(sm, r, s)
                == jax_roofline.seq_model_io_elems(jsm, r, s))


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="no analytic FLOPs model for Linear"):
        roofline.model_fwd_flops(torch.nn.Linear(2, 2), 1, 1)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_stack_helpers_count_the_flagship_stacks(cell):
    """``stack_flops`` (the smoke's per-kernel count) equals
    ``seq_model_flops`` at the flagship's two stacks; ``walk_flops`` is
    their recurrent share, ``layer_bwd_flops`` three times the gate GEMMs."""
    model, _ = build_model({"model": {"path": "fullsubnet", "args": {"sequence_model": cell}}})
    c = cell.lower()
    for sm, out_dim, f_in, hidden in ((model.fb_model, 257, 257, 512),
                                      (model.sb_model, 2, 32, 384)):
        assert (sm.input_size, sm.hidden_size, sm.output_size) == (f_in, hidden, out_dim)
        assert (roofline.stack_flops(195, 4096, f_in, hidden, out_dim, cell=c)
                == roofline.seq_model_flops(sm, 4096, 195))
        g = roofline.GATES[c]
        head = 2 * hidden * out_dim * 195 * 4096
        assert (roofline.walk_flops(195, 4096, hidden, cell=c)
                == 2 * 2 * 195 * 4096 * hidden * g * hidden)
        assert (roofline.layer_bwd_flops(195, 4096, f_in, hidden, cell=c)
                == 3 * (roofline.stack_flops(195, 4096, f_in, hidden, out_dim, cell=c) - head))
        params = roofline._param_count(sm)
        # the kernels' operands fuse the LSTM's two biases
        fused = (2 if c == "lstm" else 0) * g * hidden
        assert roofline.weight_elems(f_in, hidden, out_dim, cell=c) == params - fused


def test_bound_reproduces_the_kernel_tables_rows():
    """PERF.md's bound column: K1 at N=257, T=400 (fp32), 5.58 ms, and
    K1-bf16's flagship row, 0.3782 ms."""
    t, n, f_in, hidden, out_dim = 400, 257, 32, 384, 2
    nbytes = 4 * (t * n * f_in + roofline.weight_elems(f_in, hidden, out_dim) + t * n * out_dim)
    ms, by = roofline.bound(roofline.stack_flops(t, n, f_in, hidden, out_dim), nbytes, "fp32")
    assert (round(ms, 2), by) == (5.58, "operations")
    flops = roofline.stack_flops(t, n, f_in, hidden, out_dim)
    nbytes = (2 * (t * n * f_in + roofline.weight_elems(f_in, hidden, out_dim))
              + 4 * t * n * out_dim)
    assert round(roofline.bound(flops, nbytes, "bf16")[0], 4) == 0.3782
    assert roofline.bound(0, 3.35e9, "bf16") == (1.0, "bytes")
    assert roofline.gemm_flops(3, 5, 7) == 210


def test_device_parts_on_the_cpu(monkeypatch):
    """No card: no peaks and no fields (a share of a guessed peak is
    noise). With the H100's peaks the fields are the counts over the time:
    three times the FLOPs and twice the bytes for a training step."""
    port, _ = _models("FullSubNet LSTM")
    assert roofline.device_peaks() is None
    assert roofline.roofline_fields(port, 2, 50, 0.01) == {}
    monkeypatch.setattr(roofline, "device_peaks",
                        lambda: dict(roofline.H100_PEAKS, device_kind="NVIDIA H100 80GB HBM3"))
    assert roofline.roofline_fields(port, 2, 50, 0.0) == {}
    fwd = roofline.roofline_fields(port, 2, 50, 0.01)
    flops = roofline.model_fwd_flops(port, 2, 50)
    nbytes = roofline.model_min_bytes(port, 2, 50)
    np.testing.assert_allclose(fwd["mfu"], flops / 989e12 / 0.01, rtol=1e-12)
    np.testing.assert_allclose(fwd["hbm_bw_util_lb"], nbytes / 3.35e12 / 0.01, rtol=1e-12)
    assert fwd["roofline_ratio"] == max(fwd["mfu"], fwd["hbm_bw_util_lb"])
    assert (fwd["analytic_tflops"], fwd["peak_tflops"]) == (flops / 1e12, 989.0)
    step = roofline.roofline_fields(port, 2, 50, 0.01, train=True, drop_groups=2)
    np.testing.assert_allclose(
        step["mfu"], 3 * roofline.model_fwd_flops(port, 2, 50, 2) / 989e12 / 0.01, rtol=1e-12)
    np.testing.assert_allclose(
        step["hbm_bw_util_lb"], 2 * roofline.model_min_bytes(port, 2, 50, drop_groups=2)
        / 3.35e12 / 0.01, rtol=1e-12)
