"""The port's ``weight_init`` (fullsubnet_tpu_torch.nn.init) and the mel
filterbank (fullsubnet_tpu_torch.acoustics.filterbank). The draws come
from a ``torch.Generator`` and cannot equal ``jax.random``'s, so the
initialisers are held to their properties: orthogonality, the Xavier
standard deviation, N(0,1) biases; and the Trainer applies them from the
seed where a recipe sets ``weight_init = true``. The filterbank is
deterministic and equals the JAX package's."""

import numpy as np
import pytest
import torch

from fullsubnet_tpu.acoustics.filterbank import mel_filterbank as jax_mel_filterbank
from fullsubnet_tpu_torch.acoustics.filterbank import mel_filterbank
from fullsubnet_tpu_torch.config import load_config
from fullsubnet_tpu_torch.nn import init
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel
from fullsubnet_tpu_torch.train.trainer import Trainer

from test_torch_train import write_config

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# orthonormal columns in fp32 (the QR runs in fp64, then rounds)
ORTHO_ATOL = 1e-5
# a sample standard deviation of n draws strays by about 1/sqrt(2n) of
# itself: 0.2% at 512 x 257; 5% leaves room and still tells 1 from 1.1
STD_RTOL = 0.05


@pytest.mark.parametrize("shape", [(2048, 512), (1536, 512), (1088, 272), (1280, 31), (96, 384)])
def test_orthogonal_has_orthonormal_columns_or_rows(shape):
    """An LSTM's W_hh and W_ih [G·H, in] (G·H >= in): WᵀW = I; a wide
    matrix (Fast's 96 x 384 stands for any in > G·H): WWᵀ = I."""
    w = init.orthogonal(shape, torch.Generator().manual_seed(0)).double()
    assert w.shape == shape
    gram = w.t() @ w if shape[0] >= shape[1] else w @ w.t()
    np.testing.assert_allclose(gram.numpy(), np.eye(min(shape)), atol=ORTHO_ATOL)


def test_xavier_normal_and_normal_moments():
    g = torch.Generator().manual_seed(1)
    w = init.xavier_normal((512, 257), g)
    want_std = (2.0 / (512 + 257)) ** 0.5
    assert abs(float(w.std()) / want_std - 1) < STD_RTOL
    assert abs(float(w.mean())) < 3 * want_std / (512 * 257) ** 0.5
    b = init.normal((4096,), g)
    assert abs(float(b.mean())) < 3 / 4096**0.5 and abs(float(b.std()) - 1) < STD_RTOL


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_sequence_model_weight_init(cell):
    """``orthogonal_init_``: every W_ih and W_hh orthogonal, the biases
    N(0,1), the head Xavier-normal with an N(0,1) bias; the same seed, the
    same weights."""
    kwargs = dict(input_size=257, output_size=514, hidden_size=512, num_layers=3,
                  bidirectional=False, sequence_model=cell, output_activate_function=None)
    model = SequenceModel(**kwargs)
    model.orthogonal_init_(torch.Generator().manual_seed(2))
    biases = []
    for layer in model.sequence_model.layers():
        for name in ("w_ih", "w_hh"):
            w = layer[name].detach().double()
            np.testing.assert_allclose((w.t() @ w).numpy(), np.eye(w.shape[1]), atol=ORTHO_ATOL)
        biases += [layer["b_ih"].detach(), layer["b_hh"].detach()]
    b = torch.cat(biases)
    assert abs(float(b.mean())) < 3 / b.numel() ** 0.5 and abs(float(b.std()) - 1) < STD_RTOL
    fc = model.fc_output_layer.weight.detach()
    assert abs(float(fc.std()) / (2.0 / (514 + 512)) ** 0.5 - 1) < STD_RTOL
    again = SequenceModel(**kwargs)
    again.orthogonal_init_(torch.Generator().manual_seed(2))
    for (k, v), (_, w) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(v, w), k


def test_trainer_applies_weight_init_from_the_seed(tmp_path):
    """``weight_init = true``: the Trainer's stacks come out orthogonal, the
    same for the same seed and not the default U(±1/sqrt(H)) weights."""
    cfg = write_config(tmp_path)
    cfg.write_text(cfg.read_text().replace("weight_init = false", "weight_init = true"))
    a = Trainer(load_config(cfg), output_dir=str(tmp_path / "a"), device="cpu")
    b = Trainer(load_config(cfg), output_dir=str(tmp_path / "b"), device="cpu")
    w = a.model.sb_model.sequence_model.weight_hh_l1.detach().double()
    np.testing.assert_allclose((w.t() @ w).numpy(), np.eye(w.shape[1]), atol=ORTHO_ATOL)
    assert float(a.model.fb_model.sequence_model.bias_ih_l0.detach().abs().max()) > 1.0
    for (k, v), (_, u) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(v, u), k


@pytest.mark.parametrize("num_freqs, num_mels, sr", [(257, 64, 16000), (161, 16, 16000),
                                                     (481, 64, 48000)])
def test_mel_filterbank_equals_jax(num_freqs, num_mels, sr):
    got = mel_filterbank(num_freqs, num_mels, sr, 0.0, sr / 2)
    want = jax_mel_filterbank(num_freqs, num_mels, sr, 0.0, sr / 2)
    assert got.dtype == np.float32 and got.shape == (num_freqs, num_mels)
    np.testing.assert_array_equal(got, want)
