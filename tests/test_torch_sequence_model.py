"""The port's SequenceModel (fullsubnet_tpu_torch.nn.sequence_model)
against fullsubnet_tpu.nn.sequence_model.SequenceModel on the same
weights and inputs (numpy seed, fp32). On the CPU the JAX model takes
its scan path and the port its plain path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.nn.sequence_model import SequenceModel as JaxSequenceModel
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 on both sides; only the order of the sums differs
ATOL = 1e-5


GATES = {"LSTM": 4, "GRU": 3}


def _params(rng, f_in, hidden, out_dim, num_layers, cell="LSTM"):
    """A JAX SequenceModel param pytree with numpy leaves."""
    b = 1.0 / np.sqrt(hidden)
    gh = GATES[cell] * hidden

    def u(*shape):
        return rng.uniform(-b, b, shape).astype(np.float32)

    rnn = []
    in_dim = f_in
    for _ in range(num_layers):
        rnn.append([{"w_ih": u(gh, in_dim), "w_hh": u(gh, hidden), "b_ih": u(gh), "b_hh": u(gh)}])
        in_dim = hidden
    return {"rnn": rnn, "fc": {"weight": u(out_dim, hidden), "bias": u(out_dim)}}


def _state_dict(params):
    names = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}
    state = {
        f"sequence_model.{names[k]}_l{li}": torch.from_numpy(v)
        for li, (layer,) in enumerate(params["rnn"])
        for k, v in layer.items()
    }
    state["fc_output_layer.weight"] = torch.from_numpy(params["fc"]["weight"])
    state["fc_output_layer.bias"] = torch.from_numpy(params["fc"]["bias"])
    return state


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("act", ["ReLU", None, "Tanh"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_sequence_model_matches_jax(act, num_layers, cell):
    b, f_in, t, hidden, out_dim = 5, 20, 17, 16, 12
    rng = np.random.default_rng(num_layers)
    params = _params(rng, f_in, hidden, out_dim, num_layers, cell)
    x = rng.standard_normal((b, f_in, t)).astype(np.float32)
    kwargs = dict(
        input_size=f_in, output_size=out_dim, hidden_size=hidden,
        num_layers=num_layers, bidirectional=False, sequence_model=cell,
        output_activate_function=act,
    )

    jax_model = JaxSequenceModel(**kwargs)
    jax_params = {
        "rnn": [[{k: jnp.asarray(v) for k, v in layer.items()}] for (layer,) in params["rnn"]],
        "fc": {k: jnp.asarray(v) for k, v in params["fc"].items()},
    }
    want = np.asarray(jax_model(jax_params, jnp.asarray(x)))

    model = SequenceModel(**kwargs)
    model.load_state_dict(_state_dict(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (b, out_dim, t)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_state_dict_keys_are_the_reference_keys(cell):
    """The keys and shapes of ``nn.LSTM`` / ``nn.GRU`` + ``nn.Linear``."""
    model = SequenceModel(20, 12, 16, 2, False, cell, "ReLU")
    reference = getattr(torch.nn, cell)(20, 16, num_layers=2)
    want = {f"sequence_model.{k}": tuple(v.shape) for k, v in reference.state_dict().items()}
    want.update({"fc_output_layer.weight": (12, 16), "fc_output_layer.bias": (12,)})
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_initial_weights_come_from_the_generator(cell):
    a = SequenceModel(8, 2, 16, 2, False, cell, None,
                      generator=torch.Generator().manual_seed(3))
    b = SequenceModel(8, 2, 16, 2, False, cell, None,
                      generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    bound = 1.0 / 16**0.5
    assert float(a.sequence_model.weight_hh_l1.detach().abs().max()) <= bound


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(sequence_model="RNN"),
        dict(bidirectional=True),
        dict(output_activate_function="PReLU"),
        # head-less stacks (output_size = 0) are ported; tests/
        # test_torch_headless_stacks.py holds them against JAX
        dict(num_layers=4),
    ],
)
def test_unported_configurations_raise(kwargs):
    base = dict(input_size=8, output_size=2, hidden_size=16, num_layers=2,
                bidirectional=False, sequence_model="LSTM",
                output_activate_function=None)
    with pytest.raises(NotImplementedError):
        SequenceModel(**{**base, **kwargs})
