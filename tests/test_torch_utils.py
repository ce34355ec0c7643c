"""The port's small utilities (``fullsubnet_tpu_torch/utils.py``) against the
JAX package's: ``initialize_module``, ``check_nan`` over a state dict and
nested trees, ``print_tensor_info`` and ``ExecutionTime``."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu import utils as jax_utils
from fullsubnet_tpu_torch import utils

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)


def test_initialize_module_as_jax_does():
    cls = utils.initialize_module("fullsubnet_tpu_torch.acoustics.norm.norm_wrapper",
                                  initialize=False)
    from fullsubnet_tpu_torch.acoustics.norm import norm_wrapper

    assert cls is norm_wrapper
    assert (utils.initialize_module("collections.OrderedDict", {"a": 1})
            == jax_utils.initialize_module("collections.OrderedDict", {"a": 1}))
    assert utils.initialize_module("collections.OrderedDict") == {}
    for fn in (utils.initialize_module, jax_utils.initialize_module):
        with pytest.raises(ModuleNotFoundError):
            fn("no_such_module.Model")
        with pytest.raises(AttributeError):
            fn("collections.NoSuchClass")


def test_check_nan_names_each_leaf_as_jax_does(capsys):
    clean = {"w": np.ones(3, np.float32), "layers": [np.zeros(2, np.float32)]}
    bad = {"w": np.ones(3, np.float32),
           "layers": [np.zeros(2, np.float32), np.array([1.0, np.nan], np.float32)],
           "b": {"c": np.array([np.nan], np.float32)}}
    for tree, want in ((clean, False), (bad, True)):
        got = utils.check_nan({k: _torch(v) for k, v in tree.items()}, "params")
        printed = capsys.readouterr().out
        assert got is jax_utils.check_nan(tree, "params") is want
        assert printed == capsys.readouterr().out
    model = torch.nn.Linear(2, 2)
    assert not utils.check_nan(model.state_dict())
    with torch.no_grad():
        model.bias[1] = float("nan")
    assert utils.check_nan(model.state_dict(), "model")
    assert capsys.readouterr().out == "NaN in model['bias']\n"


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(tree)


def test_print_tensor_info_as_jax_does(capsys):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    jax_utils.print_tensor_info(jnp.asarray(x), "x")
    want = capsys.readouterr().out
    utils.print_tensor_info(torch.from_numpy(x).to(torch.bfloat16).float(), "x")
    utils.print_tensor_info(torch.from_numpy(x), "x")
    assert capsys.readouterr().out.splitlines()[1] == want.strip()


def test_execution_time():
    t = utils.ExecutionTime()
    time.sleep(0.01)
    assert 0.01 <= t.duration() < 5
