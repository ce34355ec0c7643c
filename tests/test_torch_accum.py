"""The port's gradient accumulation (``train/accum.py``, the Trainer's
accumulated step) on the CPU against the JAX package: the split picker
over a grid, one accumulated step (G = 2 at B = 4, whose microbatches of
2 rows are too few for drop_band's 2 groups, and at B = 8, where each
microbatch drops bands) against ``scan_accumulated_value_and_grad`` and
``JaxTrainer._train_step`` with ``grad_accum_steps = 2``, for both cells
at fp32 and bf16; the warning and the split used when G does not divide
the batch. The tiny TOML of tests/test_torch_train.py."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.config import load_config as jax_load_config
from fullsubnet_tpu.parallel.mesh import shard_batch
from fullsubnet_tpu.train.accum import largest_compatible_accum as jax_largest_compatible_accum
from fullsubnet_tpu.train.accum import scan_accumulated_value_and_grad
from fullsubnet_tpu.train.trainer import Trainer as JaxTrainer
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict
from fullsubnet_tpu_torch.config import load_config
from fullsubnet_tpu_torch.train.accum import largest_compatible_accum
from fullsubnet_tpu_torch.train.trainer import Trainer

from test_torch_train import (
    BF16_GRAD_RTOL,
    FP32_GRAD_RTOL,
    _by_key,
    _close_by_key,
    _jax_loss_fn,
    write_config,
)

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

G = 2


def test_largest_compatible_accum_matches_jax():
    for requested in range(0, 9):
        for batch in range(1, 25):
            for data_div in (1, 2, 3, 4):
                want = jax_largest_compatible_accum(requested, batch, data_div)
                assert largest_compatible_accum(requested, batch, data_div) == want, (
                    requested, batch, data_div)


def _batches(port: Trainer, batch: int, steps: int = 3):
    """``steps`` batches of ``batch`` items of the port's dataset, one an
    epoch from epoch 1 (past the 8 clips they come round again)."""
    ds, out = port.train_dataset, []
    for epoch in range(1, steps + 1):
        ds.set_epoch(epoch)
        items = [ds[i % len(ds)] for i in range(batch)]
        out.append(tuple(torch.from_numpy(np.stack([it[k] for it in items])) for k in (0, 1)))
    return out


@pytest.mark.parametrize("sequence_model", ["LSTM", "GRU"])
@pytest.mark.parametrize("use_amp", [False, True])
def test_accumulated_step_matches_jax_trainer(tmp_path, use_amp, sequence_model):
    """At B = 4 and 8 with G = 2: the mean loss and the pre-clip gradients
    of one batch against the JAX accumulation's, at the tolerances of
    test_torch_train.py's single step; at fp32 and B = 8 (each microbatch
    dropping bands) also the params after three steps against
    ``JaxTrainer._train_step`` (bf16 steps would compare rounding, as
    there; each step shape is one more XLA compile of several seconds)."""
    cfg_path = write_config(tmp_path, use_amp=use_amp, sequence_model=sequence_model)
    config = load_config(cfg_path)
    config["trainer"]["train"]["grad_accum_steps"] = G
    jax_config = jax_load_config(cfg_path)
    jax_config["trainer"]["train"]["grad_accum_steps"] = G
    loss_fn = _jax_loss_fn(JaxTrainer(jax_config, output_dir=str(tmp_path / "probe")), use_amp)

    @jax.jit
    def jax_accumulated(params, noisy, clean):
        b = noisy.shape[0]
        split = (noisy.reshape(G, b // G, -1), clean.reshape(G, b // G, -1))
        return scan_accumulated_value_and_grad(loss_fn, params, split, G)

    for batch in (4, 8):
        port = Trainer(config, output_dir=str(tmp_path / f"port{batch}"), device="cpu")
        jt = JaxTrainer(jax_config, output_dir=str(tmp_path / f"jax{batch}"))
        jt.state["params"] = jax.tree.map(
            jnp.asarray, jax_params_from_state_dict(port.model.state_dict()))
        jt.state["opt_state"] = jt.optimizer.init(jt.state["params"])
        batches = _batches(port, batch)
        noisy, clean = batches[0]

        want_loss, want_grads = jax_accumulated(
            jt.state["params"], jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy()))
        assert port.accum_split(batch) == G
        loss = port.loss_and_grads(noisy, clean)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-2 if use_amp else 1e-5)
        got_grads = {k: p.grad.numpy() for k, p in port.model.named_parameters()}
        assert all(g.dtype == np.float32 for g in got_grads.values())
        _close_by_key(got_grads, _by_key(want_grads), BF16_GRAD_RTOL if use_amp else FP32_GRAD_RTOL)
        if use_amp or batch != 8:
            continue

        state = jt.state
        for n, c in batches:
            port.train_step(n, c)
            state, _ = jt._train_step(state, *shard_batch(
                (jnp.asarray(n.numpy()), jnp.asarray(c.numpy())), jt.mesh))
        want = _by_key(state["params"])
        got = {k: v.detach().numpy() for k, v in port.model.state_dict().items()}
        # test_torch_train.py's bound after three steps: a tenth of lr
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0, err_msg=key)


def test_split_that_does_not_divide_the_batch_falls_back(tmp_path, caplog):
    """G = 3 at B = 8: the JAX warning, once a batch size, and the split
    G = 2, whose step equals a G = 2 Trainer's; G = 0 and 1 mean one
    microbatch and warn nothing."""
    cfg_path = write_config(tmp_path)
    trainers = {}
    for g in (0, 1, 2, 3):
        config = load_config(cfg_path)
        config["trainer"]["train"]["grad_accum_steps"] = g
        trainers[g] = Trainer(config, output_dir=str(tmp_path / f"g{g}"), device="cpu")
    noisy, clean = _batches(trainers[3], 8, steps=1)[0]
    with caplog.at_level(logging.WARNING, logger="fullsubnet_tpu_torch.train.trainer"):
        assert trainers[3].accum_split(8) == 2
        assert trainers[3].accum_split(8) == 2
        assert trainers[0].accum_split(8) == trainers[1].accum_split(8) == 1
        assert trainers[3].accum_split(6) == 3
    assert [r.getMessage() for r in caplog.records] == [
        "grad_accum_steps=3 does not divide batch 8 (data axis 1); using the nearest "
        "compatible split G=2"
    ]
    assert float(trainers[3].loss_and_grads(noisy, clean)) == float(
        trainers[2].loss_and_grads(noisy, clean))
    for (key, p), q in zip(trainers[3].model.named_parameters(), trainers[2].model.parameters()):
        assert torch.equal(p.grad, q.grad), key
    assert float(trainers[0].loss_and_grads(noisy, clean)) == float(
        trainers[1].loss_and_grads(noisy, clean))
