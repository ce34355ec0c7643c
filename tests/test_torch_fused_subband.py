"""The port's fused sub-band stage (``FullSubNet._sb_norm_mu``,
``_subband_input``, ``_kernel_subband``, ``_fused_subband_stage``) against
the JAX package on the CPU: the norm's mean and the stage's output against
``FullSubNet._sb_norm_mu`` and ``_pallas_subband(..., interpret=True)``
for both fusable norms and drop_band groups 1 and 2; the fused forward with
``valid_frames`` against the JAX model; the gradients of a training loss
through the fused stage under a forced time chunk against the JAX
package's (its ``test_model_fused_training_chunked_grads``); the fused
route against the port's own unfused route; and drop_band over slices of a
batch (``band_rows``) against the whole batch. Same numpy-seeded weights
and magnitudes on both sides, fp32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.models import FullSubNet as JaxFullSubNet
from fullsubnet_tpu_torch.acoustics.norm import cumulative_laplace_norm, offline_laplace_norm
from fullsubnet_tpu_torch.checkpoint import state_dict_from_jax_params
from fullsubnet_tpu_torch.models import FullSubNet
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 through both stages and the norm; only the order of the sums differs
# (tests/test_torch_fullsubnet.py's tolerance)
ATOL = 1e-5
# the norm's mean against the JAX package's: fp32 sums in another order
# (the cumulative norm's box filter is a difference of cumulative sums
# there, a direct sum here), relative
MU_RTOL = 1e-5
# gradients through the whole model: the tolerance of the JAX package's own
# test_model_fused_training_chunked_grads (its scan route against its
# chunked kernel), which holds the two JAX routes to each other
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3

# a small model: F = 32 bins, units of 7 + 3 (fb_num_neighbors = 1, so the
# full-band output is reflect-padded too), H = 16 and 12
SMALL = dict(num_freqs=32, look_ahead=2, fb_num_neighbors=1, sb_num_neighbors=3,
             fb_output_activate_function="ReLU", sb_output_activate_function=None,
             fb_model_hidden_size=16, sb_model_hidden_size=12, num_groups_in_drop_band=2)
NORMS = ["offline_laplace_norm", "cumulative_laplace_norm"]
GATES = {"LSTM": 4, "GRU": 3}


def _params(seed, cell):
    """JAX FullSubNet params (numpy leaves) for ``SMALL``, U(±1/sqrt(H))."""
    rng = np.random.default_rng(seed)

    def stack(f_in, hidden, out_dim):
        b = 1.0 / np.sqrt(hidden)
        gh = GATES[cell] * hidden
        u = lambda *shape: rng.uniform(-b, b, shape).astype(np.float32)  # noqa: E731
        rnn, in_dim = [], f_in
        for _ in range(2):
            rnn.append([{"w_ih": u(gh, in_dim), "w_hh": u(gh, hidden), "b_ih": u(gh),
                         "b_hh": u(gh)}])
            in_dim = hidden
        return {"rnn": rnn, "fc": {"weight": u(out_dim, hidden), "bias": u(out_dim)}}

    return {"fb_model": stack(32, 16, 32), "sb_model": stack(7 + 3, 12, 2)}


def _models(cell, norm_type, seed=0, **extra):
    config = {**SMALL, "sequence_model": cell, "norm_type": norm_type, **extra}
    params = _params(seed, cell)
    port = FullSubNet(**config)
    port.load_state_dict(state_dict_from_jax_params(params))
    return JaxFullSubNet(**config), jax.tree.map(jnp.asarray, params), port


def _mag(seed, batch, frames=21):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((batch, 1, 32, frames))) * 3).astype(np.float32)


def _jax_sources(jax_model, params, mag):
    """The JAX model's reflect-padded sources, as its ``_fused_subband_stage``
    builds them: (noisy_pad, fb_pad) [B, F + 2N, T], look-ahead included."""
    x = jnp.pad(jnp.asarray(mag), ((0, 0), (0, 0), (0, 0), (0, jax_model.look_ahead)))
    b, _, f, t = x.shape
    fb_out = jax_model.fb_model(params["fb_model"], jax_model.norm(x).reshape(b, f, t))
    noisy_pad = jnp.pad(x[:, 0], ((0, 0), (3, 3), (0, 0)), mode="reflect")
    fb_pad = jnp.pad(fb_out, ((0, 0), (1, 1), (0, 0)), mode="reflect")
    return noisy_pad, fb_pad


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("norm_type", NORMS)
def test_kernel_subband_matches_pallas_subband(norm_type, groups, cell):
    """On the same padded sources: the port's ``_sb_norm_mu`` against the
    JAX one, then ``_kernel_subband`` (its stack through the plain stages)
    against ``_pallas_subband`` in interpret mode, with drop_band's groups
    (B = 4: rows 0 and 2 keep bins 0, 2, ..., rows 1 and 3 bins 1, 3, ...)."""
    jax_model, params, port = _models(cell, norm_type)
    noisy_pad, fb_pad = _jax_sources(jax_model, params, _mag(groups, 4))
    mu = jax_model._sb_norm_mu(noisy_pad, fb_pad, 32)
    run = jax.jit(functools.partial(jax_model._pallas_subband, f=32, mu_is_scalar=mu.shape[1] == 1,
                                    interpret=True, drop_groups=groups))
    want = np.asarray(run(params, noisy_pad, fb_pad, mu=mu))
    with torch.inference_mode():
        tn, tf = (torch.from_numpy(np.asarray(a)) for a in (noisy_pad, fb_pad))
        got_mu = port._sb_norm_mu(tn, tf, 32)
        got = port._kernel_subband(tn, tf, 32, got_mu, groups).numpy()
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(mu).reshape(got_mu.shape),
                               rtol=MU_RTOL)
    assert got.shape == want.shape == (4, 2, 32 // groups, 23)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("norm_type", NORMS)
def test_fused_forward_with_valid_frames_matches_jax(norm_type, cell):
    """The fused stage forced at inference (``_FUSED_SB_THRESHOLD`` 0) with
    ``valid_frames`` [B]: over every row's real frames equal to the JAX
    model's forward on the same zero-padded batch, and to the port's
    unfused route; without ``valid_frames`` too."""
    jax_model, params, port = _models(cell, norm_type, seed=1)
    valid = np.array([21, 14, 9])
    mag = _mag(5, 3) * (np.arange(21) < valid[:, None, None, None])
    real = (np.arange(21) < valid[:, None])[:, None, None, :]
    want = np.asarray(jax_model(params, jnp.asarray(mag), dropping_band=False,
                                valid_frames=jnp.asarray(valid)))
    want_whole = np.asarray(jax_model(params, jnp.asarray(mag), dropping_band=False))
    with torch.inference_mode():
        mag_t = torch.from_numpy(mag)
        unfused = port(mag_t, dropping_band=False, valid_frames=torch.from_numpy(valid)).numpy()
        port._FUSED_SB_THRESHOLD = 0
        got = port(mag_t, dropping_band=False, valid_frames=torch.from_numpy(valid)).numpy()
        got_whole = port(mag_t, dropping_band=False).numpy()
    np.testing.assert_allclose(got * real, want * real, atol=ATOL)
    np.testing.assert_allclose(got * real, unfused * real, atol=ATOL)
    np.testing.assert_allclose(got_whole, want_whole, atol=ATOL)


def _jax_chunked_loss_and_grads(jax_model, params, mag, target, groups):
    """The JAX package's test_model_fused_training_chunked_grads loss: the
    full-band stage, the fused mean, then ``_pallas_subband`` in interpret
    mode training with a time chunk of 8, against ``target``; its value and
    gradients under jit."""
    la = jax_model.look_ahead

    def loss(p):
        x = jnp.pad(jnp.asarray(mag), ((0, 0), (0, 0), (0, 0), (0, la)))
        b, _, f, t = x.shape
        fb_out = jax_model.fb_model(p["fb_model"], jax_model.norm(x).reshape(b, f, t))
        noisy_pad = jnp.pad(x[:, 0], ((0, 0), (3, 3), (0, 0)), mode="reflect")
        fb_pad = jnp.pad(fb_out, ((0, 0), (1, 1), (0, 0)), mode="reflect")
        mu = jax_model._sb_norm_mu(noisy_pad, fb_pad, f)
        out = jax_model._pallas_subband(p, noisy_pad, fb_pad, f, mu, mu.shape[1] == 1,
                                        interpret=True, drop_groups=groups, training=True,
                                        time_chunk=8)[..., la:]
        return jnp.mean(jnp.square(out - target))

    return jax.jit(jax.value_and_grad(loss))(params)


def _port_loss_and_grads(port, mag, target, **forward):
    port.zero_grad()
    loss = torch.mean((port(torch.from_numpy(mag), **forward) - torch.from_numpy(target)) ** 2)
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy().copy() for k, v in port.named_parameters()}


@pytest.mark.parametrize("cell, norm_type, groups", [
    ("LSTM", "cumulative_laplace_norm", 1), ("GRU", "offline_laplace_norm", 2),
    ("LSTM", "offline_laplace_norm", 2)])
def test_fused_training_chunked_grads_match_jax(cell, norm_type, groups):
    """A training loss through the fused stage with the sub-band stack's
    time chunk forced to 8 (``subband_time_chunk``; T = 23: chunks of 8, 8
    and 7): the loss and every gradient against the JAX package's chunked
    ``_pallas_subband``, both stages' weights. Groups 2: drop_band (B = 4)."""
    jax_model, params, port = _models(cell, norm_type, seed=2)
    mag = _mag(7, 4)
    target = np.random.default_rng(8).standard_normal((4, 2, 32 // groups, 21)).astype(np.float32)
    want_loss, want = _jax_chunked_loss_and_grads(jax_model, params, mag, target, groups)
    port.subband_time_chunk = 8
    ops.train_chunks.clear()
    got_loss, got = _port_loss_and_grads(port, mag, target, dropping_band=groups > 1)
    assert ops.train_chunks[8] == 1  # the sub-band stage chunked; the full-band stack not
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    for key, w in state_dict_from_jax_params(jax.device_get(want)).items():
        np.testing.assert_allclose(got[key], w.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=key)


def _unfused(norm):
    """The same norm under another identity: the forward's gate does not
    know it, so it takes the unfused route."""
    return lambda v: norm(v)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("norm", [offline_laplace_norm, cumulative_laplace_norm])
@pytest.mark.parametrize("chunk", [None, 8])
def test_fused_route_equals_unfused_route(norm, cell, chunk):
    """Training (autograd records the call) takes the fused route, with and
    without drop_band (B = 4 and 2); its output and every gradient equal the
    unfused route's, which unfolds, concatenates, normalises and drops
    bands; the sub-band stash chunked or not."""
    _, _, port = _models(cell, "offline_laplace_norm", seed=3)
    port.subband_time_chunk = chunk
    for batch in (4, 2):
        mag = _mag(batch, batch)
        f_out = 16 if batch > 2 else 32
        target = np.random.default_rng(9).standard_normal((batch, 2, f_out, 21))
        target = target.astype(np.float32)
        port.norm = norm
        ops.train_chunks.clear()
        got_loss, got = _port_loss_and_grads(port, mag, target)
        assert sum(ops.train_chunks.values()) == 2  # both stacks, the fused stage's included
        port.norm = _unfused(norm)
        want_loss, want = _port_loss_and_grads(port, mag, target)
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=key)


def _joined(parts, groups):
    """Slices' drop_band outputs joined into the whole batch's: each slice's
    rows are group-major over its own rows, each row in the group its index
    in the whole batch gives it; the whole batch's are group-major over all
    rows. parts: (offset, output [rows, ...])."""
    blocks = {g: [] for g in range(groups)}
    for offset, out in parts:
        start = 0
        for g in range(groups):
            count = len(range((g - offset) % groups, out.shape[0], groups))
            blocks[g].append(out[start : start + count])
            start += count
    return torch.cat([torch.cat(blocks[g]) for g in range(groups)])


@pytest.mark.parametrize("norm_type", NORMS)
@pytest.mark.parametrize("groups, batch, splits", [
    (2, 6, (4,)), (2, 6, (2,)), (3, 9, (1, 7))])
def test_band_rows_slices_join_to_the_whole_batch(norm_type, groups, batch, splits):
    """Training through the fused route on slices of a batch, each with its
    ``band_rows`` (a rank's share: the rows' groups are their indices in the
    whole batch), joined, equal the whole batch's output. Two ranks at G = 2;
    at G = 3 a middle slice of 6 rows from row 1 (fused, its first row in
    group 1) between slices of 1 and 2 rows (not a multiple of G: unfused)."""
    _, _, port = _models("LSTM", norm_type, seed=4, num_groups_in_drop_band=groups)
    mag = torch.from_numpy(_mag(11, batch))
    whole = port(mag).detach()
    edges = (0, *splits, batch)
    parts = [(a, port(mag[a:b], band_rows=(a, batch)).detach())
             for a, b in zip(edges[:-1], edges[1:])]
    assert whole.shape == (batch, 2, 32 // groups, 21)
    np.testing.assert_allclose(_joined(parts, groups).numpy(), whole.numpy(), atol=ATOL)
