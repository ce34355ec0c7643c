"""The port's streaming engines against ``fullsubnet_tpu.infer.streaming`` on
the same weights: the stack's stateful step (``SequenceModel.step`` and
``step_block``, LSTM and GRU, 1 and 2 layers, with a head and head-less, and
the glue that runs it at a padded width), each engine's
``enhance_spectrogram`` / ``enhance_wave`` against the JAX engine and the
port's offline forward, ``step`` repeated against ``step_block``,
causality, ``StreamingISTFT`` with warm-up hops that do not advance, and
``StreamingEnhancer`` wave in, wave out with ragged pushes and ``flush``
for the four families, look-ahead with deep overlap and the refusals. Tiny
models (F = 33, H = 12-16, n_fft 64); the JAX engines run under their own
``jax.jit``, built once a module so that each JAX program compiles once.
Everything runs the plain stages on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu import models as jax_models
from fullsubnet_tpu.infer import streaming as jax_streaming
from fullsubnet_tpu.nn import rnn as jax_rnn
from fullsubnet_tpu.nn.sequence_model import SequenceModel as JaxSequenceModel
from fullsubnet_tpu_torch import models
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict
from fullsubnet_tpu_torch.infer import streaming
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# the port against the JAX engine on the same frames (fp32 both; the sums
# run in another order)
ATOL, RTOL = 1e-4, 1e-3
# step by step against one block (the same arithmetic, the stacks run at
# another T), and a lane against the same stream alone
STEP_ATOL = 1e-5

CUM = "cumulative_laplace_norm"
FAMILIES = {
    "fullsubnet": (models.FullSubNet, jax_models.FullSubNet, dict(
        num_freqs=33, look_ahead=2, fb_num_neighbors=0, sb_num_neighbors=3,
        fb_model_hidden_size=16, sb_model_hidden_size=12, norm_type=CUM)),
    "fullband": (models.FullBandModel, jax_models.FullBandModel, dict(
        num_freqs=33, hidden_size=16, num_layers=2, norm_type=CUM)),
    "fast": (models.FastFullSubNet, jax_models.FastFullSubNet, dict(
        encoder_input_size=33, num_mels=8, noisy_input_num_neighbors=2, norm_type=CUM)),
    "improved": (models.ImprovedFullSubNet, jax_models.ImprovedFullSubNet, dict(
        n_fft=64, hop_length=16, win_length=64, num_freqs=33, freq_cutoffs=(8, 16),
        sb_num_center_freqs=(1, 2, 4), sb_num_neighbor_freqs=(3, 3, 3),
        fb_num_center_freqs=(1, 2, 4), fb_num_neighbor_freqs=(3, 3, 3),
        fb_hidden_size=16, sb_hidden_size=12, norm_type=CUM)),
}


class Family:
    """A family's port model (seeded weights), the JAX model on the same
    weights, and the JAX engines and enhancers, each built once."""

    def __init__(self, name: str):
        port_cls, jax_cls, config = FAMILIES[name]
        self.name = name
        self.model = port_cls(**config, generator=torch.Generator().manual_seed(7)).eval()
        self.jax_model = jax_cls(**config)
        self.params = jax.tree.map(jnp.asarray, jax_params_from_state_dict(self.model.state_dict()))
        self._jax = {}

    def jax_engine(self):
        if "engine" not in self._jax:
            if self.name == "improved":
                engine = jax_streaming.StreamingImprovedFullSubNet(self.jax_model, self.params)
            else:
                engine = jax_streaming.make_streaming_engine(self.jax_model, self.params)
            self._jax["engine"] = engine
        return self._jax["engine"]

    def jax_enhancer(self, n_fft: int, hop: int):
        key = ("enhancer", n_fft, hop)
        if key not in self._jax:
            self._jax[key] = jax_streaming.StreamingEnhancer(self.jax_model, self.params,
                                                             n_fft, hop)
        return self._jax[key]

    def jax_multistream(self, n_fft: int, hop: int, streams: int):
        key = ("multi", n_fft, hop, streams)
        if key not in self._jax:
            self._jax[key] = jax_streaming.MultiStreamEnhancer(
                self.jax_model, self.params, n_fft, hop, max_streams=streams)
        return self._jax[key]


@pytest.fixture(scope="module")
def families():
    built = {}

    def get(name: str) -> Family:
        if name not in built:
            built[name] = Family(name)
        return built[name]

    return get


def stream_wave(enhancer, wave: np.ndarray, size: int) -> np.ndarray:
    """Push ``wave`` in blocks of ``size`` samples, then flush: the whole
    enhanced stream."""
    state = enhancer.init_state()
    chunks = []
    for i in range(0, len(wave), size):
        state, out = enhancer.push(state, wave[i : i + size])
        chunks.append(np.asarray(out))
    state, out = enhancer.flush(state)
    chunks.append(np.asarray(out))
    return np.concatenate(chunks)


def noisy_wave(seed: int, samples: int) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(samples)).astype(np.float32)


def engine_frames(name: str, seed: int, frames: int) -> np.ndarray:
    """[T, F] input frames of a family's engine: magnitudes, or Improved
    FullSubNet's complex STFT frames of a noisy wave."""
    rng = np.random.default_rng(seed)
    if name != "improved":
        return np.abs(rng.standard_normal((frames, 33))).astype(np.float32)
    from fullsubnet_tpu_torch.acoustics.stft import stft_complex

    wave = torch.from_numpy(noisy_wave(seed, 16 * (frames - 1)))
    return stft_complex(wave[None], 64, 16, 64)[0].T.numpy()


# -- the stack's stateful step --------------------------------------------------


def _jax_stack_params(model: SequenceModel) -> dict:
    params = {"rnn": [[{k: jnp.asarray(v.detach().numpy()) for k, v in layer.items()}]
                      for layer in model.sequence_model.layers()]}
    if model.output_size:
        params["fc"] = {"weight": jnp.asarray(model.fc_output_layer.weight.detach().numpy()),
                        "bias": jnp.asarray(model.fc_output_layer.bias.detach().numpy())}
    return params


def _leaves(state) -> list:
    return [np.asarray(v) for layer in state for v in (layer if isinstance(layer, tuple)
                                                       else (layer,))]


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("out_dim, act", [(5, "ReLU"), (0, None)])
def test_stack_step_matches_jax(cell, num_layers, out_dim, act):
    """Six frames through ``SequenceModel.step`` with the state carried, B =
    3 rows, H = 12, against the JAX ``SequenceModel.step``: outputs and the
    final (h, c). ``step_block`` over the same frames (one block, and 2 + 4)
    gives the same; and so do the stages at a padded width (16, the walks'
    grid) in blocks of 2 and 4, the state carried at H between them."""
    f_in, hidden, batch, frames = 7, 12, 3, 6
    kwargs = dict(input_size=f_in, output_size=out_dim, hidden_size=hidden,
                  num_layers=num_layers, bidirectional=False, sequence_model=cell,
                  output_activate_function=act)
    model = SequenceModel(**kwargs, generator=torch.Generator().manual_seed(num_layers))
    jax_model = JaxSequenceModel(**kwargs)
    params = _jax_stack_params(model)
    x = np.random.default_rng(out_dim + num_layers).standard_normal(
        (frames, batch, f_in)).astype(np.float32)

    jax_step = jax.jit(jax_model.step)
    jax_state = jax_rnn.rnn_init_state(params["rnn"], batch, cell)
    want = []
    for t in range(frames):
        jax_state, y = jax_step(params, jax_state, jnp.asarray(x[t]))
        want.append(np.asarray(y))
    want = np.stack(want)

    with torch.inference_mode():
        state = model.init_state(batch)
        assert [v.shape for v in _leaves(state)] == [(batch, hidden)] * len(_leaves(state))
        got = []
        for t in range(frames):
            state, y = model.step(state, torch.from_numpy(x[t]))
            got.append(y.numpy())
        got = np.stack(got)
        _, block = model.step_block(model.init_state(batch), torch.from_numpy(x))
        split_state, first = model.step_block(model.init_state(batch), torch.from_numpy(x[:2]))
        split_state, rest = model.step_block(split_state, torch.from_numpy(x[2:]))

        layers, fc = model.sequence_model.layers(), model._head()
        walk = ops.plain_lstm_fwd_walk if cell == "LSTM" else ops.plain_gru_fwd_walk
        padded_state = model.init_state(batch)
        padded = []
        for part in (x[:2], x[2:]):  # the state cut back to H in between
            out, padded_state = ops.step_stages(ops.plain_fwd_gemm, walk, torch.from_numpy(part),
                                                layers, fc, padded_state, 16)
            padded.append(out)
        padded = torch.cat(padded)
        if act:
            padded = torch.relu(padded)

    assert got.shape == want.shape == (frames, batch, out_dim or hidden)
    np.testing.assert_allclose(got, want, atol=STEP_ATOL)
    for g, w in zip(_leaves(state), _leaves(jax_state), strict=True):
        np.testing.assert_allclose(g, w, atol=STEP_ATOL)
    np.testing.assert_allclose(block.numpy(), got, atol=STEP_ATOL)
    np.testing.assert_allclose(torch.cat([first, rest]).numpy(), got, atol=STEP_ATOL)
    for g, w in zip(_leaves(split_state), _leaves(state), strict=True):
        np.testing.assert_allclose(g, w, atol=STEP_ATOL)
    assert padded.shape == block.shape
    np.testing.assert_allclose(padded.numpy(), got, atol=STEP_ATOL)
    for g, w in zip(_leaves(padded_state), _leaves(state), strict=True):
        assert g.shape == (batch, hidden)
        np.testing.assert_allclose(g, w, atol=STEP_ATOL)


def test_cpu_step_launches_no_kernel():
    """On a CPU tensor the stateful step runs the plain stages: no kernel
    wrapper counts a launch; a device with no path raises."""
    kernels = [v for v in vars(ops).values() if isinstance(v, ops._Counts)]
    for kernel in kernels:
        kernel.reset_counts()
    model = SequenceModel(7, 3, 12, 2, False, "LSTM", "ReLU")
    with torch.inference_mode():
        state, y = model.step(model.init_state(4), torch.ones(4, 7))
        assert y.shape == (4, 3) and [h.shape for h, _ in state] == [(4, 12)] * 2
        with pytest.raises(ValueError, match="no fused scan path"):
            ops.fused_subband_lstm_step(torch.ones(1, 4, 7, device="meta"),
                                        *model.sequence_model.layers(), model._head(),
                                        states=state)
    assert all(kernel.launches == 0 for kernel in kernels)


# -- the engines ---------------------------------------------------------------


def _engine(name: str, model):
    if name == "improved":
        return streaming.StreamingImprovedFullSubNet(model)
    return streaming.make_streaming_engine(model)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_engine_matches_jax_and_offline(families, name):
    """The whole utterance through the engine (``enhance_spectrogram``;
    Improved FullSubNet ``enhance_wave``) against the JAX engine and against
    the port's offline forward with the cumulative norm. Fast FullSubNet at
    19 and 20 frames: with the 2 look-ahead frames its down clock ends on a
    whole block and on a partial one."""
    fam = families(name)
    jax_engine = fam.jax_engine()
    engine = _engine(name, fam.model)
    for frames in ((19, 20) if name == "fast" else (40,)):
        if name == "improved":
            wave = noisy_wave(frames, 16 * (frames - 1))
            want = np.asarray(jax_engine.enhance_wave(jnp.asarray(wave)))
            got = engine.enhance_wave(wave).numpy()
            with torch.inference_mode():
                offline = fam.model(torch.from_numpy(wave)[None])[0, 0].numpy()
        else:
            mag = engine_frames(name, frames, frames).T  # [F, T]
            want = np.asarray(jax_engine.enhance_spectrogram(jnp.asarray(mag)))
            got = engine.enhance_spectrogram(mag).numpy()
            with torch.inference_mode():
                offline = fam.model(torch.from_numpy(mag)[None, None])[0].numpy()
        assert got.shape == want.shape == offline.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, offline, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_step_equals_block(families, name):
    """Nine frames one ``step`` at a time, one ``step_block`` of 9, and
    blocks of 4 and 5 with the state carried between them: the same
    outputs (Fast FullSubNet's bottleneck emits at frames 0, 2, 4, ...)."""
    engine = _engine(name, families(name).model)
    frames = torch.from_numpy(engine_frames(name, 3, 9))
    state = engine.init_state()
    steps = []
    for t in range(9):
        state, out = engine.step(state, frames[t])
        steps.append(out)
    steps = torch.stack(steps)
    _, block = engine.step_block(engine.init_state(), frames)
    carried, first = engine.step_block(engine.init_state(), frames[:4])
    carried, rest = engine.step_block(carried, frames[4:])
    for got in (block, torch.cat([first, rest])):
        torch.testing.assert_close(got, steps, atol=STEP_ATOL, rtol=0)
    assert int(carried["frame_idx"][0]) == int(state["frame_idx"][0]) == 9


@pytest.mark.parametrize("name", list(FAMILIES))
def test_engine_is_causal(families, name):
    """A change from frame 60 on leaves every earlier output as it was and
    changes the later ones."""
    engine = _engine(name, families(name).model)
    frames = engine_frames(name, 5, 70)
    changed = frames.copy()
    changed[60:] *= 4.0
    _, out = engine.step_block(engine.init_state(), frames)
    _, out_changed = engine.step_block(engine.init_state(), changed)
    np.testing.assert_array_equal(out[:60].numpy(), out_changed[:60].numpy())
    assert not np.allclose(out[60:].numpy(), out_changed[60:].numpy())


# -- the overlap-add iSTFT -------------------------------------------------------


@pytest.mark.parametrize("n_fft, hop", [(64, 32), (64, 16)])
def test_streaming_istft_matches_jax(n_fft, hop):
    """The spectrum of a noisy wave pushed frame by frame, the first two
    frames (zero spectra, as the look-ahead warm-up pushes them) not
    advancing the envelope index: each hop against the JAX OLA, and the
    stream against the offline iSTFT in the interior."""
    from fullsubnet_tpu_torch.acoustics.stft import istft, stft_complex

    wave = torch.from_numpy(noisy_wave(hop, 2048))
    spec = stft_complex(wave[None], n_fft, hop, n_fft)[0]  # [F, T]
    frames = torch.cat([torch.zeros(spec.shape[0], 2, dtype=spec.dtype), spec], dim=1)
    ola = streaming.StreamingISTFT(n_fft, hop, device="cpu")
    jax_ola = jax_streaming.StreamingISTFT(n_fft, hop)
    jax_push = jax.jit(jax_ola.push)
    state, jax_state = ola.init_state(), jax_ola.init_state()
    got, want = [], []
    for t in range(frames.shape[1]):
        advance = t >= 2
        state, out = ola.push(state, frames[:, t], advance=advance)
        jax_state, jax_out = jax_push(jax_state, jnp.asarray(frames[:, t].numpy()),
                                      jnp.asarray(advance))
        got.append(out.numpy())
        want.append(np.asarray(jax_out))
    got, want = np.concatenate(got), np.concatenate(want)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert int(state["k"]) == frames.shape[1] - 2
    # after the two warm-up hops sample i is padded-signal sample i
    offline = istft(spec[None], n_fft, hop, n_fft, length=2048)[0].numpy()
    stream = got[2 * hop + n_fft // 2 :]
    np.testing.assert_allclose(stream[: 2048 - n_fft], offline[: 2048 - n_fft], atol=1e-5)


def test_streaming_istft_runs_on_the_card_unless_told_and_refuses_other_devices():
    """The overlap-add's state is on the card by default (without one the
    constructor raises, as the Inferencer's does); a frame on another
    device than the state raises instead of being copied across."""
    if torch.cuda.is_available():
        assert streaming.StreamingISTFT(64, 32).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA"):
            streaming.StreamingISTFT(64, 32)
    ola = streaming.StreamingISTFT(64, 32, device="cpu")
    state = ola.init_state()
    with pytest.raises(ValueError, match="meta"):
        ola.push(state, torch.zeros(33, dtype=torch.complex64, device="meta"))
    # a host array is the caller's input, copied to the state's device
    state, out = ola.push(state, np.zeros(33, np.complex64))
    assert out.shape == (32,) and out.device == state["acc"].device


# -- StreamingEnhancer -----------------------------------------------------------


@pytest.mark.parametrize("name, n_fft, hop, push", [
    ("fullsubnet", 64, 32, 100), ("fullband", 64, 32, 77), ("fast", 64, 32, 100),
    ("improved", 64, 16, 160),
    # look-ahead 2 with 75% overlap: the warm-up's zero spectra must not
    # advance the OLA's envelope index
    ("fullsubnet", 64, 16, 100),
])
def test_streaming_enhancer_matches_jax(families, name, n_fft, hop, push):
    """Ragged pushes and ``flush`` against the JAX StreamingEnhancer on the
    same wave: the whole stream, sample-aligned with the input."""
    fam = families(name)
    wave = noisy_wave(hop + push, 2048)
    want = stream_wave(fam.jax_enhancer(n_fft, hop), wave, push)
    enhancer = streaming.StreamingEnhancer(fam.model, n_fft, hop)
    assert enhancer.look_ahead == (0 if name == "improved" else 2)
    got = stream_wave(enhancer, wave, push)
    assert got.dtype == np.float32 and got.shape == want.shape and len(got) >= 2048
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_streaming_enhancer_rejects_short_window(families):
    with pytest.raises(ValueError, match="win_length"):
        streaming.StreamingEnhancer(families("fullsubnet").model, 64, 32, win_length=40)


def test_engine_refusals_match_jax(families):
    """The sub-band baseline has no magnitude engine (the JAX message); a
    non-cumulative norm, full-band neighbours and misaligned section
    centres are refused as the JAX engines refuse them."""
    from fullsubnet_tpu.models import SubBandBaseline as JaxSubBandBaseline

    config = dict(num_neighbors=3, look_ahead=2, hidden_size=8, num_layers=2,
                  output_activate_function=None, norm_type=CUM)
    with pytest.raises(TypeError) as jax_err:
        jax_streaming.make_streaming_engine(JaxSubBandBaseline(**config), {})
    with pytest.raises(TypeError) as err:
        streaming.make_streaming_engine(models.SubBandBaseline(**config))
    assert str(err.value) == str(jax_err.value) == "no magnitude streaming engine for " \
        "SubBandBaseline"

    for name, (port_cls, _, config) in FAMILIES.items():
        offline = port_cls(**{**config, "norm_type": "offline_laplace_norm"})
        with pytest.raises(AssertionError, match="cumulative normalization"):
            _engine(name, offline)
    fsn = FAMILIES["fullsubnet"]
    with pytest.raises(AssertionError, match="fb neighbors=0"):
        streaming.StreamingFullSubNet(fsn[0](**{**fsn[2], "fb_num_neighbors": 1}))
    imp = FAMILIES["improved"]
    with pytest.raises(AssertionError, match="aligned sb/fb center counts"):
        streaming.StreamingImprovedFullSubNet(
            imp[0](**{**imp[2], "fb_num_center_freqs": (1, 4, 4)}))
