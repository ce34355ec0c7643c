"""The port's serving artifacts (``fullsubnet_tpu_torch.serving``) against
the port's live paths and the JAX package on the same weights: bucketed
artifacts at batch 1 and 2 against the live ``Inferencer.enhance_bucket``
and the JAX ``build_bucketed_enhance_fn``; exact artifacts of ``mag``,
``scaled_mask`` and ``sub_band_crm_mask`` against the live strategies and
the JAX Inferencer's ``_<strategy>_fn``; Improved FullSubNet's
``time_domain`` (bucketed on ``valid_samples``); ``StreamingServingModel``
with ragged pushes and ``flush`` against the live ``StreamingEnhancer`` and
the JAX one; ``MultiStreamServingModel`` with a slot reset mid-run and
idle lanes against ``MultiStreamEnhancer`` and the JAX one; LSTM and GRU;
the registered operators in the programs; the refusals; and loading and
serving in a subprocess where importing jax, the JAX package or the port's
model code fails. Tiny models (F = 33, n_fft 64) on the CPU; each JAX
reference runs under ``jax.jit``, built once a module."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu import models as jax_models
from fullsubnet_tpu.infer import streaming as jax_streaming
from fullsubnet_tpu.infer.inferencer import Inferencer as JaxInferencer
from fullsubnet_tpu.infer.inferencer import build_bucketed_enhance_fn, model_call_kwargs
from fullsubnet_tpu_torch import models, serving
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict
from fullsubnet_tpu_torch.infer.inferencer import Inferencer
from fullsubnet_tpu_torch.infer.streaming import MultiStreamEnhancer, StreamingEnhancer

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# a served program against the live path it was exported from: the same
# operations (a batch's filler rows change the GEMMs' shapes only)
LIVE_ATOL = 1e-6
# against the JAX package on the same weights (fp32 both; the sums run in
# another order), as tests/test_torch_streaming.py holds the engines
ATOL, RTOL = 1e-4, 1e-3

CUM = "cumulative_laplace_norm"
OFFLINE = "offline_laplace_norm"
ACOUSTICS = {"n_fft": 64, "hop_length": 32, "win_length": 64, "sr": 16000}
# (port class, JAX class, [model] path, args, acoustics)
FAMILIES = {
    "fullsubnet": (models.FullSubNet, jax_models.FullSubNet, "fullsubnet.model.Model", dict(
        num_freqs=33, look_ahead=2, fb_num_neighbors=0, sb_num_neighbors=3,
        fb_model_hidden_size=16, sb_model_hidden_size=12), ACOUSTICS),
    "fullband": (models.FullBandModel, jax_models.FullBandModel,
                 "fullband_baseline.model.Model", dict(
                     num_freqs=33, hidden_size=16, num_layers=2, look_ahead=2,
                     output_activate_function=None), ACOUSTICS),
    "subband": (models.SubBandBaseline, jax_models.SubBandBaseline,
                "subband_baseline.model.Model", dict(
                    num_neighbors=3, look_ahead=2, hidden_size=12, num_layers=2,
                    output_activate_function=None, num_groups_in_drop_band=2), ACOUSTICS),
    "improved": (models.ImprovedFullSubNet, jax_models.ImprovedFullSubNet,
                 "improved_fullsubnet.model.Model", dict(
                     n_fft=64, hop_length=16, win_length=64, num_freqs=33, freq_cutoffs=(8, 16),
                     sb_num_center_freqs=(1, 2, 4), sb_num_neighbor_freqs=(3, 3, 3),
                     fb_num_center_freqs=(1, 2, 4), fb_num_neighbor_freqs=(3, 3, 3),
                     fb_hidden_size=16, sb_hidden_size=12),
                 {"n_fft": 64, "hop_length": 16, "win_length": 64, "sr": 16000}),
}
STRATEGY_FAMILY = {"mag": "fullband", "scaled_mask": "fullband",
                   "sub_band_crm_mask": "subband", "full_band_crm_mask": "fullsubnet",
                   "time_domain": "improved", "overlapped_chunk": "improved"}
# bucket lengths of the offline artifacts (samples at 16 kHz)
SECONDS = (0.05, 0.1)


class Setup:
    """A family's seeded port weights in a checkpoint, its config under a
    strategy and norm, the port's live Inferencer, and the JAX model on the
    same weights."""

    def __init__(self, root: Path, family: str, cell: str, norm: str, strategy: str):
        port_cls, jax_cls, path, args, acoustics = FAMILIES[family]
        args = {**args, "sequence_model": cell, "norm_type": norm}
        self.model = port_cls(**args, generator=torch.Generator().manual_seed(11)).eval()
        self.ckpt = root / f"{family}_{cell}.tar"
        torch.save(self.model.state_dict(), self.ckpt)
        self.acoustics = acoustics
        self.config = {"acoustics": dict(acoustics),
                       "inferencer": {"type": strategy, "args": {"n_neighbor": 3}},
                       "model": {"path": path, "args": args}}
        self.live = Inferencer(self.config, str(self.ckpt), None, device="cpu")
        self.jax_model = jax_cls(**args)
        self.params = jax.tree.map(jnp.asarray, jax_params_from_state_dict(
            self.model.state_dict()))


class Artifacts:
    """Exported artifacts and their setups, each built once a module."""

    def __init__(self, root: Path):
        self.root = root
        self._setups: dict = {}
        self._built: dict = {}
        self._jax: dict = {}

    def setup(self, family: str, cell: str = "LSTM", norm: str = OFFLINE,
              strategy: str = "full_band_crm_mask") -> Setup:
        key = (family, cell, norm, strategy)
        if key not in self._setups:
            self._setups[key] = Setup(self.root, family, cell, norm, strategy)
        return self._setups[key]

    def offline(self, strategy: str, cell: str = "LSTM", batch: int = 1, seconds=SECONDS):
        """(artifact dir, setup) of an offline export under ``strategy``."""
        s = self.setup(STRATEGY_FAMILY[strategy], cell, OFFLINE, strategy)
        key = ("offline", strategy, cell, batch, len(seconds))
        if key not in self._built:
            out = self.root / "_".join(map(str, key))
            serving.export_enhancer(s.config, str(s.ckpt), out, seconds=seconds, batch=batch,
                                    device="cpu")
            self._built[key] = out
        return self._built[key], s

    def stream(self, family: str, cell: str = "LSTM", streams: int = 1):
        """(artifact dir, setup) of a streaming export."""
        strategy = "time_domain" if family == "improved" else "full_band_crm_mask"
        s = self.setup(family, cell, CUM, strategy)
        key = ("stream", family, cell, streams)
        if key not in self._built:
            out = self.root / "_".join(map(str, key))
            serving.export_streaming_enhancer(s.config, str(s.ckpt), out, streams=streams,
                                              device="cpu")
            self._built[key] = out
        return self._built[key], s

    def served(self, cls, out: Path):
        """The artifact in ``out`` loaded with ``cls``, once a module (a
        program's load is the slow part of these tests)."""
        key = ("served", out)
        if key not in self._built:
            self._built[key] = cls.load(out)
        return self._built[key]

    def jax(self, key, build):
        if key not in self._jax:
            self._jax[key] = build()
        return self._jax[key]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return Artifacts(tmp_path_factory.mktemp("serving"))


def noisy_wave(seed: int, samples: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000
    return (0.3 * np.sin(2 * np.pi * rng.uniform(200, 600) * t)
            + 0.05 * rng.standard_normal(samples)).astype(np.float32)


def stream_wave(enhancer, wave: np.ndarray, sizes) -> np.ndarray:
    """Push ``wave`` in blocks of the ragged ``sizes`` (cycled), then
    flush: the whole enhanced stream."""
    state, chunks, i, k = enhancer.init_state(), [], 0, 0
    while i < len(wave):
        size = sizes[k % len(sizes)]
        state, out = enhancer.push(state, wave[i : i + size])
        chunks.append(np.asarray(out))
        i, k = i + size, k + 1
    state, out = enhancer.flush(state)
    chunks.append(np.asarray(out))
    return np.concatenate(chunks)


# -- offline artifacts -----------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_bucketed_artifact_matches_live_and_jax(artifacts, cell, batch):
    """FullSubNet's ``full_band_crm_mask`` exported bucketed: utterances of
    three lengths (two buckets; at batch 2 a full and a partial call)
    against the live ``enhance_bucket`` of the same bucket and the JAX
    bucketed function on the same weights."""
    out, s = artifacts.offline("full_band_crm_mask", cell, batch)
    served = artifacts.served(serving.ServingModel, out)
    assert served.manifest["mode"] == "bucketed" and served.batch == batch
    assert served.lengths == [800, 1600]
    waves = [noisy_wave(seed, n) for seed, n in enumerate((500, 1300, 700))]
    got = served.enhance_batch(waves)
    jax_fn = artifacts.jax(("bucketed", cell), lambda: jax.jit(
        build_bucketed_enhance_fn(s.jax_model, s.acoustics)))
    for wave, enhanced in zip(waves, got, strict=True):
        bucket = served._pick_bucket(len(wave))
        assert enhanced.shape == wave.shape
        live = s.live.enhance_bucket([wave], bucket)[0]
        np.testing.assert_allclose(enhanced, live, atol=LIVE_ATOL, rtol=0)
        padded = np.zeros((1, bucket), np.float32)
        padded[0, : len(wave)] = wave
        want = np.asarray(jax_fn(s.params, jnp.asarray(padded), jnp.int32(len(wave))))
        np.testing.assert_allclose(enhanced, want[0, : len(wave)], atol=ATOL, rtol=RTOL)
    if batch == 1:  # enhance() is enhance_batch() of one
        np.testing.assert_array_equal(served.enhance(waves[1]), got[1])


@pytest.mark.parametrize("strategy", ["mag", "scaled_mask", "sub_band_crm_mask"])
def test_exact_artifact_matches_live_and_jax(artifacts, strategy):
    """A strategy that takes no true lengths exports a program a length:
    at those lengths against the live strategy and the JAX Inferencer's
    ``_<strategy>_fn`` (on a stand-in that holds the JAX model)."""
    out, s = artifacts.offline(strategy, seconds=SECONDS[-1:])
    served = artifacts.served(serving.ServingModel, out)
    assert served.manifest["mode"] == "exact" and served.manifest["strategy"] == strategy

    def build():
        stand_in = object.__new__(JaxInferencer)
        stand_in.acoustics = s.acoustics
        stand_in.inference_args = {"n_neighbor": 3}
        stand_in.model = s.jax_model
        stand_in._model_kwargs = model_call_kwargs(s.jax_model)
        return jax.jit(getattr(stand_in, f"_{strategy}_fn"))

    jax_fn = artifacts.jax(("exact", strategy), build)
    for seed, length in enumerate(served.lengths):
        wave = noisy_wave(seed, length)
        got = served.enhance(wave)
        assert got.shape == wave.shape
        live = getattr(s.live, strategy)(torch.from_numpy(wave[None]))
        np.testing.assert_allclose(got, live, atol=LIVE_ATOL, rtol=0)
        want = np.asarray(jax_fn(s.params, jnp.asarray(wave[None])))[0]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_time_domain_artifact_is_bucketed_on_valid_samples(artifacts):
    """Improved FullSubNet's ``time_domain`` exports bucketed (the model
    takes ``valid_samples``): against the live ``enhance_bucket`` and the
    JAX model's ``valid_samples`` form on the same weights."""
    out, s = artifacts.offline("time_domain")
    served = artifacts.served(serving.ServingModel, out)
    assert served.manifest["mode"] == "bucketed"
    jax_fn = artifacts.jax("time_domain", lambda: jax.jit(
        lambda params, noisy, tl: s.jax_model(params, noisy, valid_samples=tl)[:, 0]))
    for seed, length in enumerate((400, 1200)):
        wave = noisy_wave(seed, length)
        got = served.enhance(wave)
        bucket = served._pick_bucket(length)
        np.testing.assert_allclose(got, s.live.enhance_bucket([wave], bucket)[0],
                                   atol=LIVE_ATOL, rtol=0)
        padded = np.zeros((1, bucket), np.float32)
        padded[0, :length] = wave
        want = np.asarray(jax_fn(s.params, jnp.asarray(padded), jnp.asarray([length])))[0]
        np.testing.assert_allclose(got, want[:length], atol=ATOL, rtol=RTOL)


# -- streaming artifacts ---------------------------------------------------------------------


@pytest.mark.parametrize("family, cell", [("fullsubnet", "LSTM"), ("fullsubnet", "GRU"),
                                          ("improved", "LSTM")])
def test_streaming_artifact_matches_live_and_jax(artifacts, family, cell):
    """``StreamingServingModel`` with ragged pushes and ``flush`` against
    the live ``StreamingEnhancer`` and the JAX one on the same weights."""
    out, s = artifacts.stream(family, cell)
    served = artifacts.served(serving.StreamingServingModel, out)
    a = s.acoustics
    assert served.look_ahead == (0 if family == "improved" else 2)
    wave = noisy_wave(3, 1500)
    sizes = (37, 5, 100, 64)
    got = stream_wave(served, wave, sizes)
    live = stream_wave(StreamingEnhancer(s.live.model, a["n_fft"], a["hop_length"]), wave,
                       sizes)
    np.testing.assert_allclose(got, live, atol=LIVE_ATOL, rtol=0)
    jax_enh = artifacts.jax(("stream", family, cell), lambda: jax_streaming.StreamingEnhancer(
        s.jax_model, s.params, a["n_fft"], a["hop_length"]))
    want = stream_wave(jax_enh, wave, sizes)
    assert got.shape == want.shape and len(got) >= len(wave)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _multistream_run(ms, waves):
    """Three streams into two slots, a hop a tick: streams 0 and 1 start,
    1 idles for two ticks, 0 ends (``finish``) and stream 2 takes its slot
    (a reset mid-run) while 1 goes on, then both drain; returns {stream:
    its whole output}."""
    state = ms.init_state()
    got = {i: [] for i in range(3)}
    pos = dict.fromkeys(range(3), 0)
    slot_of = {0: ms.open_stream(state), 1: ms.open_stream(state)}
    live = {0, 1}

    def tick(idle=()):
        for stream in sorted(live - set(idle)):
            ms.push(state, slot_of[stream], waves[stream][pos[stream] : pos[stream] + ms.hop])
            pos[stream] += ms.hop
        for slot, samples in ms.poll(state).items():
            got[next(i for i in live if slot_of[i] == slot)].append(samples)

    for t in range(16):
        tick(idle=(1,) if t in (3, 4) else ())  # lane 1 sits masked
    ms.finish(state, slot_of[0])
    tick(idle=(1,))
    assert state["slots"][slot_of[0]] is None  # drained and freed
    live.discard(0)
    slot_of[2] = ms.open_stream(state)
    live.add(2)
    assert slot_of[2] == slot_of[0]
    for _ in range(14):
        tick()
    for stream in sorted(live):
        got[stream].append(ms.drain(state, slot_of[stream]))
    return {i: np.concatenate(c) for i, c in got.items()}


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_multistream_artifact_matches_live_and_jax(artifacts, cell):
    """``MultiStreamServingModel`` over two lanes, a slot reset mid-run and
    an idle lane, against the live ``MultiStreamEnhancer`` and the JAX one
    driven the same way."""
    out, s = artifacts.stream("fullsubnet", cell, streams=2)
    served = artifacts.served(serving.MultiStreamServingModel, out)
    assert served.max_streams == 2 and served.manifest["programs"].keys() == {
        "init", "reset", "hop"}
    a = s.acoustics
    waves = [noisy_wave(10 + i, 40 * a["hop_length"]) for i in range(3)]
    got = _multistream_run(served, waves)
    live = _multistream_run(MultiStreamEnhancer(s.live.model, a["n_fft"], a["hop_length"],
                                                max_streams=2), waves)
    jax_ms = artifacts.jax(("multi", cell), lambda: jax_streaming.MultiStreamEnhancer(
        s.jax_model, s.params, a["n_fft"], a["hop_length"], max_streams=2))
    want = _multistream_run(jax_ms, waves)
    for i in range(3):
        assert len(got[i]) > 0 and got[i].shape == live[i].shape == want[i].shape
        np.testing.assert_allclose(got[i], live[i], atol=LIVE_ATOL, rtol=0)
        np.testing.assert_allclose(got[i], want[i], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_programs_launch_the_registered_operators(artifacts, cell):
    """The programs hold K1's stages as ``torch.ops.fsn`` nodes (a GEMM a
    layer and the head, a walk a layer, for both stacks), not a trace of
    the plain arithmetic; the saved hop holds no weights and no example
    inputs (the weights are inputs, stored once beside the programs)."""
    walk = "lstm_fwd_walk" if cell == "LSTM" else "gru_fwd_walk"
    offline = artifacts.offline("full_band_crm_mask", cell)[0]
    stream = artifacts.stream("fullsubnet", cell)[0]
    hop = torch.export.load(stream / "stream_hop.pt2")
    assert not hop.state_dict and hop.example_inputs is None
    assert all(v.numel() < 1000 for v in hop.constants.values())
    bucketed = artifacts.served(serving.ServingModel, offline)._programs[800]
    for graph in (hop.graph, bucketed.graph):
        fsn = [str(n.target) for n in graph.nodes
               if n.op == "call_function" and str(n.target).startswith("fsn.")]
        assert fsn.count("fsn.fwd_gemm.default") == 6 and fsn.count(f"fsn.{walk}.default") == 4
        assert len(fsn) == 10
    for out in (offline, stream):
        assert sorted(p.name for p in out.iterdir() if p.suffix == ".pt") == ["weights.pt"]


# -- refusals ----------------------------------------------------------------------------------


def _bucketed(artifacts):
    return artifacts.served(serving.ServingModel, artifacts.offline("full_band_crm_mask")[0])


def _too_short(artifacts):
    _bucketed(artifacts).enhance(np.zeros(32, np.float32))


def _no_bucket(artifacts):
    _bucketed(artifacts).enhance(np.zeros(1580, np.float32))


def _no_exact_length(artifacts):
    out = artifacts.offline("mag", seconds=SECONDS[-1:])[0]
    artifacts.served(serving.ServingModel, out).enhance(np.zeros(1000, np.float32))


def _wrong_format(artifacts):
    serving.ServingModel.load(artifacts.stream("fullsubnet")[0])


def _wrong_device(artifacts):
    serving.ServingModel.load(artifacts.offline("full_band_crm_mask")[0], device="cuda")


def _export(strategy, batch=1, streaming=False):
    def run(artifacts):
        s = artifacts.setup(STRATEGY_FAMILY[strategy], "LSTM", OFFLINE, strategy)
        out = artifacts.root / f"refused_{strategy}_{batch}_{streaming}"
        if streaming:
            serving.export_streaming_enhancer(s.config, str(s.ckpt), out, device="cpu")
        else:
            serving.export_enhancer(s.config, str(s.ckpt), out, seconds=SECONDS, batch=batch,
                                    device="cpu")
    return run


def _not_empty(artifacts):
    out, s = artifacts.offline("full_band_crm_mask")
    serving.export_enhancer(s.config, str(s.ckpt), out, seconds=SECONDS, device="cpu")


@pytest.mark.parametrize("refused, error, match", [
    (_export("overlapped_chunk"), ValueError, "not exportable"),
    (_export("mag", batch=2), ValueError, "batch > 1 export needs the bucketed mode"),
    (_export("full_band_crm_mask", streaming=True), ValueError,
     "not streamable: streaming requires a cumulative normalization"),
    (_too_short, ValueError, "too short"),
    (_no_bucket, ValueError, "no bucket >= 1612"),
    (_no_exact_length, ValueError, "no program for length 1000"),
    (_wrong_format, ValueError, "expected 'fullsubnet_tpu_torch.serving/1'"),
    (_wrong_device, ValueError, "exported on cpu and runs only there, not on cuda"),
    (_not_empty, FileExistsError, "is not empty"),
], ids=["overlapped_chunk", "exact_batch", "offline_norm_stream", "too_short", "no_bucket",
        "no_exact_length", "format", "device", "not_empty"])
def test_refusals(artifacts, refused, error, match):
    with pytest.raises(error, match=match):
        refused(artifacts)


def test_overwrite_replaces_an_artifact(artifacts, tmp_path):
    s = artifacts.setup("fullsubnet")
    (tmp_path / "stale.txt").write_text("x")
    manifest = serving.export_enhancer(s.config, str(s.ckpt), tmp_path, seconds=(0.05,),
                                       overwrite=True, device="cpu")
    assert not (tmp_path / "stale.txt").exists()
    assert manifest["lengths"] == [800] and manifest["export_device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["format"] == "fullsubnet_tpu_torch.serving/1"
    assert json.loads((tmp_path / "manifest.json").read_text()) == manifest


# -- serving without the model's code ---------------------------------------------------------

# loads and serves artifacts where importing jax, the JAX package, the
# port's models, engines, Inferencer or trainer fails (a finder that
# refuses them); writes what it served
_SERVE = """
import importlib.abc, sys
import numpy as np

REFUSED = ("jax", "jaxlib", "fullsubnet_tpu", "fullsubnet_tpu_torch.models",
           "fullsubnet_tpu_torch.infer.streaming", "fullsubnet_tpu_torch.infer.inferencer",
           "fullsubnet_tpu_torch.train")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ModuleNotFoundError(f"{name} is blocked")

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)
from fullsubnet_tpu_torch.serving import ServingModel, StreamingServingModel

offline, stream, out = sys.argv[1:]
wave = np.load(out + "/wave.npy")
np.save(out + "/offline.npy", ServingModel.load(offline).enhance(wave))
served = StreamingServingModel.load(stream)
state, first = served.push(served.init_state(), wave)
state, tail = served.flush(state)
np.save(out + "/stream.npy", np.concatenate([first, tail]))
bad = sorted(m for m in sys.modules if any(m == r or m.startswith(r + ".") for r in REFUSED))
sys.exit(f"imported {bad}" if bad else 0)
"""


def test_serving_needs_no_model_code(artifacts, tmp_path):
    """The served outputs of the subprocess against the live paths."""
    offline, s = artifacts.offline("full_band_crm_mask", "GRU")
    stream, s_stream = artifacts.stream("fullsubnet", "GRU")
    wave = noisy_wave(5, 1000)
    np.save(tmp_path / "wave.npy", wave)
    run = subprocess.run([sys.executable, "-c", _SERVE, str(offline), str(stream), str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stderr[-3000:]
    np.testing.assert_allclose(np.load(tmp_path / "offline.npy"),
                               s.live.enhance_bucket([wave], 1600)[0], atol=LIVE_ATOL, rtol=0)
    live = StreamingEnhancer(s_stream.live.model, 64, 32)
    state, first = live.push(live.init_state(), wave)
    state, tail = live.flush(state)
    np.testing.assert_allclose(np.load(tmp_path / "stream.npy"), np.concatenate([first, tail]),
                               atol=LIVE_ATOL, rtol=0)
