"""Serving artifacts (counterpart of ``fullsubnet_tpu/serving.py``): the
inference paths exported with ``torch.export``.

A serving process should not need the model's source code: this module
exports the whole inference compute path (STFT -> model -> cIRM
decompression -> mask -> iSTFT) as ``torch.export`` programs, saved with
``torch.export.save``. K1 and K1-GRU enter a program as the registered
operators ``torch.ops.fsn.fwd_gemm``, ``lstm_fwd_walk`` and
``gru_fwd_walk`` (``ops/subband_lstm.py``), one node a launch, so a loaded
program launches the same hand-written kernels as the live path, counted
by the same wrappers. The weights are stored once (``weights.pt``, a state
dict) and uploaded to the device once at load; every program takes them
as its first input.

Two offline modes, picked as the JAX module picks them:

* ``bucketed``: the models that take true lengths (``bucketed_capable``
  under ``full_band_crm_mask``; ``time_domain_bucketed_capable`` under
  ``time_domain``). A program per bucket length takes ``(weights,
  wave [batch, bucket], true_len)`` and reproduces, for any length in the
  bucket, the unpadded enhancement (``infer/inferencer.py``'s
  ``bucketed_enhance`` and ``bucketed_time_domain``).
* ``exact``: every other strategy; one program per exact input length.

``--streaming`` exports the real-time path of
:class:`infer.streaming.StreamingEnhancer` as ``stream_init`` (staged
samples -> device state) and ``stream_hop`` ((weights, state, hop) ->
(state, enhanced hop)), driven by :class:`StreamingServingModel` with the
live enhancer's host (``infer/host.py``); with ``--streams N`` the
concurrent host of :class:`infer.streaming.MultiStreamEnhancer`:
``stream_init`` (no input), ``stream_reset`` (one lane) and ``stream_hop``
(every lane under an active mask), driven by
:class:`MultiStreamServingModel`.

A program runs on the device it was exported on (``--device``, the card
by default). Loading and serving import only this module, the numpy hosts
and the module that registers the operators: no model, engine,
Inferencer, trainer or ``jax``. The export entry points import the
Inferencer and the engines when they are called.

    python -m fullsubnet_tpu_torch.serving -C inference.toml -M model.tar -O served/ \\
        [--seconds 1,2,4,8,16,30] [--batch N] [--streaming [--streams N]] [--overwrite] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

# leaf imports only: loading and serving an artifact must work without the
# model's source code (the export entry points import it lazily)
from fullsubnet_tpu_torch.infer.host import (
    MultiStreamHost,
    StreamingWaveHost,
    pad_bucket_batch,
)

# registers torch.ops.fsn.*, which the programs call; torch.export.load
# cannot resolve a program's nodes without them
from fullsubnet_tpu_torch.ops import subband_lstm  # noqa: F401

_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"
FORMAT = "fullsubnet_tpu_torch.serving/1"
STREAM_FORMAT = "fullsubnet_tpu_torch.serving-stream/1"
MULTISTREAM_FORMAT = "fullsubnet_tpu_torch.serving-multistream/1"


class _Bound(torch.nn.Module):
    """``fn`` called with the model as a submodule, so that
    ``torch.func.functional_call`` can swap the model's weights."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model = model
        self.__dict__["fn"] = fn  # a plain attribute

    def forward(self, *args):
        return self.fn(*args)


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``fn(*args)``, or with a
    ``model``, ``fn(*args)`` on the state dict given as the first input in
    place of the model's weights. The model is kept out of this module's
    tree, so its weights enter the program as inputs and not as constants
    of each program."""

    def __init__(self, fn, model: torch.nn.Module | None = None):
        super().__init__()
        self.__dict__["bound"] = None if model is None else _Bound(model, fn)
        self.__dict__["fn"] = fn

    def forward(self, *args):
        if self.bound is None:
            return self.fn(*args)
        weights, *rest = args
        return torch.func.functional_call(
            self.bound, {f"model.{k}": v for k, v in weights.items()}, tuple(rest))


def _export(fn, args, model=None, weights=None) -> torch.export.ExportedProgram:
    inputs = args if model is None else (weights, *args)
    return torch.export.export(_Program(fn, model), tuple(inputs), strict=False)


def _prepare_out_dir(out_dir, overwrite: bool) -> pathlib.Path:
    out = pathlib.Path(out_dir).expanduser().absolute()
    if out.exists() and any(out.iterdir()):
        if not overwrite:
            raise FileExistsError(f"{out} is not empty (pass overwrite=True)")
        import shutil

        shutil.rmtree(out)
    out.mkdir(parents=True, exist_ok=True)
    return out


def _build_inferencer(config: dict, checkpoint_path: str, device):
    """The Inferencer (model, weights and acoustics only: the datasets
    dropped) on ``device``, and the model's state dict to store."""
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    cfg = dict(config)
    cfg.pop("dataset", None)
    cfg.pop("inference_dataset", None)
    inf = Inferencer(cfg, checkpoint_path, None, device=device)
    weights = {k: v.detach() for k, v in inf.model.state_dict().items()}
    return inf, weights


def _save(out: pathlib.Path, exported: dict, weights: dict, prefix: str) -> dict:
    """Write each program and the weights; returns {key: file name}."""
    names = {}
    for key, program in exported.items():
        names[key] = f"{prefix}{key}.pt2"
        # the export's example inputs, the weights among them, would be
        # saved in every program
        program.example_inputs = None
        torch.export.save(program, out / names[key])
    torch.save({k: v.cpu() for k, v in weights.items()}, out / _WEIGHTS)
    return names


def _manifest_tail(config: dict, device: torch.device) -> dict:
    return {
        "model_path": config["model"].get("path", ""),
        "torch_version": torch.__version__,
        "export_device": device.type,
    }


def _write_manifest(out: pathlib.Path, manifest: dict) -> dict:
    (out / _MANIFEST).write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


def _load_artifacts(artifact_dir, expected_format: str, device=None):
    """(manifest, programs by key, the weights on the device) of an
    artifact directory. ``device`` defaults to the one the artifact was
    exported on, the only one its programs run on."""
    root = pathlib.Path(artifact_dir).expanduser().absolute()
    manifest = json.loads((root / _MANIFEST).read_text())
    if manifest.get("format") != expected_format:
        raise ValueError(
            f"artifact format {manifest.get('format')!r} in {root} "
            f"(expected {expected_format!r})"
        )
    exported_on = manifest["export_device"]
    device = torch.device(exported_on if device is None else device)
    if device.type != exported_on:
        raise ValueError(f"the artifact in {root} was exported on {exported_on} and runs only "
                         f"there, not on {device.type}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the artifact in {root} was exported on cuda, but torch finds no "
                           "CUDA card here (cpu only)")
    programs = {}
    for key, name in manifest["programs"].items():
        programs[key] = torch.export.load(root / name).module()
        # the serving classes make every input of the shapes the manifest
        # fixes, and a state is a program's own output: no per-call check
        # of each input against the signature (a few hundred µs of host
        # time a call, on the streaming hop's critical path)
        programs[key].validate_inputs = False
    # upload once: no program call transfers the weights again
    weights = torch.load(root / _WEIGHTS, map_location=device, weights_only=True)
    return manifest, programs, weights


def export_enhancer(
    config: dict,
    checkpoint_path: str,
    out_dir: str | pathlib.Path,
    seconds=(1, 2, 4, 8, 16, 30),
    batch: int = 1,
    overwrite: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Export the config's inference strategy as serving artifacts.

    Writes to ``out_dir``: ``program_<L>.pt2`` per wave length L,
    ``weights.pt`` and ``manifest.json``. Returns the manifest.

    ``batch`` > 1 (bucketed mode only) exports programs that enhance
    ``batch`` utterances a call with a true length each;
    ``ServingModel.enhance_batch`` drives them. The programs run on
    ``device`` (the card by default), where they are traced.
    """
    from fullsubnet_tpu_torch.infer.inferencer import (
        bucketed_capable,
        bucketed_enhance,
        bucketed_time_domain,
        time_domain_bucketed_capable,
    )

    out = _prepare_out_dir(out_dir, overwrite)
    inf, weights = _build_inferencer(config, checkpoint_path, device)
    a = inf.acoustics
    sr = a["sr"]

    td_bucketed = inf.strategy == "time_domain" and time_domain_bucketed_capable(inf.model)
    mode = ("bucketed" if bucketed_capable(inf.model, inf.strategy) or td_bucketed
            else "exact")
    if batch != 1 and mode != "bucketed":
        raise ValueError(
            "batch > 1 export needs the bucketed mode (per-example "
            f"true-length masking); {inf.strategy!r} exports exact-length "
            "programs only"
        )
    if td_bucketed:
        def fn(noisy, true_len):
            return bucketed_time_domain(inf.model, noisy, true_len)
    elif mode == "bucketed":
        def fn(noisy, true_len):
            return bucketed_enhance(inf.model, a, noisy, true_len)
    else:
        fn = getattr(inf, f"_{inf.strategy}_fn", None)
        if fn is None:  # overlapped_chunk: a host-side chunking loop
            raise ValueError(
                f"strategy {inf.strategy!r} is not exportable (it is a "
                "host-side loop, not one program); exportable: "
                "mag, scaled_mask, sub_band_crm_mask, full_band_crm_mask, "
                "time_domain"
            )

    lengths = sorted({int(round(s * sr)) for s in seconds})
    exported = {}
    for length in lengths:
        args = [torch.zeros(batch, length, device=inf.device)]
        if mode == "bucketed":  # one shared length at batch 1, else one a row
            shape = () if batch == 1 else (batch,)
            args.append(torch.full(shape, length // 2, dtype=torch.int64, device=inf.device))
        exported[str(length)] = _export(fn, args, inf.model, weights)

    return _write_manifest(out, {
        "format": FORMAT,
        "mode": mode,
        "batch": batch,
        "strategy": inf.strategy,
        "sr": sr,
        "n_fft": a["n_fft"],
        "hop_length": a["hop_length"],
        "win_length": a["win_length"],
        "lengths": lengths,
        "programs": _save(out, exported, weights, "program_"),
        **_manifest_tail(config, inf.device),
    })


def export_streaming_enhancer(
    config: dict,
    checkpoint_path: str,
    out_dir: str | pathlib.Path,
    overwrite: bool = False,
    streams: int = 1,
    device: str | torch.device = "cuda",
) -> dict:
    """Export the real-time streaming path as serving artifacts.

    Writes ``stream_init.pt2`` (``buf [n_fft - hop] -> device state``),
    ``stream_hop.pt2`` (``(weights, state, hop [hop]) -> (state,
    enhanced [hop])``), ``weights.pt`` and ``manifest.json``; load with
    :meth:`StreamingServingModel.load`. Eligibility is the live
    ``StreamingEnhancer``'s: any of the four model families, with a
    cumulative normalization.

    ``streams > 1`` exports the concurrent serving host instead (load with
    :meth:`MultiStreamServingModel.load`): ``stream_init`` takes no input
    and returns the state of every lane, ``stream_reset`` (``(state, slot,
    buf) -> state``) starts one slot's lane, and ``stream_hop``
    (``(weights, state, hops [streams, hop], active [streams]) -> (state,
    enhanced [streams, hop])``) advances every lane under an active mask in
    one call: the programs of
    :class:`fullsubnet_tpu_torch.infer.streaming.MultiStreamEnhancer`. The
    programs run on ``device`` (the card by default)."""
    from fullsubnet_tpu_torch.infer.streaming import MultiStreamEnhancer, StreamingEnhancer

    out = _prepare_out_dir(out_dir, overwrite)
    inf, weights = _build_inferencer(config, checkpoint_path, device)
    a = inf.acoustics
    try:
        # win_length != n_fft raises in the enhancer (the live streaming
        # path and this export share the full-length-window requirement)
        if streams > 1:
            menh = MultiStreamEnhancer(inf.model, a["n_fft"], a["hop_length"],
                                       max_streams=streams, win_length=a["win_length"])
            enh = menh._enh
        else:
            enh = StreamingEnhancer(inf.model, a["n_fft"], a["hop_length"],
                                    win_length=a["win_length"])
    except (TypeError, AssertionError, ValueError) as e:
        raise ValueError(f"model is not streamable: {e}") from e

    buf = torch.zeros(enh.n_fft - enh.hop, device=inf.device)
    if streams > 1:
        state = menh._init_batched_impl()
        slot = torch.zeros((), dtype=torch.int64, device=inf.device)
        hops = torch.zeros(streams, enh.hop, device=inf.device)
        active = torch.ones(streams, dtype=torch.bool, device=inf.device)
        exported = {
            "init": _export(menh._init_batched_impl, ()),
            "reset": _export(menh._reset_impl, (state, slot, buf)),
            "hop": _export(menh._hop_batch_impl, (state, hops, active), inf.model, weights),
        }
        fmt = MULTISTREAM_FORMAT
    else:
        def init_fn(buf):
            return enh._init_device_state(buf[None])

        def hop_fn(state, hop):
            state, out = enh._hop_lanes(state, hop[None])
            return state, out[0]

        hop = torch.zeros(enh.hop, device=inf.device)
        exported = {
            "init": _export(init_fn, (buf,)),
            "hop": _export(hop_fn, (init_fn(buf), hop), inf.model, weights),
        }
        fmt = STREAM_FORMAT

    return _write_manifest(out, {
        "format": fmt,
        "sr": a["sr"],
        "n_fft": a["n_fft"],
        "hop_length": a["hop_length"],
        "look_ahead": int(enh.look_ahead),
        "streams": int(streams),
        "programs": _save(out, exported, weights, "stream_"),
        **_manifest_tail(config, inf.device),
    })


class ServingModel:
    """Loads an exported artifact directory and serves enhancement without
    the model's source: ``ServingModel.load(dir).enhance(wave)``."""

    def __init__(self, manifest: dict, programs: dict, weights: dict):
        self.manifest = manifest
        self._programs = programs  # length -> the loaded program
        self._weights = weights
        self.sr = manifest["sr"]
        self.batch = int(manifest.get("batch", 1))
        self.device = torch.device(manifest["export_device"])

    @classmethod
    def load(cls, artifact_dir, device=None) -> ServingModel:
        manifest, programs, weights = _load_artifacts(artifact_dir, FORMAT, device)
        return cls(manifest, {int(length): p for length, p in programs.items()}, weights)

    @property
    def lengths(self):
        return sorted(self._programs)

    def _pick_bucket(self, length: int) -> int:
        n_fft = self.manifest["n_fft"]
        if length <= n_fft // 2:
            raise ValueError(
                f"utterance too short for the bucketed artifact "
                f"({length} <= n_fft//2 = {n_fft // 2})"
            )
        # headroom for the tail reflection: true_len + n_fft//2 must fit
        # inside the bucket
        need = length + n_fft // 2
        fits = [b for b in self.lengths if b >= need]
        if not fits:
            raise ValueError(f"no bucket >= {need} samples (available: {self.lengths})")
        return fits[0]

    def _tensor(self, value: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(value).to(self.device)

    def _call(self, length: int, *args: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = self._programs[length](self._weights, *map(self._tensor, args))
            return out.cpu().numpy()

    def enhance_batch(self, waves) -> list:
        """List of float32 waves (any lengths) -> list of enhanced waves,
        in order. Bucketed artifacts only: utterances are grouped by
        bucket and run ``self.batch`` a program call (filler rows for
        partial batches, as the program's batch is fixed)."""
        if self.manifest["mode"] != "bucketed":
            raise ValueError("enhance_batch needs a bucketed artifact")
        waves = [np.asarray(w, np.float32).reshape(-1) for w in waves]
        out: list = [None] * len(waves)
        groups: dict[int, list[int]] = {}
        for i, w in enumerate(waves):
            groups.setdefault(self._pick_bucket(len(w)), []).append(i)
        for bucket, idxs in groups.items():
            for c in range(0, len(idxs), self.batch):
                chunk = idxs[c : c + self.batch]
                padded, lengths = pad_bucket_batch([waves[i] for i in chunk], self.batch, bucket)
                lengths = lengths.astype(np.int64)
                res = self._call(bucket, padded,
                                 np.asarray(lengths[0]) if self.batch == 1 else lengths)
                for r, i in enumerate(chunk):
                    out[i] = res[r, : len(waves[i])]
        return out

    def enhance(self, noisy: np.ndarray) -> np.ndarray:
        """wave [L] or [1, L] float32 -> enhanced [L] float32."""
        wav = np.atleast_2d(np.asarray(noisy, np.float32))
        if wav.shape[0] != 1:
            raise ValueError(f"expected mono [L] or [1, L], got {wav.shape}")
        length = wav.shape[-1]
        if self.manifest["mode"] == "bucketed":
            if self.batch != 1:
                return self.enhance_batch([wav[0]])[0]
            bucket = self._pick_bucket(length)
            padded = np.zeros((1, bucket), np.float32)
            padded[0, :length] = wav[0]
            return self._call(bucket, padded, np.asarray(length, np.int64))[0, :length]
        if length not in self._programs:
            raise ValueError(
                f"exact-mode artifact has no program for length {length} "
                f"(available: {self.lengths})"
            )
        return self._call(length, wav)[0]

    __call__ = enhance


class _StreamPrograms:
    """The loaded streaming programs, the weights and the stream's shape
    from the manifest."""

    def __init__(self, manifest: dict, programs: dict, weights: dict):
        self.manifest = manifest
        self._programs = programs
        self._weights = weights
        self.device = torch.device(manifest["export_device"])
        self.sr = manifest["sr"]
        self.n_fft = manifest["n_fft"]
        self.hop = manifest["hop_length"]
        self.look_ahead = manifest["look_ahead"]

    def _tensor(self, samples) -> torch.Tensor:
        return torch.from_numpy(np.asarray(samples, np.float32)).to(self.device)


class StreamingServingModel(_StreamPrograms, StreamingWaveHost):
    """Real-time enhancement from an exported streaming artifact: the
    push/flush protocol of the live ``StreamingEnhancer`` (the same host:
    start reflect pad, look-ahead warm-up discard), with every device call
    going through the loaded programs, so no model source is needed in the
    serving process."""

    @classmethod
    def load(cls, artifact_dir, device=None) -> StreamingServingModel:
        return cls(*_load_artifacts(artifact_dir, STREAM_FORMAT, device))

    @torch.inference_mode()
    def _dev_init(self, buf):
        return self._programs["init"](self._tensor(buf))

    @torch.inference_mode()
    def _dev_hop(self, dstate, hop_samples):
        dstate, out = self._programs["hop"](self._weights, dstate, self._tensor(hop_samples))
        return dstate, out.cpu().numpy()


class MultiStreamServingModel(_StreamPrograms, MultiStreamHost):
    """Concurrent real-time serving from an exported multi-stream
    artifact: the slot/push/poll/drain protocol of the live
    :class:`fullsubnet_tpu_torch.infer.streaming.MultiStreamEnhancer` (one
    batched device call a tick for every live stream), with every device
    call going through the loaded programs, so no model source is needed
    in the serving process."""

    def __init__(self, manifest: dict, programs: dict, weights: dict):
        super().__init__(manifest, programs, weights)
        self.max_streams = int(manifest["streams"])

    @classmethod
    def load(cls, artifact_dir, device=None) -> MultiStreamServingModel:
        return cls(*_load_artifacts(artifact_dir, MULTISTREAM_FORMAT, device))

    @torch.inference_mode()
    def _dev_init_batched(self):
        return self._programs["init"]()

    @torch.inference_mode()
    def _dev_reset(self, bstate, slot, buf):
        slot = torch.tensor(slot, dtype=torch.int64, device=self.device)
        return self._programs["reset"](bstate, slot, self._tensor(buf))

    @torch.inference_mode()
    def _dev_hop_batch(self, bstate, hops, active):
        active = torch.from_numpy(np.asarray(active, bool)).to(self.device)
        bstate, out = self._programs["hop"](self._weights, bstate, self._tensor(hops), active)
        return bstate, out.cpu().numpy()


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Export a serving artifact (torch.export programs) for a trained checkpoint"
    )
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("-M", "--model_checkpoint_path", required=True)
    parser.add_argument("-O", "--output_dir", required=True)
    parser.add_argument(
        "--seconds", type=str, default="1,2,4,8,16,30",
        help="comma-separated bucket sizes in seconds",
    )
    parser.add_argument(
        "--batch", type=int, default=1,
        help="utterances per program call (bucketed mode only)",
    )
    parser.add_argument(
        "--streaming", action="store_true",
        help="export the real-time per-hop streaming path instead of "
        "whole-utterance programs (--seconds/--batch ignored)",
    )
    parser.add_argument(
        "--streams", type=int, default=1,
        help="with --streaming: export the concurrent serving host "
        "(N stream lanes advanced per batched device call)",
    )
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="the device the programs run on (cuda, or cpu)")
    args = parser.parse_args(argv)
    if args.streams > 1 and not args.streaming:
        parser.error("--streams requires --streaming (the concurrent "
                     "host is a real-time streaming export)")

    from fullsubnet_tpu_torch.config import load_config

    config = load_config(args.configuration)
    if args.streaming:
        manifest = export_streaming_enhancer(
            config, args.model_checkpoint_path, args.output_dir,
            overwrite=args.overwrite, streams=args.streams, device=args.device,
        )
    else:
        seconds = [float(s) for s in args.seconds.split(",") if s]
        manifest = export_enhancer(
            config, args.model_checkpoint_path, args.output_dir,
            seconds=seconds, batch=args.batch, overwrite=args.overwrite, device=args.device,
        )
    print(json.dumps(manifest, indent=1))


if __name__ == "__main__":
    main()
