"""Offline metric computation (counterpart of ``tools/calculate_metrics.py``),
with no JAX and no joblib:

    python -m fullsubnet_tpu_torch.tools.calculate_metrics \
        -R /path/to/clean_dir_or_scp -E /path/to/enhanced_dir_or_scp \
        -M SI_SDR,STOI,WB_PESQ [-D dns_1] [--export_dir out/] [--n_jobs 8]

It pairs the estimated wavs with the reference wavs (two directories or
scp lists, by basename; ``-D dns_1``/``dns_2`` by the DNS file ids;
``--num_channels N`` for per-microphone estimates, channel 0 scored),
reads each pair once, computes each metric in one pool of ``--n_jobs``
spawned processes (here at ``--n_jobs`` 0 or 1), prints
each metric's mean and std, and with ``--export_dir`` writes
``<metric>.csv`` and ``<metric>.xlsx`` per metric (one row per file and a
``mean`` row).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from fullsubnet_tpu_torch.data.datasets import find_audio_files
from fullsubnet_tpu_torch.data.wavio import read_wav
from fullsubnet_tpu_torch.metrics import REGISTERED_METRICS
from fullsubnet_tpu_torch.utils import prepare_empty_dir
from fullsubnet_tpu_torch.xlsx import write_xlsx


def load_wav_paths_from_scp(scp_path: str) -> list[str]:
    with open(os.path.abspath(os.path.expanduser(scp_path))) as f:
        return [os.path.abspath(os.path.expanduser(ln.rstrip("\n"))) for ln in f]


def get_basename(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def shrink_multi_channel_path(full_dataset_list: list[str], num_channels: int) -> list[str]:
    """One path per utterance from a per-microphone list: the list is taken
    in blocks of ``num_channels`` files (``..._mic1.wav``, ``..._mic2.wav``)
    and each block stands as its first file with the trailing ``_micN``
    token removed."""
    if len(full_dataset_list) % num_channels:
        raise ValueError(f"{len(full_dataset_list)} files do not split into blocks of "
                         f"{num_channels} channels")
    return [f"{'_'.join(full_dataset_list[i].split('_')[:-1])}.wav"
            for i in range(0, len(full_dataset_list), num_channels)]


def check_two_aligned_list(a, b):
    if len(a) != len(b):
        raise ValueError(f"The length of two lists are not equal: {len(a)} vs {len(b)}")
    for z, (i, j) in enumerate(zip(a, b), start=1):
        if get_basename(i) != get_basename(j):
            raise ValueError(f"There are different names in {z}\n\t {i}\n\t{j}.")


def _dns_match(specific_dataset: str, est_path: str, ref_path: str) -> bool:
    est_base = get_basename(est_path)
    if specific_dataset == "dns_1":  # "clean_fileid_<id>" by the estimate's suffix
        return "clean_" + "_".join(est_base.split("_")[-2:]) == get_basename(ref_path)
    if specific_dataset == "dns_2":
        return f"synthetic_clean_fileid_{est_base.split('_')[-1]}" == get_basename(ref_path)
    raise NotImplementedError(f"Not supported specific dataset {specific_dataset}.")


def pre_processing(est, ref, specific_dataset=None, num_channels=1):
    """(reference paths, estimated paths), aligned pair by pair."""
    ref = Path(ref).expanduser().absolute()
    est = Path(est).expanduser().absolute()
    reference_wav_paths = find_audio_files(ref) if ref.is_dir() else load_wav_paths_from_scp(str(ref))
    estimated_wav_paths = find_audio_files(est) if est.is_dir() else load_wav_paths_from_scp(str(est))

    if num_channels > 1:
        # channel 0 of each utterance's per-mic files, aligned by the names
        # without _micN against the single-channel references
        if specific_dataset:
            raise NotImplementedError("--num_channels > 1 is only supported with directory/scp "
                                      "alignment, not with -D dataset matching.")
        shrunk = shrink_multi_channel_path(estimated_wav_paths, num_channels)
        check_two_aligned_list(reference_wav_paths, shrunk)
        return reference_wav_paths, estimated_wav_paths[::num_channels]

    if not specific_dataset:
        check_two_aligned_list(reference_wav_paths, estimated_wav_paths)
        return reference_wav_paths, estimated_wav_paths
    reordered = [e for r in reference_wav_paths for e in estimated_wav_paths
                 if _dns_match(specific_dataset, e, r)]
    # a missing or doubly matched estimate is an error, not a silent shift
    # that pairs every later estimate with the wrong reference
    if len(reordered) != len(reference_wav_paths):
        raise ValueError(f"{specific_dataset} matching paired {len(reordered)} estimated files "
                         f"with {len(reference_wav_paths)} references; check for missing or "
                         "ambiguously named estimated files")
    return reference_wav_paths, reordered


def load_pair(ref_path: str, est_path: str, sr: int):
    """(file name, reference, estimate) of one pair: the reference read as
    mono (the channel mean), the estimate's channel 0, both cut to the
    shorter."""
    ref_wav, _ = read_wav(ref_path, sr=sr, mono=True)
    est_wav, _ = read_wav(est_path, sr=sr, mono=False)
    if est_wav.ndim > 1:
        est_wav = est_wav[0]
    if len(ref_wav) != len(est_wav):
        print(f"[Warning] ref {len(ref_wav)} and est {len(est_wav)} are not in the same length")
    n = min(len(ref_wav), len(est_wav))
    return get_basename(ref_path), ref_wav[:n], est_wav[:n]


def compute_metric(pairs, sr, metric_type, pool=None):
    """[(file name, metric)] of every :func:`load_pair` triple, in order:
    in ``pool`` (a ``concurrent.futures`` executor), or here without one.
    A worker receives the two waveforms and imports ``metrics`` alone."""
    if metric_type not in REGISTERED_METRICS:
        raise ValueError(f"Unsupported metric: {metric_type}.")
    names, refs, ests = zip(*pairs) if pairs else ((), (), ())
    fn = functools.partial(REGISTERED_METRICS[metric_type], sr=sr)
    values = (pool.map if pool is not None else map)(fn, refs, ests)
    return [(name, float(v)) for name, v in zip(names, values)]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Calculate speech-enhancement metrics offline.")
    parser.add_argument("-R", "--reference", required=True, type=str)
    parser.add_argument("-E", "--estimated", required=True, type=str)
    parser.add_argument("-M", "--metric_types", default="SI_SDR,STOI", type=str,
                        help=f"Comma-separated; choose from {sorted(REGISTERED_METRICS)}")
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("-D", "--specific_dataset", type=str, default="",
                        help="dns_1 | dns_2 (manual est/ref alignment)")
    parser.add_argument("--export_dir", type=str, default="")
    parser.add_argument("--n_jobs", type=int, default=40)
    parser.add_argument("--num_channels", type=int, default=1,
                        help="Per-mic estimated files per utterance (…_mic1.wav …_micN.wav); "
                        "channel 0 is scored against the single-channel reference")
    args = parser.parse_args(argv)

    reference_wav_paths, estimated_wav_paths = pre_processing(
        args.estimated, args.reference, args.specific_dataset.lower() or None,
        num_channels=args.num_channels)
    export_dir = None
    if args.export_dir:
        export_dir = Path(args.export_dir).expanduser().absolute()
        prepare_empty_dir([export_dir])

    print(f"=== {args.estimated} === {args.reference} ===")
    pairs = [load_pair(r, e, args.sr) for r, e in zip(reference_wav_paths, estimated_wav_paths)]
    workers = min(args.n_jobs, len(pairs))
    # one pool of spawned processes serves every metric
    with (ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
          if workers > 1 else contextlib.nullcontext()) as pool:
        for metric_type in args.metric_types.split(","):
            _report(metric_type, compute_metric(pairs, args.sr, metric_type, pool), export_dir)


def _report(metric_type: str, rows, export_dir):
    """Print the metric's mean and std; with ``export_dir``, write its CSV
    and .xlsx."""
    values = [v for _, v in rows]
    print(f"{metric_type}: {np.mean(values):.4f} ± {np.std(values):.4f}")
    if export_dir:
        with open(export_dir / f"{metric_type}.csv", "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["filename", metric_type])
            writer.writerows(rows)
            writer.writerow(["mean", float(np.mean(values))])
        write_xlsx(export_dir / f"{metric_type}.xlsx", rows + [("mean", float(np.mean(values)))],
                   headers=("Speech", metric_type), sheet_name=metric_type)


if __name__ == "__main__":
    main()
