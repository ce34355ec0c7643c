"""Build a clean-speech scp list for training (counterpart of
``tools/preprocessing_dataset.py``):

    python -m fullsubnet_tpu_torch.tools.preprocessing_dataset \
        --dataset_dir /data/clean --output clean_0.6.txt \
        --target_hours 500 --activity_threshold 0.6

It walks a clean speech corpus and keeps the files that last at least
``--min_duration`` seconds, do not clip, and are voiced enough
(``activity_detector`` at least ``--activity_threshold``), until they add
up to ``--target_hours``.
"""

import argparse
from pathlib import Path

from fullsubnet_tpu_torch.acoustics.feature import activity_detector, is_clipped
from fullsubnet_tpu_torch.data.datasets import find_audio_files
from fullsubnet_tpu_torch.data.wavio import read_wav


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_dir", required=True, type=str)
    parser.add_argument("--output", required=True, type=str)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--min_duration", type=float, default=3.0)
    parser.add_argument("--activity_threshold", type=float, default=0.6)
    parser.add_argument("--target_hours", type=float, default=1e9)
    args = parser.parse_args(argv)

    paths = find_audio_files(Path(args.dataset_dir).expanduser().absolute())
    print(f"Found {len(paths)} candidate files.")
    accumulated_seconds = 0.0
    target_seconds = args.target_hours * 3600
    kept = []
    for p in paths:
        try:
            y, sr = read_wav(p, sr=args.sr, mono=True)
        except Exception as e:  # an unreadable file is skipped, as in the reference
            print(f"[skip] {p}: {e}")
            continue
        duration = len(y) / sr
        if duration < args.min_duration or is_clipped(y):
            continue
        if activity_detector(y, fs=sr) < args.activity_threshold:
            continue
        kept.append(p)
        accumulated_seconds += duration
        if accumulated_seconds >= target_seconds:
            break

    out = Path(args.output).expanduser().absolute()
    out.write_text("\n".join(kept) + "\n")
    print(f"Kept {len(kept)} files ({accumulated_seconds / 3600:.2f} h) -> {out}")


if __name__ == "__main__":
    main()
