"""Remove the silent segments of paired noisy/clean wavs by alignment
files (counterpart of ``tools/delete_silence.py``):

    python -m fullsubnet_tpu_torch.tools.delete_silence \
        --noisy_dir noisy/ --clean_dir clean/ --text_dir txt/ \
        --dist_dir out/ [--prefix single]

An alignment file ``<text_dir>/<mark>.wav.txt`` (``mark`` the first two
``_`` tokens of the wav's name) holds lines ``<label> <start_sample>
<end_sample>``; the segments not labelled ``sil`` of each pair are kept
and joined, into ``<dist_dir>/noisy`` and ``<dist_dir>/clean``.
"""

import argparse
import os
from pathlib import Path

import numpy as np

from fullsubnet_tpu_torch.data.datasets import find_audio_files
from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--noisy_dir", required=True)
    parser.add_argument("--clean_dir", required=True)
    parser.add_argument("--text_dir", required=True)
    parser.add_argument("--dist_dir", required=True)
    parser.add_argument("--prefix", default="")
    parser.add_argument("--sr", type=int, default=16000)
    args = parser.parse_args(argv)

    noisy_dir, clean_dir, text_dir, dist_dir = (
        Path(d).expanduser().absolute()
        for d in (args.noisy_dir, args.clean_dir, args.text_dir, args.dist_dir))
    (dist_dir / "noisy").mkdir(exist_ok=True, parents=True)
    (dist_dir / "clean").mkdir(exist_ok=True)

    for noisy_file_path in find_audio_files(noisy_dir):
        basename = os.path.basename(noisy_file_path)
        mark = "_".join(os.path.splitext(basename)[0].split("_")[0:2])
        if args.prefix and not mark.startswith(args.prefix):
            continue
        clean_file_path = clean_dir / basename
        txt_file_path = text_dir / (mark + ".wav.txt")
        if not clean_file_path.exists() or not txt_file_path.exists():
            print(f"[skip] missing pair for {basename}")
            continue

        noisy_wav, _ = read_wav(noisy_file_path, sr=args.sr)
        clean_wav, _ = read_wav(clean_file_path, sr=args.sr, mono=True)
        noisy_wav = np.atleast_2d(noisy_wav)
        keep_noisy, keep_clean = [], []
        for line in txt_file_path.read_text().splitlines():
            parts = line.split()
            if len(parts) != 3:
                continue
            name, start, end = parts[0], int(parts[1]), int(parts[2])
            if name != "sil":
                keep_noisy.append(noisy_wav[:, start:end])
                keep_clean.append(clean_wav[start:end])
        if not keep_clean:
            continue
        write_wav(dist_dir / "noisy" / basename, np.concatenate(keep_noisy, axis=-1), args.sr)
        write_wav(dist_dir / "clean" / basename, np.concatenate(keep_clean), args.sr)


if __name__ == "__main__":
    main()
