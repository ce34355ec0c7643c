"""Write a list of wav paths found under directories (counterpart of
``tools/find_wavs.py``):

    python -m fullsubnet_tpu_torch.tools.find_wavs --dirs a/noisy b/noisy \
        --output train.txt [--format plain|spk]

``plain`` writes one absolute path per line (the scp lists the training
dataset reads); ``spk`` writes the reference's annotated format.
"""

import argparse
from pathlib import Path

from fullsubnet_tpu_torch.data.datasets import find_audio_files


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dirs", nargs="+", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--format", choices=["plain", "spk"], default="plain")
    args = parser.parse_args(argv)

    file_path_list = []
    for dataset_dir in args.dirs:
        file_path_list += find_audio_files(Path(dataset_dir).expanduser().absolute())
    print(f"Length: {len(file_path_list)}")
    out = Path(args.output).expanduser().absolute()
    with open(out, "w") as f:
        for i, line in enumerate(file_path_list):
            f.write(f"spk1___{i}___utt1___90___0_300\t{line}\n" if args.format == "spk"
                    else f"{line}\n")
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
