"""Audio-seconds a second of the window, as ``enhance_audio_s_per_s`` reads
them, for enhancement one clip a call: the inverse of the real-time
factor. A metric of its own, because the host's share of a one-clip call
spreads its runs more than a batched call's, and its bound should not
loosen the batched cells'."""

from pathlib import Path

from portbench.run import reader

read = reader("enhance_audio_s_per_s", Path(__file__).resolve().parents[2])
