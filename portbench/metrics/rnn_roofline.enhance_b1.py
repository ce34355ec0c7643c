"""``rnn_roofline.enhance``'s reading, for the cells that report
``enhance_b1_audio_s_per_s``."""

from pathlib import Path

from portbench.run import reader

read = reader("rnn_roofline.enhance", Path(__file__).resolve().parents[2])
