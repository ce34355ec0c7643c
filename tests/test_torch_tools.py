"""The port's offline tools (``fullsubnet_tpu_torch.tools``) against the
repo's JAX tools (``tools/*.py``) on the same seeded wavs: the metric CSV
rows and the .xlsx cells of ``calculate_metrics`` (directory and scp
inputs, ``dns_1`` alignment), the lists of ``find_wavs`` and
``preprocessing_dataset``, and the wavs of ``delete_silence``. The port's
tools all run in one subprocess in which ``import jax`` and ``import
joblib`` fail; the JAX tools run here."""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 16000

# the port's tools, run where importing jax or joblib fails (a finder that
# refuses them: a None in sys.modules would also break scipy, which looks
# for a loaded jax by its sys.modules entry); the script fails if a tool
# reaches the JAX package
_RUNNER = """
import importlib, importlib.abc, json, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "joblib"):
            raise ModuleNotFoundError(f"{name} is blocked")

sys.meta_path.insert(0, Refuse())
for name, argv in json.loads(sys.argv[1]):
    importlib.import_module("fullsubnet_tpu_torch.tools." + name).main(argv)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "joblib",
                                                            "fullsubnet_tpu"))
sys.exit(f"imported {bad}" if bad else 0)
"""


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _speech(seconds, seed, f0=220.0):
    """Voiced bursts with a little noise."""
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(seed)
    bursts = (np.sin(2 * np.pi * (2 + seed) * t) > -0.3).astype(np.float32)
    return (0.3 * np.sin(2 * np.pi * (f0 + 40 * seed) * t) * bursts
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three clips of about 1 s, clean and enhanced under two namings, the
    inputs of every tool, and every port tool's outputs."""
    root = tmp_path_factory.mktemp("tools")
    for d in ("clean", "enhanced", "enhanced_dns", "noisy_sil", "clean_sil", "txt", "corpus"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        clean = _speech(0.9 + 0.1 * i, i)
        enhanced = clean + 0.05 * rng.standard_normal(clean.size).astype(np.float32)
        write_wav(root / "clean" / f"clean_fileid_{i}.wav", clean, SR)
        write_wav(root / "enhanced" / f"clean_fileid_{i}.wav", enhanced, SR)
        write_wav(root / "enhanced_dns" / f"book_{7 - i}_snr{i}_fileid_{i}.wav", enhanced, SR)
    # scp lists, the enhanced list in another order than the clean one
    (root / "clean.scp").write_text("".join(f"{root}/clean/clean_fileid_{i}.wav\n"
                                            for i in range(3)))
    (root / "enhanced.scp").write_text("".join(f"{root}/enhanced/clean_fileid_{i}.wav\n"
                                               for i in range(3)))
    # delete_silence: pairs named <mark>_<rest>.wav with <mark>.wav.txt
    for i in range(2):
        noisy = _speech(1.0, 10 + i)
        write_wav(root / "noisy_sil" / f"single_{i}_utt.wav", noisy, SR)
        write_wav(root / "clean_sil" / f"single_{i}_utt.wav", noisy * 0.5, SR)
        (root / "txt" / f"single_{i}.wav.txt").write_text(
            f"sil 0 {1000 + i}\nw1 {1000 + i} 5000\nsil 5000 7000\nw2 7000 {12000 + 7 * i}\n")
    write_wav(root / "noisy_sil" / "other_9_utt.wav", _speech(0.5, 9), SR)  # no pair
    # preprocessing_dataset: kept, too short, clipped, silent
    write_wav(root / "corpus" / "a_voiced.wav", _speech(1.2, 1), SR)
    write_wav(root / "corpus" / "b_short.wav", _speech(0.3, 2), SR)
    write_wav(root / "corpus" / "c_clipped.wav", np.clip(_speech(1.2, 3) * 4, -1, 1), SR)
    write_wav(root / "corpus" / "d_silent.wav",
              np.concatenate([_speech(0.15, 5), np.zeros(SR, np.float32)]), SR)
    write_wav(root / "corpus" / "e_voiced.wav", _speech(1.0, 4), SR)

    metrics = ["-M", "SI_SDR,STOI,WB_PESQ"]
    jobs = [
        ("calculate_metrics", ["-R", f"{root}/clean", "-E", f"{root}/enhanced", *metrics,
                               "--export_dir", f"{root}/port_dirs", "--n_jobs", "2"]),
        ("calculate_metrics", ["-R", f"{root}/clean.scp", "-E", f"{root}/enhanced_dns", *metrics,
                               "-D", "dns_1", "--export_dir", f"{root}/port_dns_1",
                               "--n_jobs", "1"]),
        ("find_wavs", ["--dirs", f"{root}/clean", f"{root}/enhanced", "--output",
                       f"{root}/port_plain.txt"]),
        ("find_wavs", ["--dirs", f"{root}/clean", "--output", f"{root}/port_spk.txt",
                       "--format", "spk"]),
        ("delete_silence", ["--noisy_dir", f"{root}/noisy_sil", "--clean_dir",
                            f"{root}/clean_sil", "--text_dir", f"{root}/txt", "--dist_dir",
                            f"{root}/port_sil", "--prefix", "single"]),
        ("preprocessing_dataset", ["--dataset_dir", f"{root}/corpus", "--output",
                                   f"{root}/port_corpus.txt", "--min_duration", "0.5",
                                   "--activity_threshold", "0.5"]),
    ]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _RUNNER, json.dumps(jobs)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return root, proc.stdout


def _xlsx_cells(path):
    """The sheet's cells as text, in order."""
    sheet = zipfile.ZipFile(path).read("xl/worksheets/sheet1.xml").decode()
    return re.findall(r"<c r=\"([A-Z]+\d+)\"[^>]*>(.*?)</c>", sheet)


@pytest.mark.parametrize("form", ["dirs", "scp_dns_1"])
def test_calculate_metrics_matches_the_jax_tool(runs, form):
    """Three clips, SI_SDR, STOI and WB_PESQ: the CSV rows and the .xlsx
    cells equal the JAX tool's (the same numpy metrics, so the same
    digits), and the printed means are theirs."""
    root, stdout = runs
    tool = _jax_tool("calculate_metrics")
    if form == "dirs":
        ref, est, dataset, port = root / "clean", root / "enhanced", "", root / "port_dirs"
    else:
        ref, est, dataset, port = root / "clean.scp", root / "enhanced_dns", "dns_1", root / "port_dns_1"
    want = root / f"jax_{form}"
    tool.main(argparse.Namespace(reference=str(ref), estimated=str(est), specific_dataset=dataset,
                                 metric_types="SI_SDR,STOI,WB_PESQ", sr=SR,
                                 export_dir=str(want), n_jobs=1, num_channels=1))
    for metric in ("SI_SDR", "STOI", "WB_PESQ"):
        got_csv = (port / f"{metric}.csv").read_text()
        assert got_csv == (want / f"{metric}.csv").read_text(), metric
        assert len(got_csv.splitlines()) == 5  # header, three clips, mean
        assert _xlsx_cells(port / f"{metric}.xlsx") == _xlsx_cells(want / f"{metric}.xlsx")
        mean = float(got_csv.splitlines()[-1].split(",")[1])
        assert f"{metric}: {mean:.4f}" in stdout


@pytest.mark.parametrize("fmt", ["plain", "spk"])
def test_find_wavs_matches_the_jax_tool(runs, fmt, tmp_path):
    root, _ = runs
    dirs = [str(root / "clean"), str(root / "enhanced")] if fmt == "plain" else [str(root / "clean")]
    _jax_tool("find_wavs").main(argparse.Namespace(dirs=dirs, output=str(tmp_path / "want.txt"),
                                                   format=fmt))
    got = (root / f"port_{fmt}.txt").read_text()
    assert got == (tmp_path / "want.txt").read_text()
    assert len(got.splitlines()) == len(dirs) * 3


def test_delete_silence_matches_the_jax_tool(runs, tmp_path):
    root, _ = runs
    _jax_tool("delete_silence").main(argparse.Namespace(
        noisy_dir=str(root / "noisy_sil"), clean_dir=str(root / "clean_sil"),
        text_dir=str(root / "txt"), dist_dir=str(tmp_path / "want"), prefix="single", sr=SR))
    for kind in ("noisy", "clean"):
        names = sorted(os.listdir(tmp_path / "want" / kind))
        assert names == sorted(os.listdir(root / "port_sil" / kind)) == [
            "single_0_utt.wav", "single_1_utt.wav"]
        for name in names:
            got, _ = read_wav(root / "port_sil" / kind / name)
            want, _ = read_wav(tmp_path / "want" / kind / name)
            np.testing.assert_array_equal(got, want)
    assert read_wav(root / "port_sil" / "clean" / "single_1_utt.wav")[0].shape == (9006,)


def test_preprocessing_dataset_matches_the_jax_tool(runs, tmp_path):
    root, _ = runs
    _jax_tool("preprocessing_dataset").main(argparse.Namespace(
        dataset_dir=str(root / "corpus"), output=str(tmp_path / "want.txt"), sr=SR,
        min_duration=0.5, activity_threshold=0.5, target_hours=1e9))
    got = (root / "port_corpus.txt").read_text()
    assert got == (tmp_path / "want.txt").read_text()
    assert [Path(p).name for p in got.split()] == ["a_voiced.wav", "e_voiced.wav"]
