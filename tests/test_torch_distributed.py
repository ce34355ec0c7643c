"""The port's data-parallel training on the CPU against the JAX package:
the sharded loader against the JAX ``DataLoader(shard_index,
num_shards)``; two gloo ranks (child processes that import no JAX,
``tests/_torch_dist_worker.py``) against the JAX Trainer with
``[trainer.mesh] data = 2`` on the virtual 8-device CPU mesh: steps at a
global batch of 8 with G = 1 and 2 and of 12 with G = 2 (a rank's
microbatch of 3 rows is not a multiple of drop_band's 2 groups), sharded
validation against the JAX Trainer's single-process epoch, and only rank 0
writing; the ``[trainer.mesh]`` refusals; the CLI's launch flags and
environment reaching ``init_process_group``."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.acoustics.feature import drop_band as jax_drop_band
from fullsubnet_tpu.config import load_config as jax_load_config
from fullsubnet_tpu.data.loader import DataLoader as JaxDataLoader
from fullsubnet_tpu.parallel.mesh import shard_batch
from fullsubnet_tpu.train.trainer import Trainer as JaxTrainer
from fullsubnet_tpu_torch.acoustics.feature import drop_band, drops_band
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict
from fullsubnet_tpu_torch.config import load_config
from fullsubnet_tpu_torch.data.loader import DataLoader
from fullsubnet_tpu_torch.parallel import mesh
from fullsubnet_tpu_torch.train import cli
from fullsubnet_tpu_torch.train.trainer import Trainer

from test_torch_train import _by_key, write_config
from test_torch_train_data import _Indices
from test_torch_validation import LOSS_RTOL, METRIC_ATOL, validation_config

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
# (global batch, G): at 12 with G = 2 a rank's microbatch is 3 rows, not a
# multiple of the 2 groups, so its rows' groups follow their global index
STEP_CASES = {"b8_g1": (8, 1), "b8_g2": (8, 2), "b12_g2": (12, 2)}
STEPS = 3


def _global_batches(trainer, batch: int):
    """``STEPS`` global batches of the port dataset's items, from epochs 1,
    2, 3 (past the 8 clips they come round again)."""
    ds = trainer.train_dataset
    noisy, clean = [], []
    for epoch in range(1, STEPS + 1):
        ds.set_epoch(epoch)
        items = [ds[i % len(ds)] for i in range(batch)]
        noisy.append(np.stack([it[0] for it in items]))
        clean.append(np.stack([it[1] for it in items]))
    return np.stack(noisy), np.stack(clean)


class Ranks:
    """The two rank processes, started once a module; ``result(rank)``
    waits for them and loads what rank ``rank`` wrote."""

    def __init__(self, root: Path):
        one = write_config(root / "one", epochs=1)  # [trainer.mesh] data = 1
        port = Trainer(load_config(one), output_dir=str(root / "port"), device="cpu")
        self.weights = {k: v.clone() for k, v in port.model.state_dict().items()}
        torch.save(self.weights, root / "weights.pt")
        self.config = root / "one" / "world2.toml"
        self.config.write_text(one.read_text().replace("data = 1", "data = 2"))
        val = validation_config(root / "val", num_workers=1)
        self.validation_config = root / "val" / "world2.toml"
        self.validation_config.write_text(val.read_text().replace("data = 1", "data = 2"))
        self.validation_config_one = val
        self.batches = {}
        for name, (batch, _) in STEP_CASES.items():
            self.batches[name] = _global_batches(port, batch)
            np.savez(root / f"{name}.npz", noisy=self.batches[name][0],
                     clean=self.batches[name][1])
        self.out = root / "ranks"
        spec = {
            "init": f"file://{root / 'rendezvous'}", "world": WORLD, "out": str(self.out),
            "weights": str(root / "weights.pt"), "config": str(self.config),
            "validation_config": str(self.validation_config),
            "steps": {name: {"accum": g, "batches": str(root / f"{name}.npz")}
                      for name, (_, g) in STEP_CASES.items()},
        }
        (root / "spec.json").write_text(json.dumps(spec))
        env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
        self.procs = [
            subprocess.Popen([sys.executable, str(REPO / "tests" / "_torch_dist_worker.py"),
                              str(root / "spec.json"), str(r)], env=env, cwd=root,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)
        ]
        self._seen = None

    def result(self, rank: int) -> dict:
        if self._seen is None:
            logs = [p.communicate(timeout=600)[0] for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-4000:]
            self._seen = [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                          for r in range(WORLD)]
        return self._seen[rank]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    started = Ranks(tmp_path_factory.mktemp("dist"))
    yield started
    started.close()


def _jax_trainer(cfg_path, weights, out, **train) -> JaxTrainer:
    config = jax_load_config(cfg_path)
    config["trainer"]["train"].update(train)
    jt = JaxTrainer(config, output_dir=str(out))
    jt.state["params"] = jax.tree.map(jnp.asarray, jax_params_from_state_dict(weights))
    jt.state["opt_state"] = jt.optimizer.init(jt.state["params"])
    return jt


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_two_ranks_match_the_jax_data_mesh_step(ranks, tmp_path, name):
    """Each step's loss (the global mean, the same on both ranks) and the
    params after three steps, against the JAX Trainer's step on the
    ``data = 2`` mesh fed the global batch."""
    batch, g = STEP_CASES[name]
    jt = _jax_trainer(ranks.config, ranks.weights, tmp_path, grad_accum_steps=g)
    assert int(jt.mesh.shape["data"]) == WORLD
    state, want_losses = jt.state, []
    for n, c in zip(*ranks.batches[name]):
        state, loss = jt._train_step(state, *shard_batch((jnp.asarray(n), jnp.asarray(c)),
                                                         jt.mesh))
        want_losses.append(float(loss))
    want = _by_key(state["params"])
    got = [ranks.result(r)["steps"][name] for r in range(WORLD)]
    assert got[0]["split"] == got[1]["split"] == g
    assert got[0]["losses"] == got[1]["losses"]
    # the first loss from the same weights at the single-process test's
    # fp32 bound; the later ones after Adam steps, which move a weight
    # whose gradient is near zero by up to lr on either side, so 1e-4
    np.testing.assert_allclose(got[0]["losses"][0], want_losses[0], rtol=1e-5)
    np.testing.assert_allclose(got[0]["losses"], want_losses, rtol=1e-4)
    for key in want:
        assert torch.equal(got[0]["params"][key], got[1]["params"][key]), key
        # the existing single-process test's bound (test_torch_train.py)
        np.testing.assert_allclose(got[0]["params"][key].numpy(), want[key], atol=1e-4, rtol=0,
                                   err_msg=key)


def test_sharded_validation_matches_the_jax_epoch(ranks, tmp_path):
    """Rank p enhances utterances p, p + 2; the per-type sums reduce over
    both, so both ranks log the JAX Trainer's single-process scalars and
    score (tests/test_torch_validation.py's tolerances)."""
    jt = _jax_trainer(ranks.validation_config_one, ranks.weights, tmp_path)
    logged = {}
    jt._log_scalar = lambda tag, value, step: logged.__setitem__(tag, float(value))
    want_score = jt._validation_epoch(1)
    seen = [ranks.result(r) for r in range(WORLD)]
    assert seen[0]["validation_scalars"] == seen[1]["validation_scalars"]
    assert seen[0]["validation_score"] == seen[1]["validation_score"]
    got = seen[0]["validation_scalars"]
    assert sorted(got) == sorted(logged)
    for tag, value in got.items():
        assert math.isfinite(value), tag
        kind = tag.split("/")[1]
        kind = next((m for m in METRIC_ATOL if kind.startswith(f"{m}_")), kind)
        if kind.startswith("Loss_"):
            np.testing.assert_allclose(value, logged[tag], rtol=LOSS_RTOL, err_msg=tag)
        else:
            np.testing.assert_allclose(value, logged[tag], atol=METRIC_ATOL[kind], rtol=0,
                                       err_msg=tag)
    np.testing.assert_allclose(seen[0]["validation_score"], want_score,
                               atol=METRIC_ATOL["Score"], rtol=0)


def test_only_rank_zero_writes(ranks):
    """One epoch of the train loop (batch 4 over two ranks: 2 steps of 2
    rows each): both ranks end with the same weights and losses; rank 0
    alone writes the checkpoints and the config dump."""
    seen = [ranks.result(r) for r in range(WORLD)]
    assert seen[0]["steps_trained"] == seen[1]["steps_trained"] == 2
    assert seen[0]["epoch_losses"] == seen[1]["epoch_losses"]
    for key, value in seen[0]["trained"].items():
        assert torch.equal(value, seen[1]["trained"][key]), key
    first, second = (ranks.out / f"train_{r}" / "experiment" for r in range(WORLD))
    assert sorted(p.name for p in (first / "checkpoints").iterdir()) == [
        "best_model.tar", "latest_model.tar", "model_0001.pth"]
    assert len(list(first.glob("*.json"))) == 1
    assert list((second / "checkpoints").iterdir()) == []
    assert list(second.glob("*.json")) == []
    saved = torch.load(first / "checkpoints" / "model_0001.pth", weights_only=True)["model"]
    for key, value in seen[0]["trained"].items():
        assert torch.equal(saved[key], value), key


@pytest.mark.parametrize("groups", [2, 3])
def test_drop_band_of_a_slice_matches_the_global_batch(groups):
    """A slice of rows [start, start + n) of a batch of 12 keeps, row for
    row, the bins the JAX drop_band of the whole batch keeps for them (a
    row's group is its global index modulo G), also where the slice is
    smaller than G or starts off a multiple of it; the gate is the batch's
    (``drops_band``), not the slice's."""
    x = np.random.default_rng(0).standard_normal((12, 2, 7, 3)).astype(np.float32)
    want = np.asarray(jax_drop_band(jnp.asarray(x), groups))
    order = [r for g in range(groups) for r in range(g, 12, groups)]  # JAX's output rows
    for start, n in ((0, 3), (3, 3), (6, 6), (9, 3), (5, 1), (0, 12)):
        assert drops_band(n, groups, (start, 12)) and drops_band(n, groups) == (n > groups)
        got = drop_band(torch.from_numpy(x[start:start + n]), groups, (start, 12)).numpy()
        rows = [r for g in range(groups) for r in range(start, start + n) if r % groups == g]
        np.testing.assert_array_equal(got, want[[order.index(r) for r in rows]])


@pytest.mark.parametrize("num_shards", [2, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_sharded_loader_matches_jax(num_shards, drop_last):
    """11 items over 2 or 3 shards: the permutation padded by wrapping to
    12, strided by shard; every shard's batches and its length as the JAX
    loader's."""
    for shard in range(num_shards):
        kwargs = dict(batch_size=2, shuffle=True, drop_last=drop_last, seed=5,
                      shard_index=shard, num_shards=num_shards)
        port, want = DataLoader(_Indices(11), **kwargs), JaxDataLoader(_Indices(11), **kwargs)
        assert len(port) == len(want)
        for epoch in (1, 2):
            port.set_epoch(epoch)
            want.set_epoch(epoch)
            assert ([b.numpy()[:, 0].tolist() for b in port]
                    == [np.asarray(b)[:, 0].tolist() for b in want])
    assert len(DataLoader(_Indices(11), batch_size=2, shuffle=False, num_shards=2,
                          shard_index=1, drop_last=False)) == 3


def test_mesh_refusals(tmp_path):
    """``subband`` > 1 names A.25; ``data`` must equal the process count;
    ``slices`` must divide it."""
    cfg = write_config(tmp_path)
    for old, new, error, match in (
        ("data = 1", "data = 1\nsubband = 2", NotImplementedError, "A.25"),
        ("data = 1", "data = 2", ValueError, "number of processes"),
        ("data = 1", "data = 1\nslices = 2", ValueError, "slice count"),
    ):
        path = tmp_path / "mesh.toml"
        path.write_text(cfg.read_text().replace(old, new))
        with pytest.raises(error, match=match):
            Trainer(load_config(path), output_dir=str(tmp_path / "x"), device="cpu")
    mesh.check_mesh({}, 4)
    mesh.check_mesh({"data": 4, "slices": 2}, 4)


class _Stub:
    """Stands in for the Trainer: records its device, trains nothing."""

    def __init__(self, config, device, **kwargs):
        self.device = device

    def train(self):
        pass


_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "FULLSUBNET_DISTRIBUTED")


@pytest.mark.parametrize("flags, env, want", [
    (["--coordinator", "localhost:1234", "--num-processes", "2", "--process-id", "1"], {},
     ("tcp://localhost:1234", 1, 2)),
    ([], {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "3", "MASTER_ADDR": "node0",
          "MASTER_PORT": "29500"}, ("tcp://node0:29500", 3, 4)),
    (["--process-id", "0"], {"WORLD_SIZE": "2", "MASTER_ADDR": "h", "MASTER_PORT": "1"},
     ("tcp://h:1", 0, 2)),
    ([], {}, None),
])
def test_cli_launch_reaches_init_process_group(tmp_path, monkeypatch, flags, env, want):
    """The JAX CLI's flags, or ``torch.distributed.run``'s environment,
    give init_process_group its rendezvous, rank and world size (gloo for
    ``--device cpu``); with neither the CLI joins no group."""
    for key in _LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    calls = []

    def init(backend, init_method, rank, world_size, **kwargs):
        calls.append((backend, init_method, rank, world_size))

    monkeypatch.setattr(mesh.dist, "init_process_group", init)
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: bool(calls))
    monkeypatch.setattr(mesh.dist, "all_reduce", lambda t: t.mul_(calls[-1][3]))
    monkeypatch.setattr(cli, "Trainer", _Stub)
    trainer = cli.main(["-C", str(write_config(tmp_path)), "--device", "cpu", *flags])
    assert calls == ([] if want is None else [("gloo", *want)])
    assert torch.device(trainer.device) == torch.device("cpu")


def test_cli_launch_refusals(tmp_path, monkeypatch):
    """A distributed launch without a rank or a rendezvous raises, and one
    on ``cuda`` without a card raises: no single-process fallback."""
    for key in _LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(cli, "Trainer", _Stub)
    cfg = str(write_config(tmp_path))
    monkeypatch.setenv("FULLSUBNET_DISTRIBUTED", "1")
    with pytest.raises(ValueError, match="rank and the world size"):
        cli.main(["-C", cfg, "--device", "cpu"])
    with pytest.raises(ValueError, match="rendezvous address"):
        cli.main(["-C", cfg, "--device", "cpu", "--num-processes", "2", "--process-id", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(["-C", cfg, "--coordinator", "localhost:1", "--num-processes", "2",
                      "--process-id", "0"])
