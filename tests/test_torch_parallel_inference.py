"""The multi-card enhancer (``fullsubnet_tpu_torch/parallel/``) against the
JAX package's ``make_parallel_enhancer`` on the same weights: the plain
form on (data, 1) meshes, the bucketed form with per-row lengths, the bf16
``compute_dtype`` against the JAX model with its stacks routed through the
interpret-mode kernels, the enhancer against the port's one-device path,
the mesh helpers and refusals, weights crossing once a weight set, and the
launch counts under threads. The port's meshes here repeat the CPU (a mesh
of four ``"cpu"`` entries splits a batch four ways in four threads); the
JAX references run under ``jax.jit`` on the conftest's 8 virtual CPU
devices. The card case is in tests/test_torch_kernel_cuda.py."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.models import FullSubNet as JaxFullSubNet
from fullsubnet_tpu.parallel.inference import make_parallel_enhancer as jax_make_parallel_enhancer
from fullsubnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fullsubnet_tpu_torch.checkpoint import state_dict_from_jax_params
from fullsubnet_tpu_torch.infer.inferencer import bucketed_enhance, full_band_crm_mask
from fullsubnet_tpu_torch.models import FullSubNet
from fullsubnet_tpu_torch.ops import subband_lstm as ops
from fullsubnet_tpu_torch.parallel import make_mesh, replicate, shard_batch
from fullsubnet_tpu_torch.parallel.inference import make_parallel_enhancer
from fullsubnet_tpu_torch.parallel.mesh import Mesh, batch_slices

from test_torch_bf16_forward import _route_jax_through_kernels
from test_torch_fullsubnet import _jnp, _sequence_params

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# the JAX test's model (tests/test_parallel_inference.py) and acoustics
CONFIG = dict(num_freqs=33, sb_num_neighbors=3, fb_model_hidden_size=16, sb_model_hidden_size=12)
ACOUSTICS = {"n_fft": 64, "hop_length": 32, "win_length": 64}
BATCH, SAMPLES = 8, 4000
# the JAX test's bucketed lengths, in a bucket of 4000 samples
LENGTHS = [3000, 2600, 3900, 2100, 3500, 2800, 3100, 2400]
BUCKET = 4000
# fp32 waveforms against the JAX enhancer: only the order of fp32 sums
# differs, through both stacks, two norms and the FFTs (the JAX test's own
# bound is atol 1e-4, rtol 1e-3; the port's usual one, test_torch_fullsubnet's)
ATOL = 1e-5
# compute_dtype = bfloat16 against the JAX enhancer on the interpret-mode
# kernels at bf16: both models return the cRM in bf16, rounded from fp32
# sums taken in another order, so a value near a rounding boundary lands
# one bf16 step away (12 of 66,528 here, 2^-9 at |m| < 0.5), and the
# decompressed mask moves the waveform by up to 6.3e-4 where the noisy
# spectrum is large (measured, of a 2.5 peak; the fp32 enhancer is 4.7e-3
# to 6.0e-3 away)
BF16_ATOL = 1.5e-3


def _params(cell: str, seed: int = 0) -> dict:
    """JAX FullSubNet params (numpy leaves) of ``CONFIG`` with ``cell``."""
    rng = np.random.default_rng(seed)
    unit = 2 * CONFIG["sb_num_neighbors"] + 2
    f = CONFIG["num_freqs"]
    return {"fb_model": _sequence_params(rng, f, CONFIG["fb_model_hidden_size"], f, cell),
            "sb_model": _sequence_params(rng, unit, CONFIG["sb_model_hidden_size"], 2, cell)}


def _noisy(seed: int = 0, shape=(BATCH, SAMPLES)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _padded(seed: int = 1):
    """The JAX test's zero-padded bucket: (padded [8, 4000], lengths [8])."""
    rng = np.random.default_rng(seed)
    padded = np.zeros((BATCH, BUCKET), np.float32)
    for i, n in enumerate(LENGTHS):
        padded[i, :n] = rng.standard_normal(n).astype(np.float32)
    return padded, np.asarray(LENGTHS, np.int32)


def _port(cell: str, params: dict):
    """The port's model (a template) and the state dict the bridge gives."""
    return FullSubNet(**CONFIG, sequence_model=cell).eval(), state_dict_from_jax_params(params)


def _cpu_mesh(data: int) -> Mesh:
    return make_mesh(data, devices=["cpu"] * data)


def _jax_enhance(cell, params, data, *args, **kwargs):
    fn = jax_make_parallel_enhancer(JaxFullSubNet(**CONFIG, sequence_model=cell),
                                    jax_make_mesh(num_data=data, num_subband=1), **ACOUSTICS,
                                    **kwargs)
    return np.asarray(fn(_jnp(params), *map(jnp.asarray, args)))


# --------------------------------------------------------------------------
# against the JAX enhancer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cell, data", [("LSTM", 2), ("LSTM", 4), ("LSTM", 8), ("GRU", 4)])
def test_plain_form_matches_jax(cell, data):
    """B = 8 rows on a (data, 1) mesh, fp32: the waveforms against JAX
    ``make_parallel_enhancer`` on the same weights and mesh."""
    params = _params(cell)
    noisy = _noisy()
    want = _jax_enhance(cell, params, data, noisy)
    model, state = _port(cell, params)
    fn = make_parallel_enhancer(model, _cpu_mesh(data), **ACOUSTICS)
    got = fn(state, torch.from_numpy(noisy))
    assert got.shape == want.shape == (BATCH, SAMPLES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_bucketed_form_matches_jax(cell):
    """The JAX test's lengths in a 4000-sample bucket on a (4, 1) mesh: each
    row's first true_len samples against JAX's bucketed form (whose samples
    past them are not the output's: the port's are zero, as
    ``bucketed_enhance`` gives them) and against the port's unpadded run of
    that row alone."""
    params = _params(cell, seed=1)
    padded, lengths = _padded()
    want = _jax_enhance(cell, params, 4, padded, lengths, bucketed=True)
    model, state = _port(cell, params)
    fn = make_parallel_enhancer(model, _cpu_mesh(4), **ACOUSTICS, bucketed=True)
    got = fn(state, torch.from_numpy(padded), torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (BATCH, BUCKET)
    model.load_state_dict(state)
    for i, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=ATOL)
        with torch.inference_mode():
            alone = full_band_crm_mask(model, ACOUSTICS, torch.from_numpy(padded[i : i + 1, :n]))
        np.testing.assert_allclose(got[i, :n], alone[0].numpy(), atol=ATOL)
        assert not got[i, n:].any()


@pytest.fixture
def jax_kernel_route(monkeypatch):
    _route_jax_through_kernels(monkeypatch)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_compute_dtype_matches_jax_kernel_route(jax_kernel_route, cell):
    """``compute_dtype = bfloat16`` on a (4, 1) mesh against the JAX
    enhancer with its stacks on the interpret-mode kernels at bf16 (the
    JAX CPU scan raises on fp32 weights with a bf16 magnitude), and far
    from the fp32 enhancer."""
    params = _params(cell, seed=2)
    noisy = _noisy(2)
    want = _jax_enhance(cell, params, 4, noisy, compute_dtype=jnp.bfloat16)
    model, state = _port(cell, params)
    fn = make_parallel_enhancer(model, _cpu_mesh(4), **ACOUSTICS, compute_dtype=torch.bfloat16)
    got = fn(state, torch.from_numpy(noisy))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL)
    fp32 = make_parallel_enhancer(model, _cpu_mesh(4), **ACOUSTICS)(state, torch.from_numpy(noisy))
    assert float((fp32 - got).abs().max()) > 2 * BF16_ATOL  # the test sees bf16


# --------------------------------------------------------------------------
# against the port's one-device path
# --------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["plain", "bf16", "bucketed"])
def test_enhancer_equals_one_device_path(form):
    """On four CPU slices, the same bits as the one-device path over the
    whole batch (``full_band_crm_mask``, ``bucketed_enhance``)."""
    model, state = _port("LSTM", _params("LSTM", seed=3))
    kwargs = {"bf16": {"compute_dtype": torch.bfloat16},
              "bucketed": {"bucketed": True}}.get(form, {})
    fn = make_parallel_enhancer(model, _cpu_mesh(4), **ACOUSTICS, **kwargs)
    model.load_state_dict(state)
    if form == "bucketed":
        padded, lengths = map(torch.from_numpy, _padded(4))
        got = fn(state, padded, lengths)
        with torch.inference_mode():
            want = bucketed_enhance(model, ACOUSTICS, padded, lengths)
    else:
        noisy = torch.from_numpy(_noisy(4))
        got = fn(state, noisy)
        with torch.inference_mode():
            want = full_band_crm_mask(model, ACOUSTICS, noisy, kwargs.get("compute_dtype"))
    assert torch.equal(got, want)


def test_weights_cross_once_a_weight_set():
    """A second call with the same dict copies no weights; another dict,
    or a tensor of it changed in place, loads again, and the output
    follows the weights."""
    model, state = _port("LSTM", _params("LSTM", seed=5))
    other = state_dict_from_jax_params(_params("LSTM", seed=6))
    fn = make_parallel_enhancer(model, make_mesh(2, devices=["cpu", "cpu"]), **ACOUSTICS)
    noisy = torch.from_numpy(_noisy(5, (2, 1000)))
    replica = fn.replicas[torch.device("cpu")]
    ptr = replica.fb_model.sequence_model.weight_hh_l0.data_ptr()
    first = fn(state, noisy)
    assert fn.weight_loads == 1  # one distinct device
    assert torch.equal(fn(state, noisy), first) and fn.weight_loads == 1
    changed = fn(other, noisy)
    assert fn.weight_loads == 2 and not torch.equal(changed, first)
    fresh = make_parallel_enhancer(model, make_mesh(2, devices=["cpu", "cpu"]), **ACOUSTICS)
    assert torch.equal(changed, fresh(other, noisy))
    with torch.no_grad():
        other["sb_model.fc_output_layer.bias"].add_(1.0)
    assert not torch.equal(fn(other, noisy), changed) and fn.weight_loads == 3
    assert replica.fb_model.sequence_model.weight_hh_l0.data_ptr() == ptr


# --------------------------------------------------------------------------
# the mesh, its helpers and the refusals
# --------------------------------------------------------------------------


def test_mesh_and_helpers():
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {"data": 3, "subband": 1}
    assert mesh.data_devices == (torch.device("cpu"),) * 3
    assert mesh.distinct_devices == (torch.device("cpu"),)
    assert make_mesh(2, devices=["cpu"] * 4).shape["data"] == 2
    assert make_mesh(4, devices=["cpu"] * 4, num_slices=2).shape["data"] == 4
    batch = {"x": torch.arange(12.0).reshape(6, 2), "n": [torch.arange(6)]}
    parts = shard_batch(batch, mesh)
    assert [p["x"][:, 0].tolist() for p in parts] == [[0.0, 2.0], [4.0, 6.0], [8.0, 10.0]]
    assert [p["n"][0].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    copies = replicate({"w": torch.ones(2)}, mesh)
    assert list(copies) == [torch.device("cpu")] and torch.equal(copies[torch.device("cpu")]["w"],
                                                                 torch.ones(2))


def test_refusals():
    """The JAX assertions' words: an empty mesh, too few devices, data not
    divisible by the slices; subband > 1 names A.25; B % data; no card
    behind a default mesh; the bucketed form's arguments."""
    with pytest.raises(AssertionError, match="is empty"):
        make_mesh(0, devices=["cpu"] * 4)
    with pytest.raises(AssertionError, match="needs 5 devices but only 4"):
        make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(AssertionError, match="divisible by the slice count"):
        make_mesh(3, devices=["cpu"] * 6, num_slices=2)
    with pytest.raises(NotImplementedError, match="A.25"):
        make_mesh(2, 2, devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="A.25"):
        batch_slices(torch.zeros(4), Mesh(((torch.device("cpu"),) * 2,) * 2))
    model, state = _port("LSTM", _params("LSTM"))
    fn = make_parallel_enhancer(model, _cpu_mesh(4), **ACOUSTICS)
    with pytest.raises(ValueError, match="6 rows does not split over the mesh's data axis of 4"):
        fn(state, torch.zeros(6, 1000))
    with pytest.raises(TypeError, match="bucketed"):
        fn(state, torch.zeros(4, 1000), torch.full((4,), 900))
    with pytest.raises(ValueError, match="no compute_dtype"):
        make_parallel_enhancer(model, _cpu_mesh(4), bucketed=True, compute_dtype=torch.bfloat16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA"):
            make_mesh(1, devices=["cuda"])


def test_a_failing_slice_fails_the_call():
    """A slice that raises raises from the call, after every thread ended."""
    model, state = _port("LSTM", _params("LSTM"))
    fn = make_parallel_enhancer(model, _cpu_mesh(4), **ACOUSTICS)
    calls = []

    def broken(replica, noisy, true_len):
        calls.append(threading.current_thread().name)
        if len(calls) == 2:
            raise RuntimeError("slice failed")
        return noisy

    fn._enhance = broken
    with pytest.raises(RuntimeError, match="slice failed"):
        fn(state, torch.zeros(8, 1000))
    assert len(calls) == 4 and len(set(calls)) == 4  # one thread a slice


def test_launch_counts_hold_under_threads():
    """The wrappers' counts under 16 threads with a tiny switch interval:
    no increment lost, each card's count its own."""
    kernel = ops.fwd_gemm
    kernel.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(2000):
                kernel._count(torch.device("cuda", i % 4), (8, 16))

        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernel.launches == 32000 and kernel.launches_by_shape[(8, 16)] == 32000
    assert dict(kernel.launches_by_device) == {0: 8000, 1: 8000, 2: 8000, 3: 8000}
    kernel.reset_counts()
    assert kernel.launches == 0 and not kernel.launches_by_device
