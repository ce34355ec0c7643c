"""The port's stream hosts (``infer/host.py``) and ``MultiStreamEnhancer``
against ``fullsubnet_tpu.infer`` on the same weights and inputs: the host
helpers, ``StreamingWaveHost`` and ``MultiStreamHost`` over a stand-in
device (exact), the engines' lanes against single streams, a slot reset,
and ``MultiStreamEnhancer`` against the JAX one and against single
``StreamingEnhancer`` streams: unequal pushes, slot reuse, a stream that
lags, ``finish`` and ``drain``. Tiny models, the plain stages on the CPU."""

import numpy as np
import pytest
import torch

from fullsubnet_tpu.infer import host as jax_host
from fullsubnet_tpu_torch.infer import host, streaming

from test_torch_streaming import (
    ATOL,
    FAMILIES,
    STEP_ATOL,
    _engine,
    engine_frames,
    families,  # noqa: F401  (the module-scoped fixture)
    noisy_wave,
    stream_wave,
)

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

STFT = {"fullsubnet": (64, 32), "fullband": (64, 32), "fast": (64, 32), "improved": (64, 16)}


# -- the hosts over a stand-in device ----------------------------------------------


@pytest.mark.parametrize("n_fft, hop, look_ahead", [(64, 32, 2), (64, 16, 2), (64, 16, 0)])
def test_host_helpers_match_jax(n_fft, hop, look_ahead):
    """The start pad, the warm-up and pad-prefix trim and the flush count,
    over staged blocks of 1 to 40 samples."""
    assert host._flush_blocks(n_fft, hop, look_ahead) == jax_host._flush_blocks(
        n_fft, hop, look_ahead)
    ours = host._new_stream_record(n_fft, look_ahead)
    theirs = jax_host._new_stream_record(n_fft, look_ahead)
    assert ours.keys() == theirs.keys()
    rng = np.random.default_rng(n_fft + hop + look_ahead)
    for size in (1, 5, 40, 13, 40):
        block = rng.standard_normal(size).astype(np.float32)
        for rec in (ours, theirs):
            rec["staging"] = np.concatenate([rec["staging"], block])
        assert host._stage_start_pad(ours, n_fft) == jax_host._stage_start_pad(theirs, n_fft)
        np.testing.assert_array_equal(ours["staging"], theirs["staging"])
    for _ in range(look_ahead + 4):
        out = rng.standard_normal(hop).astype(np.float32)
        np.testing.assert_array_equal(host._trim_startup(ours, out),
                                      jax_host._trim_startup(theirs, out))
        assert ours == {**theirs, "staging": ours["staging"]}


def _echo_wave(base):
    """A wave host whose device hop returns the hop doubled plus its count."""

    class Echo(base):
        def __init__(self, n_fft, hop, look_ahead):
            self.n_fft, self.hop, self.look_ahead = n_fft, hop, look_ahead

        def _dev_init(self, buf):
            return {"n": float(np.sum(buf))}

        def _dev_hop(self, dstate, hop_samples):
            dstate = {"n": dstate["n"] + 1.0}
            return dstate, 2.0 * hop_samples + dstate["n"]

    return Echo


@pytest.mark.parametrize("look_ahead", [0, 2])
def test_wave_host_matches_jax(look_ahead):
    wave = noisy_wave(look_ahead, 1000)
    got = stream_wave(_echo_wave(host.StreamingWaveHost)(64, 16, look_ahead), wave, 37)
    want = stream_wave(_echo_wave(jax_host.StreamingWaveHost)(64, 16, look_ahead), wave, 37)
    np.testing.assert_array_equal(got, want)


def _echo_multi(base):
    """A multi-stream host whose batched hop returns each active lane's hop
    doubled plus the lane's count, and zeros elsewhere."""

    class Echo(base):
        def __init__(self, n_fft, hop, look_ahead, max_streams):
            self.n_fft, self.hop, self.look_ahead = n_fft, hop, look_ahead
            self.max_streams = max_streams

        def _dev_init_batched(self):
            return np.zeros(self.max_streams)

        def _dev_reset(self, bstate, slot, buf):
            bstate = bstate.copy()
            bstate[slot] = np.sum(buf)
            return bstate

        def _dev_hop_batch(self, bstate, hops, active):
            bstate = bstate + active
            return bstate, np.where(active[:, None], 2.0 * hops + bstate[:, None], 0.0)

    return Echo


def test_multistream_host_matches_jax():
    """Three streams with unequal pushes, one finished while the others
    tick, one drained, its slot reused, and the rest drained."""
    runs = []
    for base in (host.MultiStreamHost, jax_host.MultiStreamHost):
        ms = _echo_multi(base)(64, 16, 2, 3)
        state = ms.init_state()
        slots = [ms.open_stream(state) for _ in range(3)]
        with pytest.raises(RuntimeError, match="slots busy"):
            ms.open_stream(state)
        outs = []
        for tick, size in enumerate((50, 7, 90, 33, 16)):
            for j, slot in enumerate(slots):
                if state["slots"][slot] is not None:  # a finished stream frees its slot
                    ms.push(state, slot, np.arange(size * (j + 1), dtype=np.float32) + tick)
            outs.append(ms.poll(state))
            if tick == 2:
                ms.finish(state, slots[0])
        outs.append({slots[1]: ms.drain(state, slots[1])})
        reused = ms.open_stream(state)
        ms.push(state, reused, np.ones(200, np.float32))
        outs += [ms.poll(state), {reused: ms.drain(state, reused)},
                 {slots[2]: ms.drain(state, slots[2])}]
        runs.append((reused, outs, [s is None for s in state["slots"]]))
    (got_reused, got, got_free), (want_reused, want, want_free) = runs
    assert got_reused == want_reused and got_free == want_free == [True] * 3
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for slot in g:
            np.testing.assert_array_equal(g[slot], w[slot])


# -- the engines' lanes ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(FAMILIES))
def test_lanes_equal_single_streams(families, name):
    """Three lanes at different frame counts (0, 1 and 3 frames in) through
    one ``_block_lanes`` call of 5 frames, each against its stream alone:
    each lane keeps its own frame count, running sums and (Fast
    FullSubNet) down clock."""
    engine = _engine(name, families(name).model)
    streams = [torch.from_numpy(engine_frames(name, 10 + j, 8)) for j in range(3)]
    heads = (0, 1, 3)
    with torch.inference_mode():
        lane_states = []
        for stream, head in zip(streams, heads):
            state = engine.init_state()
            if head:
                state, _ = engine.step_block(state, stream[:head])
            lane_states.append(state)
        batched = streaming._tree_map(lambda *v: torch.cat(v), *lane_states)
        frames = torch.stack([s[h : h + 5] for s, h in zip(streams, heads)], dim=1)
        batched, out = engine._block_lanes(batched, frames)
    for j, (stream, head) in enumerate(zip(streams, heads)):
        _, alone = engine.step_block(lane_states[j], stream[head : head + 5])
        torch.testing.assert_close(out[:, j], alone, atol=STEP_ATOL, rtol=0)
        assert int(batched["frame_idx"][j]) == head + 5


def _leaves(tree) -> list:
    leaves = []
    streaming._tree_map(leaves.append, tree)
    return leaves


def test_slot_reset_writes_one_lane(families):
    """Opening a slot rewrites that lane of every state tensor in place and
    leaves the other lanes as they were."""
    ms = streaming.MultiStreamEnhancer(families("fullsubnet").model, 64, 32, max_streams=3)
    state = ms.init_state()
    for slot in range(3):
        ms.open_stream(state)
        ms.push(state, slot, noisy_wave(slot, 200 + 50 * slot))
    ms.poll(state)
    leaves = _leaves(state["device"])
    before = streaming._tree_map(torch.clone, state["device"])
    fresh = ms._enh._init_device_state(torch.full((1, 32), 0.5))
    after = ms._dev_reset(state["device"], 1, np.full(32, 0.5, np.float32))
    assert all(a is b for a, b in zip(_leaves(after), leaves, strict=True))

    def check(a, b, f):
        assert torch.equal(a[[0, 2]], b[[0, 2]]) and torch.equal(a[1], f[0])

    streaming._tree_map(check, after, before, fresh)


# -- MultiStreamEnhancer ----------------------------------------------------------------


def _interleaved(ms, waves, sizes):
    """Open a slot per wave, push each in blocks of its own size, poll after
    every round, then drain each: {slot: the whole stream}."""
    state = ms.init_state()
    slots = [ms.open_stream(state) for _ in waves]
    got = {slot: [] for slot in slots}
    pos = [0] * len(waves)
    while any(p < len(w) for p, w in zip(pos, waves)):
        for j, slot in enumerate(slots):
            if pos[j] < len(waves[j]):
                ms.push(state, slot, waves[j][pos[j] : pos[j] + sizes[j]])
                pos[j] += sizes[j]
        for slot, out in ms.poll(state).items():
            got[slot].append(out)
    for slot in slots:
        got[slot].append(ms.drain(state, slot))
    return [np.concatenate(got[slot]) for slot in slots]


def _single(model, wave, n_fft, hop):
    return stream_wave(streaming.StreamingEnhancer(model, n_fft, hop), wave, hop)


def _close_prefix(got, want, atol, min_len):
    n = min(len(got), len(want))
    assert n >= min_len
    np.testing.assert_allclose(got[:n], want[:n], atol=atol)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_multistream_matches_single_streams(families, name):
    """Three streams of 1024 samples in four lanes, pushed in blocks of 1, 3
    and 2 hops: each stream equals its own StreamingEnhancer."""
    n_fft, hop = STFT[name]
    model = families(name).model
    waves = [noisy_wave(20 + j, 1024) for j in range(3)]
    ms = streaming.MultiStreamEnhancer(model, n_fft, hop, max_streams=4)
    for got, wave in zip(_interleaved(ms, waves, [hop, 3 * hop, 2 * hop]), waves, strict=True):
        _close_prefix(got, _single(model, wave, n_fft, hop), STEP_ATOL, 1024)


@pytest.mark.parametrize("name", ["fullsubnet", "improved"])
def test_multistream_matches_jax(families, name):
    """The same interleaved run through the JAX MultiStreamEnhancer."""
    n_fft, hop = STFT[name]
    fam = families(name)
    waves = [noisy_wave(30 + j, 1024) for j in range(3)]
    sizes = [hop, 3 * hop, 2 * hop]
    got = _interleaved(streaming.MultiStreamEnhancer(fam.model, n_fft, hop, max_streams=4),
                       waves, sizes)
    want = _interleaved(fam.jax_multistream(n_fft, hop, 4), waves, sizes)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_multistream_slot_reuse_and_laggy_stream(families):
    """A slot drained and reopened serves a new stream from a fresh lane; a
    stream fed nothing while another ticks keeps its state."""
    model = families("fullsubnet").model
    w_a, w_b, w_lag = (noisy_wave(40 + j, 1024) for j in range(3))
    ms = streaming.MultiStreamEnhancer(model, 64, 32, max_streams=2)
    state = ms.init_state()
    s_a, s_lag = ms.open_stream(state), ms.open_stream(state)
    ms.push(state, s_lag, w_lag[:128])
    got_lag = [ms.poll(state).get(s_lag, np.zeros(0, np.float32))]
    ms.push(state, s_a, w_a)
    out = ms.poll(state)
    got_a = [out.get(s_a, np.zeros(0, np.float32)), ms.drain(state, s_a)]
    got_lag.append(out.get(s_lag, np.zeros(0, np.float32)))
    s_b = ms.open_stream(state)
    assert s_b == s_a
    ms.push(state, s_b, w_b)
    ms.push(state, s_lag, w_lag[128:])
    out = ms.poll(state)
    got_b = [out.get(s_b, np.zeros(0, np.float32)), ms.drain(state, s_b)]
    got_lag += [out.get(s_lag, np.zeros(0, np.float32)), ms.drain(state, s_lag)]
    for got, wave in ((got_a, w_a), (got_b, w_b), (got_lag, w_lag)):
        _close_prefix(np.concatenate(got), _single(model, wave, 64, 32), STEP_ATOL, 1024)


def test_multistream_finish_rides_shared_ticks(families):
    """``finish`` stages the flush tail, which rides the ticks that advance
    the other stream; the slot is freed once drained, and both streams
    equal their single runs."""
    model = families("fullsubnet").model
    w_a, w_b = noisy_wave(50, 1024), noisy_wave(51, 2048)
    ms = streaming.MultiStreamEnhancer(model, 64, 32, max_streams=2)
    state = ms.init_state()
    s_a, s_b = ms.open_stream(state), ms.open_stream(state)
    ms.push(state, s_a, w_a)
    ms.push(state, s_b, w_b[:1024])
    out = ms.poll(state)
    got_a, got_b = [out.get(s_a)], [out.get(s_b)]
    ms.finish(state, s_a)
    ms.push(state, s_b, w_b[1024:])
    out = ms.poll(state)
    got_a.append(out.get(s_a))
    got_b += [out.get(s_b), ms.drain(state, s_b)]
    assert state["slots"][s_a] is None
    _close_prefix(np.concatenate(got_a), _single(model, w_a, 64, 32), STEP_ATOL, 1024)
    _close_prefix(np.concatenate(got_b), _single(model, w_b, 64, 32), STEP_ATOL, 2048)
