"""Host-side batching helpers and stream hosts (counterpart of
``fullsubnet_tpu/infer/host.py``; numpy only).

The stream hosts own everything that happens off the device: the
staging sample rings, the stream-start reflect pad (the offline center
pad), the warm-up hop discard matching the model's look-ahead, the
end-of-stream flush and the slots of a multi-stream host. The engines of
``infer/streaming.py`` subclass them and provide the device hooks
(``_dev_*``), the only part that touches the card.
"""

from __future__ import annotations

import numpy as np


def pad_bucket_batch(waves, batch_size: int, bucket: int):
    """Stack 1-D float32 waves into ([batch_size, bucket] zero-padded
    array, [batch_size] int32 true lengths). Filler rows (fewer waves than
    ``batch_size``) reuse the first wave's length, so their tail
    reflection stays in range; their outputs are discarded."""
    padded = np.zeros((batch_size, bucket), np.float32)
    lengths = np.full(batch_size, len(waves[0]), np.int32)
    for i, w in enumerate(waves):
        padded[i, : len(w)] = w
        lengths[i] = len(w)
    return padded, lengths


def _stage_start_pad(s: dict, n_fft: int) -> bool:
    """Apply the offline center reflect-pad to a stream's staging buffer
    once ``n_fft//2 + 1`` samples are staged (reflect needs pad+1).
    Returns True when the stream has started."""
    if s["started"]:
        return True
    pad = n_fft // 2
    if len(s["staging"]) < pad + 1:
        return False
    head = s["staging"][1 : pad + 1][::-1]
    s["staging"] = np.concatenate([head, s["staging"]])
    s["started"] = True
    return True


def _trim_startup(s: dict, out) -> np.ndarray:
    """Warm-up hop discard (look-ahead) + center-pad prefix trim, so the
    emitted stream is ``enhanced[0:]``, sample-aligned with the input.
    Mutates the stream dict's ``frames_seen``/``pad_left`` counters."""
    s["frames_seen"] += 1
    if s["frames_seen"] <= s["look_ahead"]:
        return np.zeros(0, np.float32)
    out = np.asarray(out)
    if s["pad_left"]:
        cut = min(s["pad_left"], len(out))
        s["pad_left"] -= cut
        out = out[cut:]
    return out


def _flush_blocks(n_fft: int, hop: int, look_ahead: int) -> int:
    """Zero hops needed to drain the pipeline at end of stream: the
    look-ahead delay line, the OLA pipe (ratio hops twice over for the
    center-pad tail), plus slack."""
    return 2 + look_ahead + 2 * (n_fft // hop)


def _new_stream_record(n_fft: int, look_ahead: int) -> dict:
    """A stream's host-side record: its staging buffer and warm-up counters."""
    return {
        "staging": np.zeros(0, np.float32),  # host-side sample buffer
        "started": False,
        "frames_seen": 0,  # host mirror of the frame count (warm-up)
        # the first emitted samples reconstruct the synthetic center
        # reflect-pad; dropping them aligns enhanced[j] with input[j]
        # (the offline pipeline's center trim)
        "pad_left": n_fft // 2,
        "look_ahead": look_ahead,
    }


class StreamingWaveHost:
    """Host-side state of the live :class:`StreamingEnhancer`
    (``infer/streaming.py``).

    Owns everything that happens OFF the device: the staging sample ring,
    the stream-start reflect pad (reproducing the offline center pad),
    the warm-up hop discard matching the model's look-ahead, and the
    end-of-stream flush. Subclasses provide the two device entry points:

    * ``_dev_init(buf)`` — ``n_fft - hop`` staged samples -> device state
    * ``_dev_hop(dstate, hop_samples)`` -> ``(dstate, enhanced_hop)``

    Requires attributes ``n_fft``, ``hop``, ``look_ahead``.
    """

    n_fft: int
    hop: int
    look_ahead: int

    def _dev_init(self, buf: np.ndarray):
        raise NotImplementedError

    def _dev_hop(self, dstate, hop_samples):
        raise NotImplementedError

    def init_state(self):
        state = _new_stream_record(self.n_fft, self.look_ahead)
        state["device"] = None  # filled once n_fft - hop samples are staged
        return state

    def push(self, state, samples: np.ndarray):
        """Feed samples; returns (state, enhanced np.ndarray (maybe empty)).
        Output is sample-aligned with the input: concatenating all pushed
        (+ flushed) returns yields ``enhanced[0:]`` matching the offline
        pipeline everywhere except the final ~``n_fft//2`` tail samples
        (the stream drains with zeros where the offline pipeline
        reflect-pads the utterance tail)."""
        state["staging"] = np.concatenate(
            [state["staging"], np.asarray(samples, np.float32)]
        )
        if not _stage_start_pad(state, self.n_fft):
            return state, np.zeros(0, np.float32)
        if state["device"] is None:
            need = self.n_fft - self.hop
            if len(state["staging"]) < need:
                return state, np.zeros(0, np.float32)
            state["device"] = self._dev_init(state["staging"][:need])
            state["staging"] = state["staging"][need:]

        outs = []
        while len(state["staging"]) >= self.hop:
            hop = state["staging"][: self.hop]
            state["staging"] = state["staging"][self.hop :]
            state["device"], out = self._dev_hop(state["device"], hop)
            out = _trim_startup(state, out)
            if len(out):
                outs.append(out)
        return state, (
            np.concatenate(outs) if outs else np.zeros(0, np.float32)
        )

    def flush(self, state):
        """End of stream: push zeros until all buffered frames are emitted."""
        outs = []
        for _ in range(_flush_blocks(self.n_fft, self.hop, self.look_ahead)):
            state, out = self.push(state, np.zeros(self.hop, np.float32))
            if len(out):
                outs.append(out)
        return state, (
            np.concatenate(outs) if outs else np.zeros(0, np.float32)
        )


class MultiStreamHost:
    """Host-side slot manager of the live :class:`MultiStreamEnhancer`
    (``infer/streaming.py``).

    Owns everything off the device: per-slot staging rings, the
    stream-start reflect pad, warm-up/pad-prefix trimming, and the tick
    loop that gathers one hop per ready slot into a single batched
    device call. Subclasses provide three device entry points:

    * ``_dev_init_batched()`` — fresh batched device state
    * ``_dev_reset(bstate, slot, buf)`` — (re)initialize one slot's lane
    * ``_dev_hop_batch(bstate, hops [B, hop], active [B])`` ->
      ``(bstate, outs [B, hop])``

    Requires attributes ``n_fft``, ``hop``, ``look_ahead``,
    ``max_streams``.

    API (functional — the caller owns the state):

    * ``state = init_state()``
    * ``slot = open_stream(state)`` — claim a free slot
    * ``push(state, slot, samples)`` — stage samples (no device work)
    * ``ready = poll(state)`` — advance all streams with a staged hop
      (one batched device call per tick) and return ``{slot: enhanced}``
    * ``tail = drain(state, slot)`` — end-of-stream flush; frees the slot

    Streams advance independently: a laggy stream simply sits masked
    while others tick.
    """

    n_fft: int
    hop: int
    look_ahead: int
    max_streams: int

    def _dev_init_batched(self):
        raise NotImplementedError

    def _dev_reset(self, bstate, slot: int, buf: np.ndarray):
        raise NotImplementedError

    def _dev_hop_batch(self, bstate, hops: np.ndarray, active: np.ndarray):
        raise NotImplementedError

    # -- lifecycle --------------------------------------------------------

    def init_state(self):
        return {
            "device": self._dev_init_batched(),
            "slots": [None] * self.max_streams,
        }

    def open_stream(self, state) -> int:
        """Claim a free slot for a new stream. Raises when full."""
        for i, s in enumerate(state["slots"]):
            if s is None:
                rec = _new_stream_record(self.n_fft, self.look_ahead)
                rec["dev_ready"] = False
                rec["finishing"] = False
                state["slots"][i] = rec
                return i
        raise RuntimeError(f"all {self.max_streams} stream slots busy")

    def close_stream(self, state, slot: int):
        """Free a slot immediately, discarding any staged samples."""
        state["slots"][slot] = None

    # -- data path --------------------------------------------------------

    def push(self, state, slot: int, samples: np.ndarray):
        """Stage samples for ``slot``. Host-only; device work happens in
        :meth:`poll`."""
        s = state["slots"][slot]
        if s is None:
            raise ValueError(f"slot {slot} is not open")
        s["staging"] = np.concatenate(
            [s["staging"], np.asarray(samples, np.float32)]
        )

    def _prime(self, state, slot: int) -> bool:
        """Start pad + device slot init once enough samples are staged.
        Returns True when the slot can tick."""
        s = state["slots"][slot]
        if not _stage_start_pad(s, self.n_fft):
            return False
        if not s["dev_ready"]:
            need = self.n_fft - self.hop
            if len(s["staging"]) < need:
                return False
            state["device"] = self._dev_reset(
                state["device"], slot, s["staging"][:need]
            )
            s["staging"] = s["staging"][need:]
            s["dev_ready"] = True
        return True

    def poll(self, state, only: int | None = None) -> dict:
        """Advance every stream that has at least one staged hop; one
        batched device call per tick. Returns {slot: enhanced samples}
        (only slots that produced output appear). ``only`` restricts the
        tick to a single slot (used by :meth:`drain` so other streams'
        staged data stays put)."""
        out_chunks: dict[int, list] = {}
        while True:
            ready = [
                i
                for i, s in enumerate(state["slots"])
                if s is not None
                and (only is None or i == only)
                and self._prime(state, i)
                and len(s["staging"]) >= self.hop
            ]
            if not ready:
                break
            hops = np.zeros((self.max_streams, self.hop), np.float32)
            active = np.zeros((self.max_streams,), bool)
            for i in ready:
                s = state["slots"][i]
                hops[i] = s["staging"][: self.hop]
                s["staging"] = s["staging"][self.hop :]
                active[i] = True
            state["device"], outs = self._dev_hop_batch(
                state["device"], hops, active
            )
            outs = np.asarray(outs)  # one device->host transfer per tick
            for i in ready:
                out = _trim_startup(state["slots"][i], outs[i])
                if len(out):
                    out_chunks.setdefault(i, []).append(out)
            # finishing streams are freed once their staged tail is gone
            for i in ready:
                s = state["slots"][i]
                if s["finishing"] and len(s["staging"]) < self.hop:
                    self.close_stream(state, i)
        return {i: np.concatenate(c) for i, c in out_chunks.items()}

    def finish(self, state, slot: int):
        """Mark end-of-stream WITHOUT stalling other streams: stages the
        flush-tail zeros so they ride the normal batched ticks. Subsequent
        :meth:`poll` calls emit the stream's remaining samples under
        ``slot`` and free it once drained."""
        s = state["slots"][slot]
        if s is None:
            raise ValueError(f"slot {slot} is not open")
        n = _flush_blocks(self.n_fft, self.hop, self.look_ahead)
        self.push(state, slot, np.zeros(n * self.hop, np.float32))
        s["finishing"] = True

    def drain(self, state, slot: int) -> np.ndarray:
        """End of stream, synchronous: zero-feed until the pipeline is
        empty, free the slot, and return the tail samples. This ticks ONLY
        this slot (other streams' staged data stays put) across several
        sequential device calls — a serving host with other live streams
        should prefer :meth:`finish`, whose tail rides the shared ticks."""
        self.finish(state, slot)
        out = self.poll(state, only=slot)
        if state["slots"][slot] is not None:  # defensive: force-free
            self.close_stream(state, slot)
        return out.get(slot, np.zeros(0, np.float32))
