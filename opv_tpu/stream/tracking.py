"""Multichannel reference-parity streaming: the full tracking demodulator
(AFC + early-late timing + sync flywheel) vmapped over channels.

Unlike stream/multichannel.py (feed-forward, locked clocks), every channel
here runs the complete feedback-loop pipeline — bit-identical to running N
independent StreamingDemodulators — but all channels advance in ONE jitted
device call per chunk, with the per-symbol scans executing in lockstep
across the channel batch (the VPU sees (C, 40) blocks instead of scalars).

Per-channel chunk boundaries are preserved exactly for equal-rate channels
(each channel processes precisely 86,720-sample chunks regardless of its own
leftover drift), so parity with the single-channel driver holds channel-by-
channel.  Channels with persistently divergent sample clocks are handled
without deadlock or data loss via early short chunks (see feed()), at the
cost of exact chunk-boundary parity for the lagging channels.

NOTE: this path vmaps the tracking scans (batched dynamic slices inside) —
backends that cannot lower batched gathers should use
stream/multichannel.py + rx/locked.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG
from opv_tpu.rx.cfo import estimate_cfo_batch
from opv_tpu.rx.demod import loop_state_init, max_symbols
from opv_tpu.rx.pipeline import rx_block
from opv_tpu.rx.sync import sync_tracker_init


class MultiChannelTrackingDemodulator:
    """N-channel streaming demod with full per-channel loop tracking."""

    def __init__(self, channels: int, init_offset: float | None = None,
                 afc_alpha: float = CONFIG.afc_alpha, dtype: str = "float64"):
        self.channels = channels
        self.chunk = CONFIG.chunk_samples
        # slack beyond one chunk: per-channel leftovers drift apart, and a
        # fuller channel must be able to wait while the emptiest one reaches
        # a full chunk; with persistently divergent sample clocks the spread
        # grows unboundedly, so feed() also early-processes when a buffer
        # fills (see below)
        self.cap = self.chunk + 4096
        self.rdtype = np.float64 if dtype == "float64" else np.float32
        self.cdtype = np.complex128 if dtype == "float64" else np.complex64
        self.max_frames = max_symbols(self.cap) // CONFIG.frame_symbols + 2

        self._buf = np.zeros((channels, self.cap), dtype=self.cdtype)
        self._count = np.zeros(channels, dtype=np.int64)
        self._first = True
        self._init_offset = init_offset

        jdt = jnp.dtype(self.rdtype)
        single_l = loop_state_init(0.0, dtype=jdt)
        single_t = sync_tracker_init(dtype=jdt)
        self.lstate = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (channels, *x.shape)), single_l)
        self.tstate = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (channels, *x.shape)), single_t)
        self.hist = jnp.zeros((channels, CONFIG.encoded_bits), self.rdtype)

        self.decoded = np.zeros(channels, dtype=np.int64)
        self.perfect = np.zeros(channels, dtype=np.int64)
        self.total_symbols = np.zeros(channels, dtype=np.int64)
        self.est_offset = None

        mf = self.max_frames
        aa = float(afc_alpha)

        @jax.jit
        def _chunk_fn(samples, n_valid, lstate, tstate, hist):
            return jax.vmap(
                lambda s, n, l, t, h: rx_block(s, n, l, t, h, mf, afc_alpha=aa)
            )(samples, n_valid, lstate, tstate, hist)

        self._chunk_fn = _chunk_fn

    def feed(self, samples: np.ndarray):
        """samples: (C, n).  Returns list of (channel, frame_bytes, metric,
        sync_q, symbol_idx)."""
        samples = np.asarray(samples, dtype=self.cdtype)
        if samples.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels")
        out = []
        off = 0
        n = samples.shape[1]
        while off < n:
            room = self.cap - self._count
            take = min(int(room.min()), n - off)
            if take > 0:
                for c in range(self.channels):
                    self._buf[c, self._count[c]:self._count[c] + take] = \
                        samples[c, off:off + take]
                self._count += take
                off += take
            if (self._count >= self.chunk).all():
                out.extend(self._process(np.minimum(self._count, self.chunk)))
            elif take <= 0:
                # a channel's buffer is full while another lags (divergent
                # sample clocks): process what each channel has rather than
                # deadlocking.  Lagging channels see a slightly short chunk —
                # per-channel bit-parity with independent drivers holds only
                # for equal-rate channels, but no input is ever dropped.
                out.extend(self._process(np.minimum(self._count, self.chunk)))
        return out

    def flush(self):
        if (self._count > 0).any():
            res = self._process(self._count.copy())
            self._count[:] = 0
            return res
        return []

    def _process(self, n_valid: np.ndarray):
        if self._first:
            if self._init_offset is None:
                est = np.asarray(estimate_cfo_batch(jnp.asarray(self._buf)))
            else:
                est = np.full(self.channels, float(self._init_offset))
            self.est_offset = est
            self.lstate = self.lstate._replace(
                freq_offset=jnp.asarray(est.astype(self.rdtype)))
            self._first = False

        out, self.lstate, self.tstate, self.hist = self._chunk_fn(
            jnp.asarray(self._buf), jnp.asarray(n_valid.astype(np.int32)),
            self.lstate, self.tstate, self.hist)

        used = np.asarray(out["samples_used"])
        nsym = np.asarray(out["n_symbols"])
        frames = np.asarray(out["frames"])
        metrics = np.asarray(out["metrics"])
        valid = np.asarray(out["frame_valid"])
        qs = np.asarray(out["sync_q"])
        t_idx = np.asarray(out["t_idx"])

        results = []
        for c in range(self.channels):
            base = self.total_symbols[c]
            for i in np.argsort(t_idx[c]):
                if valid[c, i]:
                    self.decoded[c] += 1
                    if metrics[c, i] == 0:
                        self.perfect[c] += 1
                    results.append((c, bytes(frames[c, i]), int(metrics[c, i]),
                                    float(qs[c, i]), int(base + t_idx[c, i])))
            self.total_symbols[c] += nsym[c]
            leftover = int(n_valid[c]) - int(used[c])
            extra = int(self._count[c]) - int(n_valid[c])
            keep = leftover + extra
            if 0 < keep <= self._count[c]:
                self._buf[c, :keep] = self._buf[c, int(used[c]):int(self._count[c])]
            self._count[c] = keep
        return results

    @property
    def freq_offset(self):
        return np.asarray(self.lstate.freq_offset)

    @property
    def sync_state(self):
        return [["HUNTING", "VERIFYING", "LOCKED"][int(s)]
                for s in np.asarray(self.tstate.state)]
