"""Streaming demodulator: chunked processing with state carryover.

Mirrors the reference's streaming mode (opv-demod.cpp:995-1125): IQ arrives
incrementally; whenever one frame's worth of samples (86,720) is buffered, a
chunk is processed; unconsumed tail samples (timing-recovery continuity) stay
at the head of the next chunk; the first chunk triggers the coarse CFO
estimate; a final partial chunk is flushed at EOF.

Array shape: the per-chunk compute is ONE jit-compiled program of fixed static
shapes (capacity-padded buffer + valid count), compiled once and reused for
every chunk including the final partial one.  All carries live in a
serializable pytree (see stream/state.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG
from opv_tpu.rx.cfo import estimate_cfo
from opv_tpu.rx.demod import loop_state_init, max_symbols
from opv_tpu.rx.pipeline import rx_block
from opv_tpu.rx.sync import sync_tracker_init


class StreamingDemodulator:
    """Incremental sample-stream -> decoded-frame-stream demodulator."""

    def __init__(self, init_offset: float | None = None,
                 afc_alpha: float = CONFIG.afc_alpha, dtype: str = "float64",
                 chunk_samples: int | None = None, on_event=None,
                 backend: str = "auto"):
        """on_event(sym_idx, code, norm, raw, misses, frames): optional
        callback fired per sync-lifecycle transition (rx.sync.EV_* codes) —
        the reference's stderr diagnostics (src/opv-demod.cpp:651-706).
        Enabling it adds the per-symbol event streams to the chunk fetch.

        backend: "auto" | "jax" | "native".  The serial AFC/TED symbol-
        tracking loop is the one part of this pipeline a host CPU runs
        faster as native code than as a lax.scan (~20 MS/s vs ~1.9; the
        reference C++ does 4.77) — "native" routes it through
        the _tracking C runtime (opv_tpu/runtime/tracking.c) and keeps the
        batched sync/Viterbi/finishing stages in JAX
        (rx/pipeline.py::rx_block_from_soft).  "auto" picks native when the
        extension is built and the float64 parity dtype is in use (the
        native loop is float64-only); decoded frames are identical at the
        project's parity standard (golden suites run on both backends,
        tests/test_native_tracking.py)."""
        self.chunk = chunk_samples or CONFIG.chunk_samples
        self.cap = self.chunk          # buffer is always <= one chunk
        self.rdtype = np.float64 if dtype == "float64" else np.float32
        self.cdtype = np.complex128 if dtype == "float64" else np.complex64
        self.afc_alpha = float(afc_alpha)
        self.max_frames = max_symbols(self.cap) // CONFIG.frame_symbols + 2

        self._buf = np.zeros(self.cap, dtype=self.cdtype)
        self._count = 0
        self._first = True
        self._init_offset = init_offset

        self.lstate = loop_state_init(0.0, dtype=jnp.dtype(self.rdtype))
        self.tstate = sync_tracker_init(dtype=jnp.dtype(self.rdtype))
        self.hist = jnp.zeros(CONFIG.encoded_bits, self.rdtype)

        self.total_samples = 0
        self.total_symbols = 0
        self.decoded = 0
        self.perfect = 0
        self.est_offset = None

        mf = self.max_frames
        aa = self.afc_alpha
        self.on_event = on_event
        ev = on_event is not None

        @jax.jit
        def _chunk_fn(samples, n_valid, lstate, tstate, hist):
            return rx_block(samples, n_valid, lstate, tstate, hist, mf,
                            afc_alpha=aa, with_events=ev)

        self._chunk_fn = _chunk_fn
        self._cfo_fn = jax.jit(estimate_cfo)

        from opv_tpu.runtime import HAVE_TRACKING, _tracking
        if backend not in ("auto", "jax", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        want_native = (backend == "native"
                       or (backend == "auto" and HAVE_TRACKING))
        if backend == "native" and not HAVE_TRACKING:
            raise RuntimeError("_tracking C extension not built "
                               "(python setup.py build_ext --inplace)")
        # the native loop is double-precision (the parity numerics)
        self.backend = ("native"
                        if want_native and self.rdtype == np.float64
                        else "jax")
        if self.backend == "native":
            self._track = _tracking.track_block
            self._params = np.array(
                [CONFIG.freq_dev, CONFIG.sample_rate, CONFIG.symbol_rate,
                 CONFIG.alpha_timing, CONFIG.beta_timing,
                 CONFIG.timing_freq_clamp, CONFIG.timing_adj_clamp,
                 CONFIG.afc_clamp_hz, self.afc_alpha], np.float64)
            self._maxs = max_symbols(self.cap)

            from opv_tpu.rx.pipeline import rx_block_from_soft

            @jax.jit
            def _soft_fn(soft, sym_valid, tstate, hist):
                return rx_block_from_soft(soft, sym_valid, tstate, hist, mf,
                                          with_events=ev)

            self._soft_fn = _soft_fn

    # -- public API ---------------------------------------------------------

    def feed(self, samples: np.ndarray):
        """Feed complex samples; yields (frame_bytes, metric, sync_q, sym_idx)
        for every decoded frame."""
        samples = np.asarray(samples, dtype=self.cdtype)
        off = 0
        results = []
        while off < len(samples):
            take = min(self.chunk - self._count, len(samples) - off)
            self._buf[self._count:self._count + take] = samples[off:off + take]
            self._count += take
            off += take
            if self._count >= self.chunk:
                results.extend(self._process(self._count))
        return results

    def flush(self):
        """Process any buffered tail (EOF), like opv-demod.cpp:1088-1113."""
        if self._count > 0:
            return self._process(self._count)
        return []

    def state_tree(self):
        """Complete serializable state: device carries AND the host-side
        seam record (buffered raw samples, first-chunk flag, counters) — a
        restore()d demodulator continues bit-exactly."""
        import numpy as _np
        return dict(
            lstate=self.lstate, tstate=self.tstate, hist=self.hist,
            buf=self._buf[:self._count].copy(),
            first=_np.bool_(self._first),
            est_offset=_np.float64(self.est_offset if self.est_offset
                                   is not None else _np.nan),
            counters=_np.array([self.total_samples, self.total_symbols,
                                self.decoded, self.perfect], dtype=_np.int64),
        )

    def restore(self, tree) -> None:
        """Adopt a state produced by state_tree() (e.g. via load_state)."""
        import numpy as _np
        self.lstate = type(self.lstate)(*[jnp.asarray(x) for x in tree["lstate"]])
        self.tstate = type(self.tstate)(*[jnp.asarray(x) for x in tree["tstate"]])
        self.hist = jnp.asarray(tree["hist"])
        buf = _np.asarray(tree["buf"])
        self._buf[:len(buf)] = buf
        self._count = len(buf)
        self._first = bool(tree["first"])
        eo = float(tree["est_offset"])
        self.est_offset = None if _np.isnan(eo) else eo
        (self.total_samples, self.total_symbols,
         self.decoded, self.perfect) = (int(x) for x in tree["counters"])

    # -- internals ----------------------------------------------------------

    def _process(self, n_valid: int):
        if self._first:
            if self._init_offset is None:
                est = float(self._cfo_fn(jnp.asarray(self._buf[:],)))
                # reference estimates on the full first chunk
            else:
                est = float(self._init_offset)
            self.est_offset = est
            self.lstate = self.lstate._replace(
                freq_offset=jnp.asarray(est, self.rdtype))
            self._first = False

        if self.backend == "native":
            ls = self.lstate
            st = np.array([float(ls.mu), float(ls.phase_f1),
                           float(ls.phase_f2), float(ls.freq_offset),
                           float(ls.timing_freq),
                           float(ls.prev_c1.real), float(ls.prev_c1.imag),
                           float(ls.prev_c2.real), float(ls.prev_c2.imag)],
                          np.float64)
            soft_b, nsym, st_b, used = self._track(
                self._buf, int(n_valid), st, self._params, self._maxs)
            stn = np.frombuffer(st_b, np.float64)
            self.lstate = type(ls)(
                mu=jnp.float64(stn[0]), phase_f1=jnp.float64(stn[1]),
                phase_f2=jnp.float64(stn[2]), freq_offset=jnp.float64(stn[3]),
                timing_freq=jnp.float64(stn[4]),
                prev_c1=jnp.complex128(stn[5] + 1j * stn[6]),
                prev_c2=jnp.complex128(stn[7] + 1j * stn[8]))
            soft = jnp.asarray(np.frombuffer(soft_b, np.float64))
            sym_valid = jnp.arange(self._maxs) < nsym
            out, self.tstate, self.hist = self._soft_fn(
                soft, sym_valid, self.tstate, self.hist)
        else:
            out, self.lstate, self.tstate, self.hist = self._chunk_fn(
                jnp.asarray(self._buf), jnp.int32(n_valid),
                self.lstate, self.tstate, self.hist)
            used = int(out["samples_used"])
        nsym = int(out["n_symbols"])
        # NB: deliberately counts the carried-over leftover samples again —
        # the reference does the same (total_samples += chunk_buf.size(),
        # opv-demod.cpp:1027), and the status line's seconds derive from it
        self.total_samples += n_valid
        base_sym = self.total_symbols
        self.total_symbols += nsym

        frames = np.asarray(out["frames"])
        metrics = np.asarray(out["metrics"])
        valid = np.asarray(out["frame_valid"])
        qs = np.asarray(out["sync_q"])
        t_idx = np.asarray(out["t_idx"])

        if self.on_event is not None:
            events = np.asarray(out["events"])
            evm = np.asarray(out["ev_misses"])
            evf = np.asarray(out["ev_frames"])
            norm = np.asarray(out["sync_norm"])
            raw = np.asarray(out["sync_raw"])
            for t in np.flatnonzero(events):
                self.on_event(base_sym + int(t), int(events[t]),
                              float(norm[t]), float(raw[t]),
                              int(evm[t]), int(evf[t]))

        results = []
        for i in np.argsort(t_idx):
            if valid[i]:
                self.decoded += 1
                if metrics[i] == 0:
                    self.perfect += 1
                results.append((bytes(frames[i]), int(metrics[i]),
                                float(qs[i]), base_sym + int(t_idx[i])))

        # keep unconsumed tail for timing continuity (opv-demod.cpp:1069-1077)
        leftover = n_valid - used
        if 0 < leftover < n_valid:
            self._buf[:leftover] = self._buf[used:n_valid]
            self._count = leftover
        else:
            self._count = 0
        return results

    @property
    def freq_offset(self) -> float:
        return float(self.lstate.freq_offset)

    @property
    def timing_freq(self) -> float:
        return float(self.lstate.timing_freq)

    @property
    def sync_state(self) -> str:
        return ["HUNTING", "VERIFYING", "LOCKED"][int(self.tstate.state)]
