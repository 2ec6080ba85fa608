"""Wideband receiver: one digitizer stream in, decoded frames from every
OPV channel out.

Composes the analysis channelizer (rx/channelizer.py) with a multichannel
streaming engine.  Feed blocks of wideband IQ at K x 2.168 MSPS; get
(channel, frame_bytes, metric, sync_quality, abs_channel_sample_pos)
tuples.  Filter history is carried across block seams so channelization is
streaming-exact.

DEVICE-RESIDENT by construction: the wideband sample buffer is a jax array,
`channelize` runs on-device, and its (K, M) output feeds the engine's
device-resident buffer directly — the only host traffic is the initial
digitizer ingest and the decoded frames/scalars coming back (SURVEY.md
section 7.4; the reference runs one opv-demod process per channel off a
host-side splitter, src/opv-demod.cpp:1046-1077).

Engines:
  * "locked" (default, production): LockedStreamDemodulator — locked-grid
    steady-state with hunt/flywheel/re-acquire lifecycle.
  * "fast": MultiChannelDemodulator — dense feed-forward correlation every
    block (no lock state; for bursty many-transmitter channels).
"""

from __future__ import annotations

import functools

import numpy as np

from opv_tpu.config import CONFIG
from opv_tpu.rx.channelizer import channelize
from opv_tpu.stream.locked import LockedStreamDemodulator
from opv_tpu.stream.multichannel import MultiChannelDemodulator


class WidebandReceiver:
    def __init__(self, k: int, block_frames: int = 4,
                 taps_per_branch: int = 12, engine: str = "locked",
                 quantum_out: int | None = None, pipeline: bool = False,
                 dtype: str = "auto", timing: bool = False, mesh=None,
                 hunt_stride: int = 1):
        """mesh: a jax.sharding.Mesh with a 'ch' axis — the MULTI-CHIP
        wideband deployment: the K-channel bank's locked engine shard_maps
        over 'ch' (stream/locked.py mesh mode) and the CHANNELIZER itself
        runs inside the same shard_mapped program — each device filters the
        (replicated) wideband stream's polyphase legs and applies only ITS
        channels' DFT-kernel columns (rx/channelizer.py::channelize_cols),
        feeding the engine's local stat+quantize+append directly.  The
        steady path stays ONE fused device program per quantum, now spanning
        N chips; no collectives touch the sample path (the psum'd decode
        count is the only cross-device op).  The reference's answer to K
        channels is K demod processes on K CPU cores behind a host splitter
        (scripts/opv-pluto.sh:290-313, src/opv-modem.cpp:391); this is that
        deployment scaled onto a device mesh, one code path with the
        single-chip receiver (emitted tuples are identical —
        tests/test_wideband.py::TestMeshWideband pins it)."""
        import jax
        import jax.numpy as jnp

        self.k = k
        self.taps = taps_per_branch
        self._hist = k * taps_per_branch - 1         # conv VALID history
        # fixed processing quantum (wideband samples per channelizer call):
        # channelize jit-compiles per input length, so ragged feeds would
        # otherwise trigger up to K recompilations; only flush sees one
        # ragged-tail compile.  The quantum must DIVIDE the inner
        # demodulator's block advance so the demod-level append/slice
        # shapes repeat after the first block — any other quantum cycles
        # the chunk-split shapes through up to advance/gcd distinct
        # values, each a fresh jit compile.  The DEFAULT is the whole block
        # advance: emission latency is identical (the engine only emits
        # when a block completes), and one quantum per block means ONE
        # fused ingest dispatch per block instead of block_frames of them
        # (a smaller quantum only reduces the wideband buffer footprint,
        # k * (quantum + taps) complex64).
        if quantum_out is None:
            quantum_out = block_frames * CONFIG.samples_per_frame
        self._quantum = k * quantum_out
        self.window = self._hist + self._quantum
        self._jnp = jnp

        # one jitted program; under a mesh the wideband buffer is born
        # REPLICATED across the mesh devices:
        # every device needs the full stream (each output channel mixes all
        # K polyphase legs), and replication is what lets the fused
        # shard_mapped ingest consume it with an unsharded in_spec.
        zeros = lambda: jnp.zeros(self.window, jnp.complex64)  # noqa: E731
        self._put_wb = functools.partial(jnp.asarray, dtype=jnp.complex64)
        if mesh is not None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            self._zeros = jax.jit(zeros,
                                  out_shardings=NamedSharding(mesh, P()))
            if any(d.process_index != jax.process_index()
                   for d in mesh.devices.flat):
                # mesh spans jax.distributed processes: feeds become
                # REPLICATED global arrays (identical digitizer chunk on
                # every host), so the fused shard_map and the general
                # append/chan/slide path both see global operands — the
                # inner engine handles its own multiprocess puts/fetches
                repl = NamedSharding(mesh, P())
                self._put_wb = (lambda a: jax.device_put(
                    np.asarray(a, np.complex64), repl))
        else:
            self._zeros = jax.jit(zeros)
        self._buf = self._zeros()
        self._count = 0                              # valid samples in _buf

        if engine == "locked":
            self.demod = LockedStreamDemodulator(channels=k,
                                                 block_frames=block_frames,
                                                 pipeline=pipeline,
                                                 dtype=dtype, timing=timing,
                                                 mesh=mesh,
                                                 hunt_stride=hunt_stride)
        elif engine == "fast":
            if pipeline:
                raise ValueError("pipeline=True requires engine='locked'")
            if mesh is not None:
                raise ValueError("mesh= requires engine='locked'")
            self.demod = MultiChannelDemodulator(channels=k,
                                                 block_frames=block_frames)
        else:
            raise ValueError("engine must be 'locked' or 'fast'")

        kk, tt = k, taps_per_branch

        def append(buf, count, x):
            return jax.lax.dynamic_update_slice(buf, x, (count,))

        def chan_full(buf):
            return channelize(buf, kk, tt)

        def slide(buf):
            # keep the filter history tail at the front for the next quantum
            kept = buf[self._quantum:]
            return jnp.concatenate(
                [kept, jnp.zeros(self._quantum, buf.dtype)])

        def ingest(buf, x):
            # steady fast path (count == hist, len(x) == one quantum):
            # append + channelize + slide fused into ONE device program
            # instead of three dispatches
            full = jax.lax.dynamic_update_slice(buf, x, (self._hist,))
            ch = channelize(full, kk, tt)
            return ch, slide(full)

        self._append = jax.jit(append, donate_argnums=(0,))
        self._chan = jax.jit(chan_full)
        self._slide = jax.jit(slide, donate_argnums=(0,))
        self._ingest = jax.jit(ingest, donate_argnums=(0,))

        # fully-fused steady ingest: channelize + engine AGC stats +
        # quantize + window append in ONE device program (engine
        # ingest_kernel), so a steady quantum costs a single dispatch
        # end-to-end.
        self._fused = None
        if engine == "locked" and mesh is None:
            kern = self.demod.ingest_kernel()

            def ingest_fused(wbuf, x, ebuf, row, scale, ss, mx):
                full = jax.lax.dynamic_update_slice(wbuf, x, (self._hist,))
                ch = channelize(full, kk, tt)
                ebuf, ss, mx = kern(ebuf, row, ch, scale, ss, mx)
                return slide(full), ebuf, ss, mx

            self._fused = jax.jit(ingest_fused, donate_argnums=(0, 2))
        elif engine == "locked":
            # MULTI-CHIP fused ingest: the same steady quantum as ONE
            # shard_mapped program over the engine's mesh.  Each device
            # holds the replicated wideband window, filters the polyphase
            # legs, applies only ITS channels' DFT-kernel columns (the
            # (2K, K, 2) dft_kernel sharded P(None, 'ch', None) — see
            # rx/channelizer.py::dft_kernel), and runs the engine's LOCAL
            # stat+quantize+append on its shard of the window buffer.  The
            # polyphase filtering (K*taps MACs/sample) is recomputed per
            # device — trivial next to shipping (K, M) channel data across
            # the mesh, and it keeps the sample path collective-free.
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            from opv_tpu.rx.channelizer import channelize_cols, dft_kernel

            kern_ing = self.demod.ingest_kernel()      # local-shape closure
            (BUF, _ROW, _CHN, CH, _, _), _ = self.demod.ingest_specs()
            self._kern_sh = jax.device_put(
                jnp.asarray(dft_kernel(k), jnp.float32),
                NamedSharding(mesh, P(None, "ch", None)))

            def ingest_fused_local(wbuf, x, kern_l, ebuf, row, scale,
                                   ss, mx):
                full = jax.lax.dynamic_update_slice(wbuf, x, (self._hist,))
                ch_l = channelize_cols(full, kern_l, kk, tt)
                ebuf, ss, mx = kern_ing(ebuf, row, ch_l, scale, ss, mx)
                return slide(full), ebuf, ss, mx

            fused = jax.jit(
                jax.shard_map(ingest_fused_local, mesh=mesh,
                              in_specs=(P(), P(), P(None, "ch", None),
                                        BUF, P(), CH, CH, CH),
                              out_specs=(P(), BUF, CH, CH),
                              check_vma=False),
                donate_argnums=(0, 3))
            self._fused = (lambda wbuf, x, ebuf, row, scale, ss, mx:
                           fused(wbuf, x, self._kern_sh, ebuf, row, scale,
                                 ss, mx))

    def feed(self, wideband):
        """wideband: (n,) complex at K*fs_ch (numpy or jax array; jax input
        never bounces to the host).  Returns decoded-frame tuples
        (channel, frame_bytes, metric, sync_quality, abs_sample_pos) with
        positions in CHANNEL-rate samples."""
        jnp = self._jnp
        x = self._put_wb(wideband)
        out = []
        off = 0
        n = x.shape[0]
        if n == self._quantum and self._count == self._hist:
            # steady fast path: exactly one quantum into a primed buffer
            q_ch = self._quantum // self.k
            if (self._fused is not None
                    and self.demod.external_ingest_ready(q_ch)):
                buf, row, scale, ss, mx = self.demod.ingest_state()
                self._buf, ebuf, ss, mx = self._fused(
                    self._buf, x, buf, row, scale, ss, mx)
                return self.demod.commit_external_ingest(ebuf, ss, mx, q_ch)
            ch, self._buf = self._ingest(self._buf, x)
            return self.demod.feed(ch)
        while off < n:
            take = min(self.window - self._count, n - off)
            self._buf = self._append(self._buf, self._count,
                                     x[off:off + take])
            self._count += take
            off += take
            if self._count >= self.window:
                out.extend(self.demod.feed(self._chan(self._buf)))
                self._buf = self._slide(self._buf)
                self._count = self._hist
        return out

    def flush(self):
        h = self._hist
        results = []
        if self._count >= h + self.k:
            # one ragged-tail compile at end of stream
            usable = h + ((self._count - h) // self.k) * self.k
            results.extend(self.demod.feed(
                channelize(self._buf[:usable], self.k, self.taps)))
        self._buf = self._zeros()
        self._count = 0
        results.extend(self.demod.flush())
        return results

    # ------------------------------------------------------------------ #
    # checkpoint/resume (stream/state.py): the wideband carry is the
    # channelizer's filter-history window plus the inner engine's full
    # state tree — restoring both resumes the digitizer stream seamlessly
    # (channelization is streaming-exact across the checkpoint boundary).

    def state_tree(self):
        fn = getattr(self.demod, "state_tree", None)
        if fn is None:
            raise RuntimeError(
                "wideband checkpointing requires engine='locked' (the "
                "'fast' engine carries no stream state worth saving)")
        return dict(buf=self._buf, count=np.int64(self._count), demod=fn())

    def load_state_tree(self, tree) -> None:
        buf = np.asarray(tree["buf"], np.complex64)
        if buf.shape != (self.window,):
            raise ValueError(
                f"checkpoint window {buf.shape} does not match this "
                f"receiver's geometry ({self.window},) — same k / "
                f"taps_per_branch / quantum required")
        # _put_wb restores the mesh-replicated (or multiprocess-global)
        # placement the constructor documents; plain asarray would leave a
        # local single-device buffer that the fused shard_map cannot mix
        # with non-addressable mesh operands
        self._buf = self._put_wb(buf)
        self._count = int(tree["count"])
        self.demod.load_state_tree(tree["demod"])

    def stats(self):
        """Inner engine per-block timing/lifecycle stats (timing=True):
        device-wait vs host-lifecycle ms split per resolved block — the
        operator-facing attribution for a sub-real-time deployment (is the
        device or the host the limiter?)."""
        fn = getattr(self.demod, "stats", None)
        return fn() if fn is not None else {}

    @property
    def decoded(self):
        return self.demod.decoded

    @property
    def perfect(self):
        return self.demod.perfect
