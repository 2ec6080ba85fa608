"""Locked-grid streaming driver — the production multichannel engine.

Wraps rx_locked / rx_locked_steady (rx/locked.py) in a stateful
block-streaming class with the reference's sync lifecycle
(src/opv-demod.cpp:615-736) mapped onto the locked-grid pipeline:

  * HUNTING: unlocked channels re-acquire every block (CFO grid + dense
    sync acquisition, rx_locked_reacquire) — the reference's coarse
    estimate + HUNTING state.  A channel locks when a frame's sync meets
    the hunting thresholds (norm >= 0.85 AND raw >= 5000,
    src/opv-demod.cpp:783-786).
  * LOCKED: all-locked blocks run rx_locked_steady — pure symbol-rate
    body, no acquisition (the reference's LOCKED state, which re-checks
    sync at frame rate instead of re-hunting).  Each frame's sync quality
    is the re-check; q >= 0.70 keeps the lock.
  * FLYWHEEL: up to sync_miss_limit (5) consecutive sub-threshold syncs
    still emit frames on the predicted grid (src/opv-demod.cpp:60,
    697-713); one more miss drops the channel back to HUNTING.

Blocks advance by an exact multiple of 86,720 samples so p0 (the sync
sample position within the window) is invariant across blocks for locked
channels — re-acquisition only happens on lock loss, making the steady
path ~40x cheaper than dense correlation (see rx/locked.py).

The sample buffer is device-resident: callers may feed jax arrays that
never touch the host (bench.py does), and only decoded frames/scalars are
fetched.  All channels advance in lockstep; each block is ONE jit-compiled
device invocation.

pipeline=True additionally overlaps the host lifecycle with device
compute: block N's program launches BEFORE block N-1's results are
fetched (p0/freq_offset chain device-to-device), and a misprediction of
the host-side lock/refresh state relaunches block N on its retained
window — emitted tuples are bit-identical to the synchronous driver's
(pinned by test_locked_stream.TestPipelined); only rare lock-transition
blocks pay duplicate device work.  The reference has no analog (its demod
is synchronous per chunk, src/opv-demod.cpp:1022-1085); this is the
framework's answer to keeping an accelerator busy from a host-side
state machine.

The buffer holds (C, window/40, 80) WINDOW ROWS — row s is samples
[40s, 40s+40) as 80 interleaved I/Q values: float32 by default, with
bfloat16 and int8 selectable (int8: the correlation runs as an exact
s8 x s8 -> s32 matmul with the step adapted per channel by AGC, which
halves the soft stage's read vs bf16 at float-identical decoded frames,
test_locked.py::TestInt8Buffer).  This is the steady body's matmul
operand shape DIRECTLY (rx/locked.py _symbol_soft_batch), so the hot path
reads the buffer with no relayout copy.  Complex is materialized only on
the rare re-acquire / retime paths, which need the dense complex
correlators.  Callers may feed (C, n) complex (converted during append,
one fused pass over the chunk) or
(C, n, 2) float32 / int16 pairs (cast during append — int16 is the radio
wire format); feeds of any length are accepted — a sub-row tail (< 40
samples) pends until the next feed.
"""

from __future__ import annotations

import functools
import time

import numpy as np

from opv_tpu.config import CONFIG


class LockedStreamDemodulator:
    """Feed (C, n) complex sample blocks; yields (channel, frame_bytes,
    metric, sync_quality, abs_sample_pos) tuples, where abs_sample_pos is
    the absolute stream index of the frame's sync-word start."""

    #: proactive timing refresh: a locked channel showing early timing-slip
    #: symptoms gets a per-channel sample-granular p0 correction
    #: (rx_locked_retime: dense sync correlation over +-half a symbol around
    #: the next expected sync) at the next block boundary.  A slowly
    #: drifting sample clock (ppm-scale crystal error) corrupts payload
    #: soft values BEFORE the 24-symbol sync correlation decays, so two
    #: triggers are watched:
    #:   * sync quality below REFRESH_Q (still well above the 0.70 gate),
    #:   * the Viterbi metric rising REFRESH_METRIC_RISE above the
    #:     channel's running average (EMA) while above an absolute floor —
    #:     amplitude-normalized by quantize_soft, so it is a direct FEC-
    #:     margin gauge; it climbs smoothly with timing error long before
    #:     frames start failing (~3500 on this code).
    #: The retimed grid keeps its lock and loses ZERO frames (backward
    #: wraps emit the straddling frame via an extra slot), instead of
    #: riding the flywheel into mis-timed frames and a 5-frame drop
    #: (deliberate improvement over the reference, which has no locked-
    #: state timing feedback; its AFC handles frequency drift only).
    #: thresholds sized so the correction lands while timing error is still
    #: ~1/4 symbol (FEC headroom: frames corrupt near metric ~3400; a late
    #: trigger is unrecoverable on a backward wrap, which rides the old
    #: grid one extra block).  The EMA-rise gate keeps steady-noise
    #: channels (whose absolute metric floor can exceed these values) from
    #: re-timing every block; a spurious trigger costs one ~1000-sample
    #: correlation and applies a zero delta.
    REFRESH_Q = 0.90
    REFRESH_METRIC_RISE = 400
    REFRESH_METRIC_MIN = 400
    _EMA_ALPHA = 0.1
    #: timing-refresh blending: a retime estimate within this many samples
    #: of the carried grid is noise-regime — its FOLD is accumulated into a
    #: per-channel grow-into-EMA running sum of the folded sync-correlation
    #: segment itself (uniform until the EMA depth, then decay below; see
    #: _run_block), and the grid re-estimates from the accumulated fold:
    #: averaging the sufficient statistic instead of the noisy per-window
    #: argmax estimates deepens the effective fold ~(1+d)/(1-d) x the
    #: window depth and is robust to the waterfall's occasional multi-
    #: sample argmax outliers (a depth-5 window fold can argmax several
    #: samples off at 7 dB).  A larger jump may be a real
    #: drift event (the drift tests' ppm-scale slips move 2-6 samples per
    #: refresh) OR a waterfall argmax outlier — drift is persistent block
    #: to block while outliers are not, so the jump is adopted only when
    #: two consecutive retimes propose a drift-sized move the SAME WAY
    #: (_big_dir) AND a deep accumulator corroborates its magnitude (see
    #: `agree` in _run_block); on adoption the accumulator resets to the
    #: fresh fold.
    _TIMING_TRUST = 2.0
    #: 0.97 ~ 33-window memory: x4 fold intervals per retime ~ the batch
    #: acquisition's 128-deep fold, which measures 0.05 samples from truth
    #: at 7 dB where a depth-4 window fold scatters +-4 (measured with
    #: tools/timing_pin_probe.py)
    _FOLD_DECAY = 0.97
    #: accumulated-weight threshold above which the deep fold outvotes a
    #: sign-confirmed big jump unless it agrees with its direction
    _FOLD_DEEP = 6.0
    #: warmup: a locked channel retimes EVERY block until its accumulator
    #: holds ~this many fold INTERVALS (window count x block_frames) —
    #: the single-window hunt grid can sit several samples off at
    #: waterfall SNR, and the symptom gates (REFRESH_Q, metric rise) fire
    #: too rarely at 8-10 dB to build depth.  ~100 folds ~ the batch
    #: 128-deep fold; after warmup the cadence returns to symptom-gated
    _FOLD_WARM_FOLDS = 100.0
    #: ... but only for channels that NEED it: warmup retimes cost one
    #: extra device dispatch + blocking fetch per block, and a clean
    #: channel's hunt grid is already decisive.  The Viterbi metric EMA is
    #: the regime gauge — ~0-50 on clean decodes, >1000 across the 8-10 dB
    #: waterfall — so clean steady channels pay no standing warmup cost
    _WARM_METRIC_MIN = 100.0

    #: int8 AGC: re-evaluate the per-channel quantization scale every this
    #: many resolved blocks (one tiny stats fetch each time; per-block
    #: fetches would double the blocking fetches of the streaming loop)
    _AGC_BLOCKS = 8
    #: target step: clip at ~3.5 sigma of the input (Gaussian clip rate
    #: ~0.05%) unless the true peak is smaller (clean constant-envelope
    #: signals: peak < 1.5 sigma, so the step follows the peak exactly and
    #: a wire-full-scale signal reproduces the fixed INT8_SCALE = 16383/127)
    _AGC_SIGMA = 3.5
    #: adoption hysteresis: only re-quantize when the desired step moved
    #: outside [1/1.4, 1.4]x the current one (steady streams never rescale)
    _AGC_BAND = 1.4

    def __init__(self, channels: int, block_frames: int = 4,
                 dtype: str = "auto", pipeline: bool = False,
                 agc: bool = True, mesh=None,
                 single_frame_burst: bool = True, timing: bool = False,
                 eager: bool = False, hunt_stride: int = 1):
        """dtype: buffer element type for the (C, window/40, 80) window-row
        buffer — "float32", "bfloat16", "int8", or "auto" (float32 on
        every platform; a GPU default other than float32 waits for a
        measured BER and speed comparison).  bf16 halves buffer memory and
        the steady matmul's read at <=0.4% sample quantization (see
        rx/locked.py _symbol_soft_batch).  "int8" halves the
        buffer and the soft-stage read once more (samples quantize to
        wire/scale on append; the correlation runs as an exact
        s8 x s8 -> s32 matmul rescaled to wire-scale f32) — decoded frames
        match the float paths on clean and moderate-SNR streams
        (test_locked.py::TestInt8Buffer); the re-acquire/retime dense paths
        reconstruct complex from the quantized buffer, so hunting SNR drops
        ~0.03 dB.

        agc (int8 buffers only): adapt the quantization step per channel to
        the measured input level — step = min(peak, 3.5 x rms) / 127,
        re-evaluated every _AGC_BLOCKS blocks from feed-time statistics
        (plus once, synchronously, on the first feed so the initial window
        is quantized at the right step).  Without it the fixed wire-full-
        scale step soft-clips AWGN excursions on deep-low-SNR streams
        (~1.5 dB at the FEC waterfall) and throws away 5-6
        bits of resolution on weak (far-below-full-scale) inputs.  A
        wire-full-scale clean signal adopts exactly the fixed INT8_SCALE
        step, so AGC leaves full-scale captures bit-identical.  Scale
        changes re-quantize the buffered window in place (round(buf x
        old/new)); the hysteresis band keeps steady streams from ever
        rescaling.

        pipeline: defer each block's host-side sync lifecycle by one block.
        Block N's program is launched BEFORE block N-1's results are
        fetched — p0/freq_offset chain device-to-device from N-1's
        (unfetched) outputs, and the program choice (steady vs re-acquire)
        is predicted from the last RESOLVED lock state.  The result fetch
        then overlaps block N's device compute, so the device never idles
        on the host lifecycle or the fetch link.  If resolving N-1 proves
        the prediction wrong (a lock changed, or a timing refresh is due),
        block N is relaunched on its retained window with the corrected
        state — output is therefore IDENTICAL to the synchronous driver,
        tuple for tuple (test_locked_stream pins this); mispredictions only
        cost duplicate device work on the rare lock-transition blocks.
        Checkpointing requires a quiesced stream: state_tree() raises while
        a block is in flight (flush() first, or checkpoint at flush
        boundaries).

        mesh: a jax.sharding.Mesh with a 'ch' axis — the MULTI-CHIP
        production mode (SURVEY.md section 2 parallelism table: channel
        parallelism is the reference's process-per-radio, opv-modem.cpp:391,
        scaled onto a device mesh).  Every device program in this driver
        (steady body, re-acquire, retime, append, slide, AGC stats/requant)
        is shard_mapped over 'ch': the (C, window/40, 80) buffer lives
        device-sharded on axis 0 and NEVER gathers; each device runs the
        identical locked-grid body on its C/nch local channels (including
        the row-slice scans, which stay local-shape).  Only per-channel
        scalars (p0, freq_offset, sync_q, metrics) and decoded frame bytes
        cross the device links; the global decode count is a psum.  The
        host sync lifecycle is untouched — it already runs on (C,) numpy
        scalars, so sharded and single-device drivers emit IDENTICAL tuple
        streams (test_locked_stream.TestShardedLocked pins this).  Any
        extra mesh axes are unused (work replicates across them); channels
        must divide the 'ch' axis size.

        hunt_stride: dense re-hunt stride in samples (default 1 = ONE
        monolithic re-acquire program, the production setting).
        hunt_stride=2 runs the re-acquire as FOUR chained device programs
        — stride-2 dense hunt (detection-safe on the 2-sample MSK sync
        apex plateau), CFO, full-resolution slab refine, steady decode
        body — halving the dense pass, the dominant re-acquire COMPUTE
        on the accelerator it was first built for.  End to end it lost
        there on the bursty deployment: four dispatches instead of one,
        plus slightly worse acquired grids that trigger extra warmup
        retimes, each a blocking fetch.  It stays opt-in until an A/B on
        the GPU decides (ROADMAP D3).  TestSplitHunt pins that both
        settings recover identical true frames at identical positions."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P
        from opv_tpu.rx.locked import (fold_est_np, rx_locked_hunt_strided,
                                       rx_locked_reacquire,
                                       rx_locked_retime, rx_locked_steady)

        self._fold_est_np = fold_est_np

        self.mesh = mesh
        if mesh is not None:
            if "ch" not in mesh.shape:
                raise ValueError("mesh must carry a 'ch' axis")
            if channels % mesh.shape["ch"]:
                raise ValueError(
                    f"{channels} channels not divisible by ch-axis size "
                    f"{mesh.shape['ch']}")

            def jit_s(fn, in_specs, out_specs, **kw):
                return jax.jit(jax.shard_map(fn, mesh=mesh,
                                             in_specs=in_specs,
                                             out_specs=out_specs,
                                             check_vma=False), **kw)

            self._put = functools.partial(
                jax.device_put, device=NamedSharding(mesh, P("ch")))
            # a mesh spanning PROCESS boundaries (multi-host slice /
            # jax.distributed): device_put of an identical-on-all-hosts
            # numpy array to the global sharding works as-is, but fetching
            # a non-addressable result requires the collective gather —
            # every process receives the full result pytree, so the host
            # sync lifecycle stays byte-identical on all hosts
            # (tests/test_multihost.py::test_two_process_locked_engine)
            if any(d.process_index != jax.process_index()
                   for d in mesh.devices.flat):
                from jax.experimental import multihost_utils
                self._get = functools.partial(
                    multihost_utils.process_allgather, tiled=True)
                # feeds must reach device_put as HOST arrays (a
                # single-device jax intermediate is not resharddable to a
                # non-addressable sharding); every process feeds the
                # identical full (C, n) chunk.  A REPLICATED global array
                # (e.g. the multiproc wideband receiver's channelizer
                # output) is materialized from its local shard — which IS
                # the full value for a replicated sharding.
                put_g = self._put

                self._multiproc = True

                def _mp_put(a):
                    if (isinstance(a, jax.Array)
                            and not a.is_fully_addressable):
                        if not a.sharding.is_fully_replicated:
                            raise ValueError(
                                "multiprocess feed needs a host array or "
                                "a replicated global array")
                        a = np.asarray(a.addressable_shards[0].data)
                    return put_g(np.asarray(a))
                self._put = _mp_put
            else:
                self._get = jax.device_get

            def globalize(out):          # per-shard counts -> global
                out = dict(out)
                out["n_decoded"] = jax.lax.psum(out["n_decoded"], "ch")
                return out
        else:
            def jit_s(fn, in_specs, out_specs, **kw):
                return jax.jit(fn, **kw)

            self._put = jnp.asarray
            self._get = jax.device_get
            globalize = lambda out: out  # noqa: E731

        # LOCAL channel count: shard_map bodies see per-device shapes, so
        # every reshape inside the jitted closures uses lc, not channels
        lc = channels // mesh.shape["ch"] if mesh is not None else channels

        # shard_map axis specs (ignored when mesh is None)
        CH = P("ch")                     # (C,) per-channel scalars
        BUF = P("ch", None, None)        # (C, rows, 80) window buffer
        CHN = P("ch", None)              # (C, t) complex chunks
        OUT = dict(frames=P("ch", None, None), metrics=P("ch", None),
                   frame_valid=P("ch", None), sync_q=P("ch", None),
                   sync_raw=P("ch", None), decode_ok=P("ch", None),
                   p0=CH, freq_offset=CH, frac=CH, n_decoded=P())

        if dtype == "auto":
            dtype = "float32"
        self.dtype = jnp.dtype(dtype)
        int8 = self.dtype == jnp.int8
        # sub-row pend carry stays at WIRE scale (int8's buffer domain is
        # quantized; re-quantizing a quantized tail would double-divide)
        self._wire = jnp.dtype(jnp.float32) if int8 else self.dtype
        from opv_tpu.rx.locked import INT8_SCALE

        def conv(x, scale):              # wire-scale pairs -> buffer domain
            if int8:
                q = jnp.round(x.astype(jnp.float32)
                              / scale[:, None, None])
                return jnp.clip(q, -127, 127).astype(jnp.int8)
            return x.astype(self.dtype)

        def _cplx(buf, scale):           # (C, R, 80) rows -> (C, R*40) c64
            f = buf.astype(jnp.float32).reshape(lc, -1, 2)
            if int8:
                f = f * scale[:, None, None]   # back to wire scale
            return jax.lax.complex(f[..., 0], f[..., 1])

        self._retime = jit_s(
            lambda b, p, f, sc: rx_locked_retime(_cplx(b, sc), p, f,
                                                 n_frames=block_frames),
            (BUF, CH, CH, CH), (CH, CH, CH))

        self.channels = channels
        self.block_frames = block_frames
        self.hunt_stride = hunt_stride
        spf = CONFIG.samples_per_frame
        self.spf = spf
        self.advance = block_frames * spf
        # window: p0 < 86,720 plus block_frames full frames plus enough
        # slack (1040 = sync window + correlator tail + margin) that
        # hunt_grid's next-frame verification covers every sync position
        # owned by this block (p < advance needs norm at p + spf)
        self.window = (block_frames + 1) * spf + 1040
        self.sps = CONFIG.samples_per_symbol     # row width in samples
        assert self.window % self.sps == 0 and self.advance % self.sps == 0
        self._jnp = jnp
        self._jax = jax

        # one jitted program; under a mesh each shard zeros its own local
        # rows — the buffer is born sharded.
        self._zeros = jit_s(lambda: jnp.zeros(
            (lc, self.window // self.sps, 2 * self.sps), self.dtype),
            (), BUF)
        self._buf = self._zeros()
        self._count = 0                 # valid samples in buffer
        self._pend = None               # (C, <40, 2) sub-row feed tail
        self._abs_base = 0              # absolute index of buffer sample 0

        # per-channel lock state (host side: tiny, drives which program runs)
        self._state_cache = {}           # content-cached device copies
        self.p0 = np.zeros(channels, np.int32)
        self.frac = np.zeros(channels, np.float32)   # sub-sample timing
        self.freq_offset = np.zeros(channels, np.float32)
        self.locked = np.zeros(channels, bool)
        self.miss = np.zeros(channels, np.int32)    # consecutive sync misses
        self.refresh = np.zeros(channels, bool)     # re-hunt next block
        self._want_refresh = np.zeros(channels, bool)
        self.metric_ema = np.full(channels, np.nan)  # per-channel baseline
        self.refreshes = 0               # completed drift refreshes (p0 moved)
        # cross-block folded-timing accumulator (see _FOLD_DECAY): bin b of
        # row c maps to sample offset p0[c] - 20 + b of the current window
        self._fold_acc = np.zeros((channels, 2 * (CONFIG.samples_per_symbol
                                                  // 2) + 3), np.float64)
        self._fold_ok = np.zeros(channels, bool)
        self._fold_w = np.zeros(channels)   # decayed window count (depth)
        # sign of the last UNCONFIRMED drift-sized retime proposal (0 =
        # none): a big jump is only adopted when two consecutive retimes
        # agree on its direction (see _TIMING_TRUST comment)
        self._big_dir = np.zeros(channels, np.int8)

        self.decoded = 0
        self.perfect = 0
        self.reacquisitions = 0          # blocks that ran the re-acquire path

        bf = block_frames

        def steady(buf, p0, foff, scale, frac):
            return globalize(rx_locked_steady(buf, p0, foff, n_frames=bf,
                                              scale=scale if int8 else None,
                                              frac=frac))

        def steady_x(buf, p0, foff, scale, frac):
            # one extra slot: used on drift-wrap blocks, where a channel's
            # grid steps back across the window start and the straddling
            # frame (still fully inside this window's overlap) must be
            # emitted before the grid advances a frame (see _process)
            return globalize(rx_locked_steady(buf, p0, foff,
                                              n_frames=bf + 1,
                                              scale=scale if int8 else None,
                                              frac=frac))

        def reacquire(buf, p0, foff, keep, scale, frac):
            return globalize(rx_locked_reacquire(_cplx(buf, scale), p0, foff,
                                                 keep, n_frames=bf,
                                                 frac_old=frac))

        sps = self.sps

        def append(buf, row, x, scale):  # x: (C, t, 2) wire-scale pairs
            rows = conv(x, scale).reshape(lc, -1, 2 * sps)
            return jax.lax.dynamic_update_slice(buf, rows, (0, row, 0))

        def append_c(buf, row, x, scale):  # complex chunk -> rows, fused
            xi = jnp.stack([x.real, x.imag], axis=-1)
            rows = conv(xi, scale).reshape(lc, -1, 2 * sps)
            return jax.lax.dynamic_update_slice(buf, rows, (0, row, 0))

        def stat_p(ss, mx, x):           # AGC stats: (C, t, 2) pairs
            xf = x.astype(jnp.float32)
            return (ss + (xf * xf).sum(axis=(1, 2)),
                    jnp.maximum(mx, jnp.abs(xf).max(axis=(1, 2))))

        def stat_c(ss, mx, x):           # AGC stats: (C, t) complex
            r = x.real.astype(jnp.float32)
            i = x.imag.astype(jnp.float32)
            return (ss + (r * r + i * i).sum(axis=1),
                    jnp.maximum(mx, jnp.maximum(jnp.abs(r).max(axis=1),
                                                jnp.abs(i).max(axis=1))))

        agc_en = bool(agc) and int8

        def ingest_c(buf, row, x, scale, ss, mx):
            # AGC stat accumulate + quantize + row append in ONE device
            # program: the row-aligned streaming fast path and the
            # wideband receiver's fused channelize ride this instead of
            # separate stat/append dispatches
            if agc_en:
                ss, mx = stat_c(ss, mx, x)
            xi = jnp.stack([x.real, x.imag], axis=-1)
            rows = conv(xi, scale).reshape(lc, -1, 2 * sps)
            return (jax.lax.dynamic_update_slice(buf, rows, (0, row, 0)),
                    ss, mx)

        def ingest_p(buf, row, x, scale, ss, mx):  # (C, t, 2) wire pairs
            if agc_en:
                ss, mx = stat_p(ss, mx, x)
            rows = conv(x, scale).reshape(lc, -1, 2 * sps)
            return (jax.lax.dynamic_update_slice(buf, rows, (0, row, 0)),
                    ss, mx)

        def requant(buf, factor):        # int8 step change: old/new ratio
            q = jnp.round(buf.astype(jnp.float32) * factor[:, None, None])
            return jnp.clip(q, -127, 127).astype(jnp.int8)

        def pairs_c(x):                  # complex chunk -> wire-scale pairs
            return jnp.stack([x.real.astype(self._wire),
                              x.imag.astype(self._wire)], axis=-1)

        def slide(buf):
            adv = self.advance // sps
            kept = buf[:, adv:]
            pad = jnp.zeros((lc, adv, 2 * sps), buf.dtype)
            return jnp.concatenate([kept, pad], axis=1)

        PRS = P("ch", None, None)        # (C, t, 2) wire-scale pairs
        self._conv = jit_s(conv, (PRS, CH), PRS)
        self._int8 = int8
        self._int8_scale = INT8_SCALE
        self._steady = jit_s(steady, (BUF, CH, CH, CH, CH), OUT)
        self._steady_x = jit_s(steady_x, (BUF, CH, CH, CH, CH), OUT)
        OUT_R = dict(OUT, burst_only=CH)   # reacquire adds the salvage flag
        if hunt_stride > 1:
            # split re-acquire: FOUR chained device programs (see the
            # __init__ hunt_stride docstring) — stride-2 dense hunt, CFO,
            # full-res slab refine, steady body.  Chaining happens
            # device-to-device (async dispatches), so the host still pays
            # exactly one result fetch per re-acquire.
            assert CONFIG.samples_per_symbol % hunt_stride == 0
            from opv_tpu.rx.locked import (refine_timing_locked,
                                           rx_locked_reacquire_cfo)

            def hunt2(buf, p0, foff, keep, scale):
                return rx_locked_hunt_strided(_cplx(buf, scale), p0, foff,
                                              keep, stride=hunt_stride)

            def cfo2(buf, p0, foff, keep, scale):
                return rx_locked_reacquire_cfo(_cplx(buf, scale), p0,
                                               foff, keep)

            def sref2(buf, p0, foff, scale):
                p0r, frac_r, _fold = refine_timing_locked(
                    _cplx(buf, scale), p0, foff, n_frames=bf)
                return p0r, frac_r

            def reacq_body(buf, p0, acq, p0r, frac_r, foff, scale, frac):
                p0f = jnp.where(acq, p0r, p0)
                fr = jnp.where(acq, frac_r, frac.astype(jnp.float32))
                return globalize(rx_locked_steady(_cplx(buf, scale), p0f,
                                                  foff, n_frames=bf,
                                                  frac=fr))

            HOUT = dict(p0=CH, acquired=CH, burst_only=CH)
            h_prog = jit_s(hunt2, (BUF, CH, CH, CH, CH), HOUT)
            c_prog = jit_s(cfo2, (BUF, CH, CH, CH, CH), CH)
            s_prog = jit_s(sref2, (BUF, CH, CH, CH), (CH, CH))
            b_prog = jit_s(reacq_body,
                           (BUF, CH, CH, CH, CH, CH, CH, CH), OUT)

            def reacquire_chain(buf, p0, foff, keep, scale, frac):
                h = h_prog(buf, p0, foff, keep, scale)
                f2 = c_prog(buf, h["p0"], foff, keep, scale)
                p0r, frac_r = s_prog(buf, h["p0"], f2, scale)
                out = dict(b_prog(buf, h["p0"], h["acquired"], p0r,
                                  frac_r, f2, scale, frac))
                out["burst_only"] = h["burst_only"]
                return out

            self._reacquire = reacquire_chain
        else:
            self._reacquire = jit_s(reacquire, (BUF, CH, CH, CH, CH, CH),
                                    OUT_R)
        self._append = jit_s(append, (BUF, P(), PRS, CH), BUF,
                             donate_argnums=(0,))
        self._append_c = jit_s(append_c, (BUF, P(), CHN, CH), BUF,
                               donate_argnums=(0,))
        self._ingest_c_fn = ingest_c     # raw closure (ingest_kernel)
        self._ingest_c = jit_s(ingest_c, (BUF, P(), CHN, CH, CH, CH),
                               (BUF, CH, CH), donate_argnums=(0,))
        self._ingest_p = jit_s(ingest_p, (BUF, P(), PRS, CH, CH, CH),
                               (BUF, CH, CH), donate_argnums=(0,))
        self._pairs_c = jit_s(pairs_c, (CHN,), PRS)
        self._slide = jit_s(slide, (BUF,), BUF, donate_argnums=(0,))
        # pipelined mode keeps the in-flight block's window alive for a
        # possible relaunch, so its slide cannot donate the input
        self._slide_copy = jit_s(slide, (BUF,), BUF)

        # int8 AGC state: per-channel quantization step (wire units per
        # int8 LSB, device + host mirror) and feed-time level statistics
        # (device-resident; fetched only at AGC cadence).  Non-int8 buffers
        # carry the dummy scale operand through the jitted closures (traced
        # but unused -> dropped by XLA).
        self._agc = bool(agc) and int8
        self._scale_np = np.full(channels, INT8_SCALE, np.float32)
        self._scale = self._put(self._scale_np)
        self._stat_p = jit_s(stat_p, (CH, CH, PRS), (CH, CH))
        self._stat_c = jit_s(stat_c, (CH, CH, CHN), (CH, CH))
        self._requant = jit_s(requant, (BUF, CH), BUF)
        self._stat_ss = self._put(np.zeros(channels, np.float32))
        self._stat_max = self._put(np.zeros(channels, np.float32))
        self._stat_cnt = 0               # components accumulated (host)
        self._blocks = 0                 # resolved blocks (AGC cadence)
        self._agc_primed = not self._agc

        #: eager (low-latency serving) mode: a pure-steady block (all
        #: channels locked, no flywheel misses, no refresh pending) is
        #: processed as soon as every OWNED slot's samples are buffered —
        #: count >= max(p0) + advance + one symbol — instead of waiting for
        #: window completion.  The buffer tail past count is zeros (slide
        #: pads, appends fill), and the steady program's outputs for a slot
        #: depend only on samples < pos + spf + 40 (exactly flush()'s
        #: valid_limit rejection rule, which is pinned block-exact), so
        #: eager blocks emit IDENTICAL tuples one window-tail earlier.
        #: With block_frames=1 this cuts the serving gate from ~2 frame
        #: times (window = 2*spf + 1040) to ~1 (the reference modem's own
        #: chunk-gate latency, opv-modem.cpp:875-961) — opv-modem --fast
        #: runs this mode (VERDICT r4 item 5).  Hunting/flywheel/refresh
        #: blocks fall back to the full-window gate (a re-hunt needs the
        #: window's verification slack).  int8+AGC caveat: eager blocks
        #: resolve one window-tail earlier in the FEED stream, so the AGC
        #: cadence evaluates its level statistics over slightly different
        #: windows than the window-gated driver — a step adoption sitting
        #: exactly on the hysteresis band can flip, making int8 tuples
        #: value-identical-per-step but not guaranteed stream-identical
        #: (float buffers, the default, are exactly identical — TestEager
        #: pins that).
        #: eager engages only when a lock DROP inside an eager block is
        #: impossible (a drop needs sync_miss_limit+1 misses and blocks
        #: enter eager with miss == 0): the drop path's same-window
        #: re-hunt on a partial window could otherwise miss a burst whose
        #: sync fits the full window but not the eager extent, and that
        #: frame would never be re-owned after the advance.  Serving uses
        #: block_frames=1; larger-block engines silently keep the
        #: window gate.
        self._eager = bool(eager) and block_frames <= CONFIG.sync_miss_limit
        if eager and pipeline:
            raise ValueError("eager (low-latency) and pipeline "
                             "(throughput) modes are mutually exclusive")
        self.pipeline = bool(pipeline)
        self._pending = None            # in-flight block (pipeline mode)
        #: per-block device/host time split (SURVEY.md section 5 tracing
        #: row): timing=True records, for every resolved block, the program
        #: tag (steady/steady_x/reacquire), the time spent waiting on the
        #: device result (device compute + fetch; in pipeline mode the
        #: overlap makes this the EXPOSED wait, which is the number an
        #: operator needs), and the host lifecycle time.  Read via
        #: block_stats (list of dicts) or stats() (aggregate); the demod
        #: CLI surfaces both under --metrics and can wrap the whole run in
        #: a jax.profiler.trace via --profile DIR.
        self.timing = bool(timing)
        self.block_stats: list = []
        #: emit an isolated single-frame burst's frame without locking
        #: (rx/locked.py hunt_grid docstring) — reference semantics
        #: (opv-demod.cpp:657-680) minus the false-lock cost.  Off: such
        #: bursts are silently dropped (the pre-round-3 behavior).
        self._burst_salvage = bool(single_frame_burst)

    # ------------------------------------------------------------------ #

    def feed(self, samples):
        """samples: (C, n) complex64 OR (C, n, 2) IQ pairs (float32,
        int16 wire format, or bfloat16; numpy or jax array — pairs are cast
        to the buffer dtype on device during the append).  Any n is
        accepted; appends are row-aligned (40 samples), so a sub-row tail
        pends until the next feed/flush.  Returns decoded frame tuples for
        every full window completed by this feed."""
        jnp = self._jnp
        if samples.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels")
        ilv = samples.ndim == 3
        if getattr(self, "_multiproc", False):
            # host arrays go STRAIGHT to the global device_put — a local
            # jnp.asarray intermediate would bounce the whole chunk
            # host -> local device -> host before the real cross-process
            # put
            x = self._put(np.asarray(samples) if ilv
                          else np.asarray(samples, np.complex64))
        else:
            x = self._put(jnp.asarray(samples) if ilv
                          else jnp.asarray(samples, jnp.complex64))
        # row-aligned fast path: stat accumulate + quantize + append in ONE
        # fused dispatch (ingest_c/ingest_p) when the chunk drops cleanly
        # into the current window.  Not taken before AGC priming (the first
        # feed must adopt the measured step BEFORE quantizing anything) or
        # with a sub-row carry pending.  Emits exactly what the general
        # loop would (tests/test_locked_stream.py pins equivalence).
        n = x.shape[1]
        if (self._pend is None and n and n % self.sps == 0
                and n <= self.window - self._count and self._agc_primed):
            ing = self._ingest_p if ilv else self._ingest_c
            self._buf, self._stat_ss, self._stat_max = ing(
                self._buf, self._count // self.sps, x, self._scale,
                self._stat_ss, self._stat_max)
            if self._agc:
                self._stat_cnt += 2 * n
            self._count += n
            if self._count >= self.window:
                out = self._process()
                out.extend(self._eager_poll())
                return out
            return self._eager_poll()
        if self._pend is not None:
            # sub-row carry from the previous feed: unify in the pairs
            # domain (rare — only non-40-aligned feeds reach here)
            if not ilv:
                x, ilv = self._pairs_c(x), True
            elif x.dtype != self._pend.dtype:
                x = x.astype(self._pend.dtype)
            x = jnp.concatenate([self._pend, x], axis=1)
            self._pend = None
        if self._agc and x.shape[1]:
            # accumulate per-channel level stats on device (the sub-row
            # tail is counted on the feed it arrives — the <40-sample
            # re-count when it is prepended above is noise at AGC scale)
            acc = self._stat_p if ilv else self._stat_c
            self._stat_ss, self._stat_max = acc(self._stat_ss,
                                                self._stat_max, x)
            self._stat_cnt += 2 * x.shape[1]
            if not self._agc_primed:
                # first feed: adopt the measured step BEFORE quantizing
                # anything (one synchronous tiny fetch at stream start) —
                # a deep-low-SNR or weak stream must not write its first
                # window at the wrong step
                self._agc_primed = True
                self._agc_update(force=True)
        append = self._append if ilv else self._append_c
        out = []
        off = 0
        n = x.shape[1]
        while off < n:
            room = self.window - self._count        # always row-aligned
            take = min(room, n - off)
            if take < room:
                take -= take % self.sps             # sub-row tail pends
            if take:
                self._buf = append(self._buf, self._count // self.sps,
                                   x[:, off:off + take], self._scale)
                self._count += take
                off += take
            if self._count >= self.window:
                out.extend(self._process())
            elif take == 0:
                break
        if off < n:
            tail = x[:, off:] if ilv else self._pairs_c(x[:, off:])
            self._pend = tail.astype(self._wire)
        out.extend(self._eager_poll())
        return out

    # -- external fused ingest ----------------------------------------- #
    # A host driver that produces the engine's input ON DEVICE (e.g. the
    # wideband channelizer) can fuse its own preprocessing with the
    # engine's stat+quantize+append into ONE jitted program instead of
    # dispatching them separately: one dispatch per quantum instead of
    # three (tools/wideband_bench.py --quantum-frames).

    def ingest_kernel(self):
        """The pure (buf, row, x, scale, ss, mx) -> (buf, ss, mx) closure
        combining AGC stat accumulation, quantization, and the row append
        for a (C, t) complex chunk — for composition inside a caller's own
        jit.

        Mesh engines: the closure operates on PER-SHARD LOCAL shapes
        (C/nch channels), exactly like the engine's own shard_mapped
        programs — compose it inside your own jax.shard_map over the
        engine's mesh with the specs from ingest_specs(), producing the
        x chunk's local channels in the body (the wideband receiver's
        'ch'-sharded DFT-kernel channelizer does this,
        stream/wideband.py)."""
        return self._ingest_c_fn

    def ingest_specs(self):
        """(in_specs, out_specs) PartitionSpec tuples for shard_mapping
        ingest_kernel over the engine's mesh: buffer sharded on 'ch',
        per-channel scale/stat vectors on 'ch', the row index replicated.
        The x chunk spec is for a (C, t) complex chunk sharded on 'ch' —
        callers synthesizing x INSIDE their shard_map body (fused
        preprocessing) simply drop that entry."""
        from jax.sharding import PartitionSpec as P
        BUF, CH = P("ch", None, None), P("ch")
        return (BUF, P(), P("ch", None), CH, CH, CH), (BUF, CH, CH)

    def ingest_state(self):
        """(buf, row, scale, ss, mx) operands for ingest_kernel, matching
        the engine's current stream position."""
        return (self._buf, self._count // self.sps, self._scale,
                self._stat_ss, self._stat_max)

    def external_ingest_ready(self, n: int) -> bool:
        """True when an ingest_kernel run of n samples/channel can be
        committed as-is: no sub-row carry pending, row-aligned, fits the
        current window, and AGC already primed (the first feed must adopt
        the measured quantization step BEFORE anything is quantized —
        route it through feed())."""
        return (self._pend is None and n > 0 and n % self.sps == 0
                and n <= self.window - self._count and self._agc_primed)

    def commit_external_ingest(self, buf, ss, mx, n: int):
        """Adopt ingest_kernel outputs and advance the stream; returns the
        decoded-frame tuples for any window the commit completed.  Caller
        must have checked external_ingest_ready(n) BEFORE running the
        kernel (the kernel donates the engine buffer)."""
        self._buf, self._stat_ss, self._stat_max = buf, ss, mx
        if self._agc:
            self._stat_cnt += 2 * n
        self._count += n
        if self._count >= self.window:
            out = self._process()
            out.extend(self._eager_poll())
            return out
        return self._eager_poll()

    def flush(self):
        """Process the buffered tail (zero-padded); frames whose payload
        would extend into the padding are rejected, not emitted corrupt.
        Pipeline mode first drains the in-flight block (its results precede
        the tail's)."""
        jnp = self._jnp
        drained = self._resolve_pending() if self.pipeline else []
        if self._pend is not None:       # zero-pad the sub-row carry in
            p = self._pend.shape[1]
            row = jnp.pad(self._pend,    # wire scale; _append quantizes
                          ((0, 0), (0, self.sps - p), (0, 0)))
            self._buf = self._append(self._buf, self._count // self.sps,
                                     row, self._scale)
            self._count += p
            self._pend = None
        min_n = self.spf + CONFIG.samples_per_symbol
        if self._count < min_n:
            results = []
        else:
            results = self._process(valid_limit=self._count)
        self._abs_base += self._count
        self._count = 0
        self._buf = self._zeros()
        return drained + results

    # ------------------------------------------------------------------ #

    def _process(self, valid_limit: int | None = None, eager: bool = False):
        if self.pipeline and valid_limit is None:
            return self._process_pipelined()
        out, wrap, p0w, tag = self._run_block(self._buf)
        results = self._resolve_block(out, self._buf, valid_limit, wrap,
                                      p0w, tag, self._abs_base,
                                      own_end=self.advance if eager
                                      else None)
        if valid_limit is None or eager:
            self._advance_window()
        return results

    def _eager_poll(self):
        """Eager mode: process pure-steady blocks as soon as their owned
        slots' samples are buffered (see __init__ eager docstring).  Called
        after feeds/commits; returns any frames emitted early."""
        out = []
        while (self._eager and self._count < self.window
               and self._agc_primed and self.locked.size
               and self.locked.all() and (self.miss == 0).all()
               and not self.refresh.any()):
            need = int(self.p0.max()) + self.advance + self.sps
            need = -(-need // self.sps) * self.sps        # row-aligned
            if self._count < need:
                break
            out.extend(self._process(valid_limit=self._count, eager=True))
        return out

    def _run_block(self, buf):
        """Retime (if flagged) and launch this window's program with the
        CURRENT host state.  Returns (out_dev, wrap, p0_wrapped, tag);
        mutates p0/refresh bookkeeping, not the lock lifecycle."""
        jnp = self._jnp
        # timing refresh: micro-adjust p0 for flagged locked channels from
        # the dense sync correlation around the next expected sync.  Lock
        # state is untouched — a genuinely faded signal yields delta 0 and
        # the normal flywheel semantics apply.
        put = self._put_state
        wrap = np.zeros(self.channels, bool)
        p0_wrapped = self.p0
        retune = self.refresh & self.locked
        if retune.any():
            out_rt = self._retime(buf, put("p0", self.p0),
                                  put("foff", self.freq_offset),
                                  self._scale)
            # ONE batched fetch (three serial np.asarray = three waits)
            delta, frac_new, fold = self._get(out_rt)
            delta = np.where(retune, delta, 0).astype(np.int32)
            # energy gate: the retime window is anchored one frame AHEAD
            # of p0, so at a burst tail (or in a deep fade) it folds
            # silence — a near-zero-energy fold vs the channel's
            # accumulated per-window average is garbage whose edge-pegged
            # argmax would walk the grid off the final frame.  Skip the
            # retime entirely for such channels.
            with np.errstate(invalid="ignore", divide="ignore"):
                avg = self._fold_acc.sum(axis=1) \
                    / np.maximum(self._fold_w, 1e-9)
            weak = (self._fold_ok & (self._fold_w > 0)
                    & (fold.sum(axis=1) < 0.3 * avg))
            retune = retune & ~weak
            # trust-region (see _TIMING_TRUST/_FOLD_DECAY): a drift-sized
            # jump needs sign-consistent CONFIRMATION by the next retime
            # before the fresh single-window estimate is adopted (real
            # clock drift is persistent block to block; a waterfall-SNR
            # single-window fold argmax outlier is not — adopting outliers
            # yanked the grid +-5..9 samples and cost ~2x BER at 8 dB);
            # noise-regime folds accumulate and the grid re-estimates from
            # the DEEP average
            cur = self.p0.astype(np.float64) + self.frac
            est_one = (self.p0 + delta).astype(np.float64) + frac_new
            dev = est_one - cur
            big = np.abs(dev) > self._TIMING_TRUST
            sgn = np.sign(dev).astype(np.int8)
            half = self.sps // 2
            est_acc0 = (self.p0 - half).astype(np.float64) \
                + self._fold_est_np(self._fold_acc)
            # a DEEP accumulator outvotes a sign-confirmed big jump unless
            # the deep estimate leans the same way (real drift drags the
            # accumulated apex along; two same-sign waterfall argmax
            # outliers do not).  "Leans" means MAGNITUDE, not just sign:
            # with no drift, est_acc - cur is ~0 +- estimator noise and
            # its sign is a coin flip, so a sign-only veto let ~half of
            # the noise double-outliers through — measured at 7 dB bf=12
            # (seed-44 trace): an adoption at w=6 reseeded the deep
            # accumulator and yanked the grid 5 samples off truth for
            # several blocks.  Real drift strong enough to produce two
            # consecutive TRUST-sized jumps drags the accumulated apex
            # well past half a trust radius by the confirmation block.
            deep = self._fold_ok & (self._fold_w >= self._FOLD_DEEP)
            agree = ((np.sign(est_acc0 - cur).astype(np.int8) == sgn)
                     & (np.abs(est_acc0 - cur) > 0.5 * self._TIMING_TRUST))
            adopt = retune & big & (sgn == self._big_dir) & (~deep | agree)
            hold = retune & big & ~adopt
            self._big_dir[hold] = sgn[hold]
            self._big_dir[retune & ~big] = 0
            # fold accumulation: adoption re-seeds (the old accumulation
            # belongs to the rejected grid); held and noise-regime folds
            # both accumulate — the fold is the sufficient statistic, one
            # window's argmax outlier does not corrupt it
            seed = adopt | (retune & ~self._fold_ok)
            accum = retune & ~seed
            self._fold_acc[seed] = fold[seed]
            self._fold_w[seed] = 1.0
            # grow-into-EMA accumulation: uniform running sum (decay 1)
            # until the weight reaches the EMA's steady-state depth
            # 1/(1-D), then the fixed-decay EMA.  A fixed decay from the
            # start down-weights the early windows while the estimate is
            # still converging, so the applied grid keeps chasing
            # single-window estimator noise — measured at the 7 dB
            # waterfall (5x200-frame captures, bf=4): steady-tail BER
            # 4.55e-2 fixed-decay vs 4.21e-2 with the grid pinned to the
            # batch estimate (the whole streaming-vs-batch steady gap was
            # this wobble); the hybrid recovers most of it.  Finite
            # memory (the EMA cap) is kept so ppm-scale drift can still
            # drag the accumulated apex (test_locked_stream drift tests).
            d_eff = np.where(
                self._fold_w < 1.0 / (1.0 - self._FOLD_DECAY) - 1.0,
                1.0, self._FOLD_DECAY)
            self._fold_acc[accum] = (d_eff[accum, None]
                                     * self._fold_acc[accum] + fold[accum])
            self._fold_w[accum] = d_eff[accum] * self._fold_w[accum] + 1
            self._fold_ok |= retune
            est_acc = (self.p0 - half).astype(np.float64) \
                + self._fold_est_np(self._fold_acc)
            est = np.where(adopt, est_one, est_acc)
            # a held channel with a shallow accumulator takes a CLIPPED
            # step toward the fresh estimate: under real drift (error
            # growing ~5 samples/block) this keeps the grid inside the
            # decode-safe zone until the next retime confirms, while a
            # noise outlier costs at most TRUST samples for one block;
            # deep channels follow the deep estimate regardless
            step = cur + np.clip(dev, -self._TIMING_TRUST,
                                 self._TIMING_TRUST)
            est = np.where(hold & ~deep, step, est)
            blend = np.where(retune, est, cur)
            p0n = np.floor(blend).astype(np.int32)
            frac_n = (blend - p0n).astype(np.float32)
            # p0n < 0: the drifted grid steps back across the window start.
            # The straddling frame is still FULLY inside this window (the
            # overlap is one frame + slack), but its slot on the old grid is
            # p0 + bf*spf >= advance — normally next block's property.  So:
            # process this block on the OLD grid with ONE extra slot and
            # extended ownership (own_extra), then advance the corrected
            # grid one frame for the next block.  Zero frames lost or
            # doubled across the wrap.
            wrap = p0n < 0
            moved = retune & (p0n != self.p0)
            # keep the accumulator aligned with the adopted grid: bin b of
            # _fold_acc maps to offset p0 - 20 + b, so a p0 move by d
            # shifts the apex by -d bins (wraps re-anchor next refresh)
            for c in np.flatnonzero(moved):
                if wrap[c]:
                    self._fold_ok[c] = False
                    continue
                d = int(p0n[c]) - int(self.p0[c])
                if abs(d) >= self._fold_acc.shape[1]:
                    self._fold_ok[c] = False
                else:
                    self._fold_acc[c] = np.roll(self._fold_acc[c], -d)
                    if d > 0:
                        self._fold_acc[c, -d:] = 0.0
                    elif d < 0:
                        self._fold_acc[c, :-d] = 0.0
            self.p0 = np.where(wrap, self.p0, p0n).astype(np.int32)
            p0_wrapped = np.where(wrap, p0n + self.spf, self.p0).astype(np.int32)
            self.refreshes += int(moved.sum())
            self.metric_ema[moved] = np.nan  # fresh grid -> fresh baseline
            # the folded retime re-estimates sub-sample timing alongside
            # the integer delta: adopt the blended frac for every retuned
            # non-wrap channel (a wrap processes THIS block on the old
            # grid, so the old frac still applies; the next refresh
            # re-estimates)
            adopt = retune & ~wrap
            self.frac = np.where(adopt, frac_n,
                                 self.frac).astype(np.float32)
        self.refresh[:] = False

        if self.locked.all():
            run = self._steady_x if wrap.any() else self._steady
            out = run(buf, put("p0", self.p0),
                      put("foff", self.freq_offset), self._scale,
                      put("frac", self.frac))
            tag = "steady"
        else:
            # mixed lock states never use the extra-slot program; a wrap
            # coinciding with another channel's re-acquisition forfeits the
            # straddler (rare corner; the grid still corrects)
            out = self._reacquire(buf, put("p0", self.p0),
                                  put("foff", self.freq_offset),
                                  put("keep", self.locked), self._scale,
                                  put("frac", self.frac))
            tag = "reacquire"
        return out, wrap, p0_wrapped, tag

    def _resolve_block(self, out, buf, valid_limit, wrap, p0_wrapped, tag,
                       base, own_end=None):
        """Fetch one block's results and run the host sync lifecycle.
        own_end: block-ownership end override (eager partial-window blocks
        own the normal advance span while valid_limit marks the filled
        extent)."""
        jnp = self._jnp
        t_res = time.monotonic() if self.timing else None
        self._fetch_ms = 0.0
        if tag == "reacquire":
            self.reacquisitions += 1
        self._want_refresh[:] = False
        prev_locked = self.locked.copy()
        results = self._emit(out, valid_limit, own_extra=wrap, base=base,
                             own_end=own_end)
        self.p0 = np.where(wrap, p0_wrapped, self.p0).astype(np.int32)

        # A channel that dropped lock during this block (miss limit exceeded)
        # must be re-hunted over THIS window, not the next one: the reference
        # transitions LOCKED -> HUNTING at the drop sample and scans on
        # (src/opv-demod.cpp:695-713), so a burst starting later in the same
        # window keeps its first frame.  One extra reacquire dispatch, only
        # on lock-drop blocks.
        dropped = prev_locked & ~self.locked
        if dropped.any():
            self.reacquisitions += 1
            out2 = self._reacquire(buf, self._put_state("p0", self.p0),
                                   self._put_state("foff", self.freq_offset),
                                   self._put_state("keep", ~dropped),
                                   self._scale,
                                   self._put_state("frac", self.frac))
            results.extend(self._emit(out2, valid_limit, only=dropped,
                                      min_pos=self._dropped_at, base=base,
                                      own_end=own_end))
        warm = max(4.0, self._FOLD_WARM_FOLDS / self.block_frames)
        with np.errstate(invalid="ignore"):
            warming = ((self._fold_w < warm)
                       & (self.metric_ema > self._WARM_METRIC_MIN))
        # miss > 0 (flywheel riding at block end — burst tail or fade):
        # the window's trailing frame intervals hold no signal, so a
        # retime fold over them is garbage that can walk the grid off a
        # finished burst (test_reacquire_within_drop_block's +4 slip)
        self.refresh = ((self._want_refresh | warming)
                        & self.locked & (self.miss == 0))
        # the fold accumulator is anchored to a LOCKED channel's stable
        # grid: any lock transition (drop, re-hunt, fresh lock on a new
        # burst) re-anchors p0, so the carried fold no longer aligns
        stable = self.locked & prev_locked
        self._fold_ok &= stable
        self._fold_w[~stable] = 0.0
        self._big_dir[~stable] = 0
        self._blocks += 1
        # AGC cadence — plus every lock-TRANSITION block: lock loss often
        # IS a level change (burst onset on a quiet channel, fade), and the
        # re-hunt only succeeds once the window is quantized at the new
        # step.  Triggering on the transition (not the unlocked STATE)
        # matters for sparse deployments: a 64-channel bank with idle
        # channels is permanently part-unlocked, and the stats fetch is a
        # blocking round trip — per-block it dominated the wideband host
        # budget on the first accelerator.  Idle channels still
        # re-evaluate at the _AGC_BLOCKS cadence.
        if self._agc and (self._blocks % self._AGC_BLOCKS == 0
                          or dropped.any()
                          or (~prev_locked & self.locked).any()):
            self._agc_update()
        if t_res is not None:
            total_ms = (time.monotonic() - t_res) * 1e3
            self.block_stats.append(dict(
                tag=tag,
                device_wait_ms=round(self._fetch_ms, 3),
                host_ms=round(total_ms - self._fetch_ms, 3)))
        return results

    def _put_state(self, name, arr):
        """Device copy of a small host lock-state vector, content-cached.

        Steady streaming re-sends identical p0/freq_offset/frac arrays
        every block; the cache skips those host->device puts.  It is keyed
        on the value bytes, so in-place host mutations (lock lifecycle
        updates) naturally refresh the device copy."""
        key = arr.tobytes()
        ent = self._state_cache.get(name)
        if ent is not None and ent[0] == key:
            return ent[1]
        dev = self._put(arr)
        self._state_cache[name] = (key, dev)
        return dev

    def _advance_window(self, keep_buf: bool = False):
        slide = self._slide_copy if keep_buf else self._slide
        self._buf = slide(self._buf)
        self._count -= self.advance
        self._abs_base += self.advance
        # grid positions repeat every frame, so after advancing by an
        # exact frame multiple the equivalent sync position in the new
        # window is p0 mod 86,720 (valid while the transmission is
        # continuous — exactly the locked-mode assumption; a gap breaks
        # sync_q and triggers re-acquisition anyway)
        self.p0 = self.p0 % self.spf

    def _agc_update(self, force: bool = False):
        """Re-evaluate the int8 quantization step from the accumulated
        feed-level statistics (one tiny fetch); adopt per channel where the
        desired step moved outside the hysteresis band, re-quantizing the
        buffered window so past and future rows share one step.  force=True
        (first feed) adopts any change — the initial window must be written
        at the measured step, not the wire-full-scale default."""
        if not self._agc or self._stat_cnt == 0:
            return
        # use the stat values piggybacked on the last block-result fetch
        # when still current (no feed since); else ONE batched fetch for
        # both vectors (two serial np.asarray calls are two round trips)
        cache = getattr(self, "_agc_fetch", None)
        if cache is not None and cache[2] == self._stat_cnt:
            ss, mx = cache[0], cache[1]
        else:
            ss, mx = self._get((self._stat_ss, self._stat_max))
        self._agc_fetch = None
        rms = np.sqrt(ss / self._stat_cnt)
        desired = np.minimum(mx, self._AGC_SIGMA * rms) * (1.0 / 127.0)
        desired = np.maximum(desired, 1e-6).astype(np.float32)  # silence
        ratio = desired / self._scale_np
        adopt = (ratio > self._AGC_BAND) | (ratio < 1.0 / self._AGC_BAND)
        if force:
            adopt = adopt | (ratio != 1.0)
        if adopt.any():
            new = np.where(adopt, desired, self._scale_np).astype(np.float32)
            if self._count:              # re-quantize the buffered window
                factor = (self._scale_np / new).astype(np.float32)
                self._buf = self._requant(self._buf, self._put(factor))
            self._scale_np = new
            self._scale = self._put(new)
        self._stat_ss = self._put(np.zeros(self.channels, np.float32))
        self._stat_max = self._put(np.zeros(self.channels, np.float32))
        self._stat_cnt = 0

    def _process_pipelined(self):
        """One full window in pipeline mode: launch this block with the
        last-resolved state (predicted), then resolve the PREVIOUS block —
        its fetch overlaps this block's device compute.  A misprediction
        (lock change or pending timing refresh) relaunches this block on
        its retained window with the corrected state, so emitted tuples
        are identical to the synchronous driver's."""
        jnp = self._jnp
        if self._pending is None:
            # first window: host state is exact, launch directly
            out, wrap, p0w, tag = self._run_block(self._buf)
            self._pending = dict(out=out, buf=self._buf, wrap=wrap, p0w=p0w,
                                 tag=tag, base=self._abs_base)
            self._advance_window(keep_buf=True)
            return []

        prev = self._pending
        pred_locked = self.locked.copy()
        retune_pred = self.refresh & self.locked
        launched = None
        if not retune_pred.any():
            # optimistic launch: p0/freq_offset chain device-to-device from
            # the unfetched previous outputs (wrap blocks override the
            # wrapped channels' grid with the host-computed p0_wrapped)
            p0_dev = prev["out"]["p0"]
            if prev["wrap"].any():
                p0_dev = jnp.where(self._put(prev["wrap"]),
                                   self._put(prev["p0w"]), p0_dev)
            p0_dev = p0_dev % self.spf
            foff_dev = prev["out"]["freq_offset"]
            frac_dev = prev["out"]["frac"]
            if pred_locked.all():
                o = self._steady(self._buf, p0_dev, foff_dev, self._scale,
                                 frac_dev)
                launched = (o, np.zeros(self.channels, bool), self.p0,
                            "steady")
            else:
                o = self._reacquire(self._buf, p0_dev, foff_dev,
                                    self._put(pred_locked), self._scale,
                                    frac_dev)
                launched = (o, np.zeros(self.channels, bool), self.p0,
                            "reacquire")
        # resolve the previous block (fetch overlaps the launched compute)
        results = self._resolve_block(prev["out"], prev["buf"], None,
                                      prev["wrap"], prev["p0w"], prev["tag"],
                                      prev["base"])
        self.p0 = self.p0 % self.spf     # previous->current window coords
        retune_actual = self.refresh & self.locked
        if (launched is None or retune_actual.any()
                or not np.array_equal(self.locked, pred_locked)):
            # prediction invalid: relaunch this window with exact state
            launched = self._run_block(self._buf)
        out, wrap, p0w, tag = launched
        self._pending = dict(out=out, buf=self._buf, wrap=wrap, p0w=p0w,
                             tag=tag, base=self._abs_base)
        self._advance_window(keep_buf=True)
        return results

    def _resolve_pending(self):
        """Drain the in-flight block (pipeline mode): resolve it and return
        its tuples.  Afterwards the host state matches the synchronous
        driver's exactly."""
        if self._pending is None:
            return []
        prev, self._pending = self._pending, None
        results = self._resolve_block(prev["out"], prev["buf"], None,
                                      prev["wrap"], prev["p0w"], prev["tag"],
                                      prev["base"])
        self.p0 = self.p0 % self.spf
        return results

    def _emit(self, out, valid_limit, only=None, min_pos=None,
              own_extra=None, base=None, own_end=None):
        """Run the host-side sync lifecycle over one block result.

        only: bool (C,) — process just these channels (re-hunt second pass).
        min_pos: int (C,) — reject frames before this window position (the
        grid slot where lock was dropped: everything earlier was already
        emitted or belongs to the dead burst, matching the reference which
        hunts forward from the drop sample only).
        own_extra: bool (C,) — extend this channel's block ownership by one
        frame (drift-wrap straddler, see _process).
        base: absolute stream index of this block's window start (defaults
        to the live buffer's; pipeline mode resolves a block after the
        window has already advanced, so it passes the block's own base)."""
        if base is None:
            base = self._abs_base
        t_fetch = time.monotonic() if self.timing else None
        # ONE batched fetch for the whole result pytree: device_get issues
        # copy_to_host_async on every leaf before gathering, so the seven
        # arrays cross the link concurrently instead of as seven serial
        # round trips.  The tiny AGC stat vectors PIGGYBACK on the same
        # fetch: lock-transition blocks trigger an AGC re-evaluation
        # (sparse/bursty banks transition every block), and a separate
        # stat fetch there was one more blocking round trip per block
        if self._agc:
            out, ss_h, mx_h = self._get((out, self._stat_ss,
                                         self._stat_max))
            self._agc_fetch = (ss_h, mx_h, self._stat_cnt)
        else:
            out = self._get(out)
        if t_fetch is not None:
            self._fetch_ms += (time.monotonic() - t_fetch) * 1e3
        burst_only = out.get("burst_only")   # reacquire blocks only
        q = out["sync_q"]
        raw = out["sync_raw"]
        ok = out["decode_ok"]
        metrics = out["metrics"]
        frames = out["frames"]
        p0 = out["p0"]
        foff = out["freq_offset"]
        frac = out["frac"]
        chans = range(self.channels) if only is None else np.flatnonzero(only)
        self._dropped_at = np.zeros(self.channels, np.int64)
        for c in chans:
            self.p0[c] = p0[c]
            self.freq_offset[c] = foff[c]
            self.frac[c] = frac[c]

        vlim = self.window if valid_limit is None else valid_limit
        # a frame is OWNED by this block only if its sync starts before the
        # slide amount — a hunt can lock deep in the window's overlap tail,
        # and those grid slots reappear (at pos % spf) in the next block:
        # processing them twice would double-emit and double-count misses.
        # (eager blocks pass own_end=advance explicitly: they own the
        # normal span while vlim marks the partially-filled extent)
        if own_end is None:
            own_end = self.advance if valid_limit is None else vlim
        extent = self.spf + CONFIG.samples_per_symbol  # sync..payload end
        results = []
        n_slots = frames.shape[1]
        for c in chans:
            own_c = own_end
            if own_extra is not None and own_extra[c]:
                own_c = own_end + self.spf
            for k in range(n_slots):
                pos = int(self.p0[c]) + k * self.spf
                if pos >= own_c or pos + extent > vlim:
                    continue           # next block's slot / incomplete tail
                if min_pos is not None and pos < min_pos[c]:
                    continue           # precedes this channel's lock drop
                emit = False
                if self.locked[c]:
                    # LOCKED re-check (src/opv-demod.cpp:695-713)
                    if q[c, k] >= CONFIG.sync_locked_norm_thresh:
                        self.miss[c] = 0
                        emit = True
                        m = int(metrics[c, k])
                        ema = self.metric_ema[c]
                        if not np.isfinite(ema):
                            self.metric_ema[c] = m
                        else:
                            if (q[c, k] < self.REFRESH_Q
                                    or (m > ema + self.REFRESH_METRIC_RISE
                                        and m > self.REFRESH_METRIC_MIN)):
                                self._want_refresh[c] = True
                            self.metric_ema[c] = ((1 - self._EMA_ALPHA) * ema
                                                  + self._EMA_ALPHA * m)
                    elif self.miss[c] < CONFIG.sync_miss_limit:
                        self.miss[c] += 1      # flywheel frame
                        emit = True
                    else:
                        self.locked[c] = False
                        self.miss[c] = 0
                        self._dropped_at[c] = pos
                else:
                    # HUNTING thresholds (src/opv-demod.cpp:783-786)
                    if (q[c, k] >= CONFIG.sync_hunt_norm_thresh
                            and raw[c, k] >= CONFIG.sync_hunt_raw_thresh):
                        if burst_only is not None and burst_only[c]:
                            # isolated single-frame burst: the hunt's next-
                            # frame verification found no second sync, so
                            # emit the frame (the reference's VERIFYING
                            # state emits it too, opv-demod.cpp:657-680)
                            # but DON'T lock — there is nothing to track,
                            # and a lock here would ride the flywheel
                            # through sync_miss_limit garbage slots
                            emit = self._burst_salvage
                        else:
                            self.locked[c] = True
                            self.miss[c] = 0
                            emit = True
                if emit and ok[c, k]:
                    self.decoded += 1
                    if metrics[c, k] == 0:
                        self.perfect += 1
                    results.append((c, bytes(frames[c, k]),
                                    int(metrics[c, k]), float(q[c, k]),
                                    base + pos))
        return results


    def stats(self) -> dict:
        """Aggregate the per-block timing records (timing=True): block
        counts by program tag, device-wait vs host-lifecycle ms split
        (mean/max), plus the driver's lifecycle counters — the per-stage
        observability SURVEY.md section 5 asks for."""
        out = dict(decoded=self.decoded, perfect=self.perfect,
                   reacquisitions=self.reacquisitions,
                   refreshes=self.refreshes)
        if not self.block_stats:
            return out
        tags: dict = {}
        for b in self.block_stats:
            tags[b["tag"]] = tags.get(b["tag"], 0) + 1
        dw = [b["device_wait_ms"] for b in self.block_stats]
        hm = [b["host_ms"] for b in self.block_stats]
        out.update(
            blocks=len(dw), blocks_by_program=tags,
            device_wait_ms_mean=round(sum(dw) / len(dw), 3),
            device_wait_ms_max=round(max(dw), 3),
            host_ms_mean=round(sum(hm) / len(hm), 3),
            host_ms_max=round(max(hm), 3))
        return out

    # ------------------------------------------------------------------ #
    # checkpoint/resume (stream/state.py)

    def state_tree(self):
        if self._pending is not None:
            raise RuntimeError(
                "pipelined stream has a block in flight; checkpoint at a "
                "flush boundary (call flush() first) or use the synchronous "
                "driver for checkpointed streams")
        # pend is stored zero-padded to one full row + its true length so
        # the pytree structure (leaf shapes) is feed-history independent;
        # it lives at WIRE scale (float32 for int8 buffers)
        pend = self._jnp.zeros((self.channels, self.sps, 2), self._wire)
        pend_len = 0
        if self._pend is not None:
            pend_len = self._pend.shape[1]
            pend = self._jnp.pad(self._pend.astype(self._wire),
                                 ((0, 0), (0, self.sps - pend_len), (0, 0)))
        return dict(
            buf=self._buf, count=np.int64(self._count),
            pend=pend, pend_len=np.int64(pend_len),
            abs_base=np.int64(self._abs_base),
            p0=self.p0, frac=self.frac.copy(),
            freq_offset=self.freq_offset,
            locked=self.locked, miss=self.miss, refresh=self.refresh,
            metric_ema=self.metric_ema,
            fold_acc=self._fold_acc.copy(), fold_ok=self._fold_ok.copy(),
            fold_w=self._fold_w.copy(), big_dir=self._big_dir.copy(),
            scale=self._scale_np.copy(),
            decoded=np.int64(self.decoded), perfect=np.int64(self.perfect),
        )

    def load_state_tree(self, tree) -> None:
        """Adopt a state produced by state_tree() (e.g. via load_state).
        Accepts all three buffer layouts: (C, window/40, 80) window rows
        (current), (C, window, 2) IQ pairs, and (C, window) complex64
        (pre-wire-form checkpoints)."""
        jnp = self._jnp
        buf = jnp.asarray(tree["buf"])
        # the checkpoint's quantization step (per channel); pre-AGC
        # checkpoints carry no scale field — their int8 buffers are at the
        # fixed wire-full-scale step
        tree_scale = np.asarray(
            tree.get("scale", np.full(self.channels, self._int8_scale)),
            np.float32)
        if buf.ndim == 2:
            buf = jnp.stack([buf.real.astype(jnp.float32),
                             buf.imag.astype(jnp.float32)], -1)
        if buf.shape[-1] == 2:           # pairs -> window rows
            buf = buf.reshape(self.channels, -1, 2 * self.sps)
        # cross-dtype adoption: int8 buffers hold wire/scale values, float
        # buffers hold wire-scale values — rescale across the domains
        if buf.dtype == jnp.int8 and not self._int8:
            buf = buf.astype(jnp.float32) * jnp.asarray(tree_scale)[:, None,
                                                                    None]
        if self._int8:
            self._scale_np = tree_scale.copy()
            self._scale = self._put(self._scale_np)
        if self._int8 and buf.dtype != jnp.int8:
            # wire-scale floats -> quantized at the adopted step
            self._buf = self._conv(self._put(buf), self._scale)
        else:
            self._buf = self._put(buf.astype(self.dtype))
        count = int(tree["count"])
        self._pend = None
        rem = count % self.sps
        if rem:
            # pre-windowed checkpoints could hold a sub-row count; move the
            # partial row's samples to the pend carry (the next append
            # rewrites that row with pend + new data — identical values)
            pairs = self._buf.reshape(self.channels, -1, 2)
            self._pend = pairs[:, count - rem:count].astype(self._wire)
            if self._int8:               # buffer domain -> wire scale
                self._pend = self._pend * self._scale[:, None, None]
            count -= rem
        self._count = count
        if "pend" in tree and int(tree.get("pend_len", 0)):
            p = int(tree["pend_len"])
            assert self._pend is None    # aligned count when pend was saved
            self._pend = jnp.asarray(tree["pend"])[:, :p].astype(self._wire)
        self._abs_base = int(tree["abs_base"])
        self.p0 = np.asarray(tree["p0"], np.int32)
        self.frac = np.asarray(tree.get("frac",
                                        np.zeros(self.channels)), np.float32)
        self.freq_offset = np.asarray(tree["freq_offset"], np.float32)
        self.locked = np.asarray(tree["locked"], bool)
        self.miss = np.asarray(tree["miss"], np.int32)
        if "refresh" in tree:
            self.refresh = np.asarray(tree["refresh"], bool)
        if "metric_ema" in tree:
            self.metric_ema = np.asarray(tree["metric_ema"], np.float64)
        if "fold_acc" in tree:
            self._fold_acc = np.asarray(tree["fold_acc"], np.float64).copy()
            self._fold_ok = np.asarray(tree["fold_ok"], bool).copy()
        else:                            # pre-round-4 checkpoint: cold acc
            self._fold_acc[:] = 0.0
            self._fold_ok[:] = False
        if "big_dir" in tree:
            self._big_dir = np.asarray(tree["big_dir"], np.int8).copy()
        else:
            self._big_dir[:] = 0
        if "fold_w" in tree:
            self._fold_w = np.asarray(tree["fold_w"], np.float64).copy()
        else:
            self._fold_w[:] = 0.0
        self.decoded = int(tree["decoded"])
        self.perfect = int(tree["perfect"])
        # the restored scale is authoritative; don't re-prime off the next
        # feed chunk, and start its stats window fresh
        if self._agc:
            self._agc_primed = True
            self._stat_ss = self._put(np.zeros(self.channels, np.float32))
            self._stat_max = self._put(np.zeros(self.channels, np.float32))
            self._stat_cnt = 0
