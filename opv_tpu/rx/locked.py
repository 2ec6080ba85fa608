"""Locked-grid multichannel demodulator — the steady-state production path.

A continuous OPV transmission places one frame every 86,720 samples at a
fixed sample phase (locked clocks).  Exploiting that, the pipeline splits
into a cheap acquisition stage and a lean symbol-rate body:

  1. ACQUISITION (first frame interval only): dense tone correlation at
     every sample offset (40-tap convs) + dilated sync correlation -> the
     first sync position p0 per channel.  Cost: ~1 frame of dense work.
  2. BODY (whole block): because 86,720 % 40 == 0, every frame shares the
     timing phase r = p0 mod 40 — so the block is correlated only at the
     symbol grid: one (nsym, 40) x (40, 2) matmul per channel (40x less
     work than dense), after ONE per-channel dynamic_slice to phase-align.
  3. Payload extraction and per-frame sync quality are static strided
     reshapes/einsums off the symbol-rate soft stream.
  4. Batched Viterbi + frame finishing.

Everything is gather-free (no batched gathers / take_along_axis: the
compiler the engine was first built for could not lower them) and float32.
Use rx_fast for exploratory/bursty captures; rx_locked for continuous
streams + throughput.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG
from opv_tpu.rx.fast import dense_soft, dense_sync
from opv_tpu.rx.frame_decoder import decode_payloads
from opv_tpu.rx.sync import sync_pattern

_TWO_PI = 2.0 * math.pi
_SPS = CONFIG.samples_per_symbol
_SB = CONFIG.sync_bits
_EB = CONFIG.encoded_bits
_FS = CONFIG.frame_symbols

#: int8 stream-buffer quantization step: wire-format int16 samples
#: (amplitude 16383, opv-mod.cpp:271-272) map to +-127 exactly
#: (16383/129 = 127.0); AWGN excursions past full scale soft-clip.  The
#: soft stage rescales its integer matmul output by this, so downstream
#: absolute thresholds (sync raw >= 5000) see wire-scale values.
INT8_SCALE = 129.0

#: how many frame intervals the batch acquisition's timing refinement folds
#: (rx_locked).  Read at TRACE time — set before the first rx_locked call.
#: Measured at the 7 dB waterfall (200-frame interior capture): depth 33
#: folds can still argmax up to 7 samples off (BER 9.0e-2); 65 folds
#: 4.0e-2; 129 folds 3.7e-2 with the sub-sample estimate 0.02 samples from
#: truth — beating the reference's TED.  The refine pass
#: is one dense correlation over the folded span per BATCH acquisition
#: (streaming re-acquires fold over their own window and refresh via the
#: retime EMA instead), so deep folding costs nothing in steady state.
REFINE_FOLD_CAP = 128


def window_rows(samples: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """(C, N) complex wire-scale samples -> (C, N/40, 80) window rows of
    interleaved I/Q, the steady body's buffer layout (rx_locked_steady);
    int8 rows hold wire / INT8_SCALE, clipped to +-127."""
    p = jnp.stack([samples.real, samples.imag], axis=-1)
    if jnp.dtype(dtype) == jnp.int8:
        p = jnp.clip(jnp.round(p / INT8_SCALE), -127, 127)
    return p.astype(dtype).reshape(samples.shape[0], -1, 2 * _SPS)


def acquire_grid(raw: jnp.ndarray) -> jnp.ndarray:
    """(C, M) dense sync correlation -> (C,) sample index of the first sync.

    Earliest position within the first frame interval whose raw correlation
    reaches 90% of that interval's maximum (the first sync can be slightly
    weaker than later ones — e.g. the modulator's silent first symbol after
    reset — so a plain argmax would lock onto frame 2), refined to the true
    peak within one symbol.  argmax of a boolean returns the first True:
    gather-free."""
    window = raw[:, : _FS * _SPS]
    wmax = window.max(axis=-1, keepdims=True)
    cand = window >= 0.9 * wmax
    first = jnp.argmax(cand, axis=-1).astype(jnp.int32)[:, None]
    idx = jnp.arange(window.shape[-1], dtype=jnp.int32)[None, :]
    near = (idx >= first) & (idx < first + _SPS)
    return jnp.argmax(jnp.where(near, window, -jnp.inf), axis=-1).astype(jnp.int32)


def hunt_grid(raw: jnp.ndarray, norm: jnp.ndarray, stride: int = 1):
    """Earliest VERIFIED sync position over the WHOLE dense range.

    The reference's HUNTING state scans every symbol and locks at the first
    position meeting BOTH thresholds (norm >= 0.85 AND raw >= 5000,
    src/opv-demod.cpp:783-786); this is the batched equivalent for
    re-acquisition, so a burst starting anywhere inside the block is found
    immediately instead of waiting to drift into the first frame interval.

    Deliberate improvement over parity: the reference's VERIFYING state
    emits the candidate frame unconditionally (src/opv-demod.cpp:657-680),
    so a single noise spike can false-lock it off the real grid, costing up
    to sync_miss_limit real frames until the flywheel drops.  Here a
    candidate only qualifies as VERIFIED if the NEXT frame's sync (one
    frame interval later) also re-checks at the locked threshold — noise
    cannot produce two aligned syncs, so the earliest verified candidate IS
    the burst.  The earliest UNVERIFIED candidate is returned alongside so
    streaming drivers can still salvage an isolated single-frame burst
    (the reference decodes those, opv-demod.cpp:657-680) by emitting its
    frame WITHOUT taking the lock — reference semantics minus the
    false-lock flywheel cost (stream/locked.py single_frame_burst).

    Returns ((C,) p0, (C,) found, (C,) p0_unverified, (C,) found_u) with
    p0 in SAMPLE units regardless of stride (raw/norm from
    dense_soft/dense_sync at the same stride: position u <-> sample
    stride*u).  Where a found mask is False, the matching p0 is
    meaningless (callers keep their previous state; sync-quality gates
    reject frames).
    """
    cand_u = (norm >= CONFIG.sync_hunt_norm_thresh) & \
             (raw >= CONFIG.sync_hunt_raw_thresh)
    # next-frame re-check, shifted gather-free: pad right then slice
    recheck = norm >= CONFIG.sync_locked_norm_thresh
    spf_u = _FS * _SPS // stride
    nxt = jnp.pad(recheck, ((0, 0), (0, spf_u)))[:, spf_u:]
    cand = cand_u & nxt
    idx = jnp.arange(raw.shape[-1], dtype=jnp.int32)[None, :]
    sym_u, half_u = _SPS // stride, _SPS // (2 * stride)

    def first_peak(c):
        found = c.any(axis=-1)
        first = jnp.argmax(c, axis=-1).astype(jnp.int32)[:, None]
        # the normalized metric saturates over a plateau; refine to the raw
        # peak within one symbol CENTERED on the first qualifying position.
        # The half-symbol backward reach matters for drift refreshes
        # (stream/locked.py): a grid that slipped backward by < half a
        # symbol still qualifies at the stale position, and a forward-only
        # window would return the stale p0 unchanged.
        near = (idx >= first - half_u) & (idx < first + sym_u - half_u)
        p0 = jnp.argmax(jnp.where(near, raw, -jnp.inf),
                        axis=-1).astype(jnp.int32)
        return p0 * stride, found

    p0, found = first_peak(cand)
    p0_u, found_u = first_peak(cand_u)
    return p0, found, p0_u, found_u


def _symbol_soft_batch(samples: jnp.ndarray, r: jnp.ndarray, freq_offset,
                       nsym: int, scale=None, frac=None) -> jnp.ndarray:
    """Symbol-grid tone correlation at per-channel phase r — NO dynamic
    slicing at all.

    The phase-aligned window for symbol s spans the tail of static block s
    and the head of static block s+1 (blocks = a free contiguous reshape of
    the sample stream into (C, nsym+1, 40)).  Splitting the correlation sum
    at the phase boundary:

        corr(s) = e^{j*inc*r} * (A(s) + e^{-40j*inc} * B(s+1))

    where A/B are tone correlations of each static block masked at t >= r /
    t < r.  The leading per-channel phase drops inside |corr|^2, so the
    whole stage is ONE batched matmul + an elementwise combine.

    The matmul is REAL-VALUED: a complex64 einsum here lowers to several
    real matmuls over extracted re/im planes (extra full passes over the
    samples).  Window s becomes 80 floats (re0 im0 re1 im1 ...),
    and the complex correlation is ONE (C, ns+1, 80) x (C, 80, 8) f32
    matmul whose kernel rows interleave (k_re, -k_im) for out_re and
    (k_im, k_re) for out_im.

    `samples` is one of
      * (C, N) complex — re-interleaved here, one fused elementwise pass;
      * (C, N, 2) float32/bfloat16 IQ pairs — the wire format, reshaped
        into windows;
      * (C, M, 80) float32/bfloat16 WINDOW ROWS (row s = samples
        [40s, 40s+40) as 80 interleaved I/Q values) — the zero-copy
        production form: the streaming buffer stores this shape directly
        (stream/locked.py), so the matmul reads it with no relayout at
        all.
    bf16 buffers halve the stage's read; int16-scale samples quantize at
    <=0.4% (FEC/sync margins are orders above).  The kernel build and the
    A+phi*B combine stay float32 (f64 on the complex128 parity path) —
    only the big streaming operand narrows.

    int8 WINDOW ROWS (values = wire samples / INT8_SCALE) halve the HBM
    read once more: the kernel is quantized to int8 (round(k*127)), the
    correlation becomes an exact s8 x s8 -> s32 matmul, and
    the s32 output is rescaled by INT8_SCALE/127 back to wire-scale f32
    before the combine — so every downstream consumer (sync thresholds,
    quantizer) sees the same value scale as the float paths.  Per-tap
    quantization error is ~0.4%; the 40-tap coherent accumulation and the
    3-bit soft quantizer absorb it (decoded frames match the f32 path,
    tests/test_locked.py::TestInt8Buffer).

    `scale` (int8 buffers only): per-channel (C,) float32 wire units per
    int8 step.  None means the fixed wire-full-scale INT8_SCALE; streaming
    drivers with AGC (stream/locked.py) pass their adapted per-channel
    scale so deep-low-SNR noise excursions are not soft-clipped by the
    fixed full-scale step.

    `frac`: per-channel (C,) fractional-sample timing in [0, 1) — the
    correlation of the LINEARLY-INTERPOLATED stream at offset r + frac.
    By linearity it is exactly a BLEND OF THE TWO MASK KERNELS
    ((1-frac) * kernel(r) + frac * kernel(r+1)), so sub-sample timing
    costs ZERO extra matmul work: the boundary tap t == r gets weight
    (1-frac) on the tail side and frac on the head side.  (The blend's
    f-term carries a spurious e^{-j*inc} ~ 0.04 rad reference-phase
    rotation vs true interpolation — a <0.1% soft-power effect, far under
    the ~1.25%/0.5-sample triangular-ACF loss this recovers.)  None = 0:
    integer-grid timing, the pre-round-3 behavior."""
    c = samples.shape[0]
    windowed = samples.ndim == 3 and samples.shape[-1] == 2 * _SPS
    interleaved = samples.ndim == 3 and not windowed
    # kernel-build / combine dtype; the interleaved big operand keeps its
    # own (possibly bf16) dtype — registry.symbol_corr narrows the kernel
    # to match and accumulates in f32
    real_dt = (jnp.float64 if samples.dtype == jnp.complex128
               else jnp.float32)
    cplx_dt = jnp.complex128 if real_dt == jnp.float64 else jnp.complex64
    freqs = jnp.stack([-CONFIG.freq_dev + freq_offset,
                       CONFIG.freq_dev + freq_offset], axis=-1)   # (C, 2)
    incs = (_TWO_PI / CONFIG.sample_rate) * freqs
    i = jnp.arange(_SPS, dtype=incs.dtype)
    e = jnp.exp(-1j * incs[:, None, :] * i[None, :, None]).astype(cplx_dt)
    t_idx = jnp.arange(_SPS, dtype=jnp.int32)[None, :]
    if frac is None:
        tail_w = (t_idx >= r[:, None]).astype(real_dt)[:, :, None]
    else:
        f = frac.astype(real_dt)[:, None]
        # t > r: 1;  t == r: 1-frac;  t < r: 0  (see docstring)
        tail_w = jnp.where(t_idx > r[:, None], 1.0,
                           jnp.where(t_idx == r[:, None], 1.0 - f, 0.0)
                           )[:, :, None].astype(real_dt)
    kern = jnp.concatenate([tail_w * e,
                            (1.0 - tail_w) * e], axis=-1)         # (C, 40, 4)
    if windowed:
        sym_f = samples[:, : nsym + 1, :]
    elif interleaved:
        sym_f = samples[:, : (nsym + 1) * _SPS, :].reshape(
            c, nsym + 1, 2 * _SPS)
    else:
        win = samples[:, : (nsym + 1) * _SPS]
        sym_f = jnp.stack([win.real.astype(real_dt),
                           win.imag.astype(real_dt)], axis=-1
                          ).reshape(c, nsym + 1, 2 * _SPS)
    kr, ki = kern.real, kern.imag                                 # (C, 40, 4)
    kern_f = jnp.stack(
        [jnp.concatenate([kr, ki], -1),                           # re row
         jnp.concatenate([-ki, kr], -1)], axis=2                  # im row
    ).reshape(c, 2 * _SPS, 8)                 # (C, 80, [Are Bre Aim Bim x2])
    from opv_tpu.ops import registry
    if sym_f.dtype == jnp.int8:
        # quantized path: exact s8 x s8 -> s32 dot, rescaled to wire-scale
        # f32 (|kern| <= 1, so round(k*127) never overflows int8)
        kern_q = jnp.round(kern_f * 127.0).astype(jnp.int8)
        if scale is None:
            resc = jnp.float32(INT8_SCALE / 127.0)
        else:
            resc = (scale.astype(jnp.float32) / 127.0)[:, None, None]
        ab = registry.symbol_corr(sym_f, kern_q).astype(jnp.float32) * resc
    else:
        ab = registry.symbol_corr(sym_f, kern_f)                  # (C,ns+1,8)
    a_re, b_re = ab[:, :-1, 0:2], ab[:, 1:, 2:4]
    a_im, b_im = ab[:, :-1, 4:6], ab[:, 1:, 6:8]
    phi = jnp.exp(-1j * incs * _SPS)[:, None, :]
    p_re, p_im = phi.real.astype(real_dt), phi.imag.astype(real_dt)
    c_re = a_re + p_re * b_re - p_im * b_im                       # (C, ns, 2)
    c_im = a_im + p_re * b_im + p_im * b_re
    p = c_re ** 2 + c_im ** 2
    return p[..., 1] - p[..., 0]


@functools.partial(jax.jit, static_argnames=("n_frames",))
def rx_locked_steady(samples: jnp.ndarray, p0: jnp.ndarray,
                     freq_offset: jnp.ndarray, n_frames: int, scale=None,
                     frac=None):
    """Steady-state hot loop: grid already acquired (p0 known), CFO known.

    This is the per-block production path: blocks that advance by an exact
    multiple of 86,720 samples keep p0 invariant, so no re-acquisition is
    needed — exactly like the reference's LOCKED state, which only re-checks
    sync (our per-frame sync_q) rather than re-hunting.  `samples` may be
    (C, N) complex, (C, N, 2) float32/bf16 IQ pairs (the wire format), or
    (C, M, 80) window rows (see _symbol_soft_batch — the zero-relayout
    production form stream/locked.py feeds).  Lock loss shows up
    as sync_q collapsing; stream.locked.LockedStreamDemodulator watches the
    per-frame q and drives rx_locked_reacquire for the channels that lost it.
    `scale`: per-channel int8 quantization step (see _symbol_soft_batch).
    `frac`: per-channel fractional-sample timing (see _symbol_soft_batch).
    """
    return _locked_body(samples, p0, freq_offset, n_frames, scale, frac)


@functools.partial(jax.jit, static_argnames=("n_frames",))
def rx_locked_reacquire(samples: jnp.ndarray, p0_old: jnp.ndarray,
                        freq_offset_old: jnp.ndarray, keep: jnp.ndarray,
                        n_frames: int, frac_old=None):
    """Selective re-acquisition: re-hunt only the channels that lost lock.

    Mirrors the reference's LOCKED -> HUNTING fallback
    (src/opv-demod.cpp:695-713): channels with `keep=True` retain their
    grid (p0) and CFO; the rest get a fresh CFO estimate + dense sync
    acquisition over this block.  Returns the same dict as rx_locked with
    the merged p0/freq_offset, so streaming drivers can run this whenever
    any channel is unlocked and rx_locked_steady otherwise.
    """
    from opv_tpu.rx.cfo import estimate_cfo_batch
    # Hunt with the carried CFO (zero for never-locked channels): the
    # 40-sample tone correlation loses <2% even at the full +-2 kHz AFC
    # clamp, so CFO error cannot hide a sync from the hunt.
    hunt_foff = jnp.where(keep, freq_offset_old,
                          jnp.zeros_like(freq_offset_old))
    soft_h = dense_soft(samples, hunt_foff)
    raw, norm = dense_sync(soft_h)
    p0_new, found, p0_u, found_u = hunt_grid(raw, norm)
    # an unverified-only candidate (no second sync one frame later) is an
    # isolated single-frame burst: process the block on ITS grid so the
    # frame decodes, and flag it so the streaming driver can emit without
    # taking the lock (reference emission semantics, opv-demod.cpp:657-680,
    # without the false-lock flywheel cost)
    burst_only = ~keep & ~found & found_u
    p0 = jnp.where(keep | ~(found | found_u), p0_old,
                   jnp.where(found, p0_new, p0_u))
    # CFO estimated on one frame interval AT the acquired position (the
    # block may hold noise before a mid-block burst; estimating from the
    # block head would be meaningless there).
    seg = _slice_rows(samples, p0, _FS * _SPS)
    cfo_new = estimate_cfo_batch(seg).astype(jnp.float32)
    # correct the grid estimator's pinned bias with the feed-forward AFC
    # discriminator (see refine_cfo_locked; twice — its gain shrinks ~0.65x
    # per pass under waterfall noise) — seg already starts at the acquired
    # sync, so the refine slice is the identity
    cfo_new = refine_cfo_locked(seg, jnp.zeros_like(p0), cfo_new)
    cfo_new = refine_cfo_locked(seg, jnp.zeros_like(p0), cfo_new)
    freq_offset = jnp.where(keep, freq_offset_old, cfo_new)
    # multi-frame-averaged sub-sample timing for the NEWLY acquired grids
    # (kept channels retain their carried frac), folded from the hunt's
    # OWN dense correlation by static reshape (refine_timing_from_raw
    # docstring).
    if frac_old is None:
        frac_old = jnp.zeros(samples.shape[0], jnp.float32)
    p0_r, frac_new = refine_timing_from_raw(raw, p0)
    acquired = ~keep & (found | found_u)
    p0 = jnp.where(acquired, p0_r, p0)
    frac = jnp.where(acquired, frac_new, frac_old.astype(jnp.float32))
    out = _locked_body(samples, p0, freq_offset, n_frames, frac=frac)
    out["burst_only"] = burst_only
    out["frac"] = frac
    return out


def rx_locked_hunt_strided(samples: jnp.ndarray, p0_old: jnp.ndarray,
                           freq_offset_old: jnp.ndarray, keep: jnp.ndarray,
                           stride: int = 2):
    """Stage 1 of the SPLIT re-acquisition: the dense hunt at sample
    stride `stride` (default 2 — detection-safe on the 2-sample MSK sync
    apex plateau; it halves the dense soft+sync pass).

    Same candidate/merge semantics as rx_locked_reacquire's hunt section;
    the sub-sample-accurate grid comes from the later stages'
    full-resolution slab refine (rx_locked_reacquire_cfo +
    refine_timing_locked + rx_locked_steady), run as SEPARATE device
    programs.  Dispatches are async, so the split costs no extra round
    trip — the driver fetches only the final stage's outputs (plus this
    stage's burst_only flag piggybacked into the same fetch).

    Returns dict(p0 (C,) int32 SAMPLE units, acquired (C,) bool,
    burst_only (C,) bool).
    """
    hunt_foff = jnp.where(keep, freq_offset_old,
                          jnp.zeros_like(freq_offset_old))
    soft_h = dense_soft(samples, hunt_foff, stride=stride)
    raw, norm = dense_sync(soft_h, stride=stride)
    p0_new, found, p0_u, found_u = hunt_grid(raw, norm, stride=stride)
    burst_only = ~keep & ~found & found_u
    p0 = jnp.where(keep | ~(found | found_u), p0_old,
                   jnp.where(found, p0_new, p0_u))
    acquired = ~keep & (found | found_u)
    return dict(p0=p0.astype(jnp.int32), acquired=acquired,
                burst_only=burst_only)


def rx_locked_reacquire_cfo(samples: jnp.ndarray, p0: jnp.ndarray,
                            freq_offset_old: jnp.ndarray,
                            keep: jnp.ndarray) -> jnp.ndarray:
    """Stage 2 of the SPLIT re-acquisition: the merged (C,) CFO at the
    stage-1 grid — rx_locked_reacquire's CFO section verbatim (grid
    estimate on one frame interval at p0, twice-refined feed-forward
    bias correction, carried value for kept channels).

    The split stages are the dense hunt (stage 1), the batch CFO
    estimators (this stage), the retime slab program (stage 3) and the
    steady body (stage 4).  The timing refine (stage 3,
    refine_timing_locked at THIS refined CFO) differs deliberately from
    the monolithic path, which reuses the hunt's own dense raw: stage 1
    only computed that at stride 2, and a stride-2 fold would halve the
    sub-sample estimator's resolution exactly where the acquisition
    transient is most BER-sensitive.
    """
    from opv_tpu.rx.cfo import estimate_cfo_batch
    seg = _slice_rows(samples, p0, _FS * _SPS)
    cfo_new = estimate_cfo_batch(seg).astype(jnp.float32)
    cfo_new = refine_cfo_locked(seg, jnp.zeros_like(p0), cfo_new)
    cfo_new = refine_cfo_locked(seg, jnp.zeros_like(p0), cfo_new)
    return jnp.where(keep, freq_offset_old, cfo_new)


@functools.partial(jax.jit, static_argnames=("n_frames", "estimate_cfo_flag"))
def rx_locked(samples: jnp.ndarray, n_frames: int, freq_offset=None,
              estimate_cfo_flag: bool = True):
    """Locked-grid pipeline: (C, N) complex -> n_frames decoded frames/chan.

    N must cover p0 + n_frames full frames; callers size blocks with one
    frame of slack.  Returns dict with frames (C, F, 134), metrics (C, F),
    frame_valid (C, F), sync_q (C, F), p0 (C,), freq_offset (C,).
    """
    c, n = samples.shape
    refine = False
    if freq_offset is None:
        if estimate_cfo_flag:
            from opv_tpu.rx.cfo import estimate_cfo_batch
            freq_offset = estimate_cfo_batch(samples).astype(jnp.float32)
            refine = True           # correct the grid estimator's bias
        else:
            freq_offset = jnp.zeros((c,), jnp.float32)

    # --- acquisition on the first TWO frame intervals ---
    # hunt_grid's verified earliest candidate (absolute thresholds + next-
    # frame re-check) needs one extra frame of correlation for the re-check.
    # When nothing verifies there are TWO fallbacks, in order: the deep-
    # fold argmax over the whole refine span (below — 5 dB-class captures
    # where single-window thresholds fail; on pure noise its arbitrary
    # folded argmax false-locks just like the reference's argmax does,
    # preserving the quirk's EFFECT though not its position), and — only
    # when the capture is too short to fold (fcount < 2) — acquire_grid's
    # relative rule ("first >= 0.9 x window max").  Both grid within the
    # first frame interval; under AWGN the first sync's raw peak can dip
    # below 0.9 x a later sync's peak, which with acquire_grid alone used
    # to lock one full frame late and shift every decoded slot.
    acq_len = min(n, (2 * _FS + _SB + 2) * _SPS)

    def acquire(foff):
        soft_acq = dense_soft(samples[:, :acq_len], foff)
        raw, norm = dense_sync(soft_acq)
        p0_hunt, found, _, _ = hunt_grid(raw, norm)
        return jnp.where(found, p0_hunt, acquire_grid(raw)), found

    p0, found = acquire(freq_offset)
    if refine:
        # correct the grid estimator's pinned +1430 Hz-class bias with the
        # feed-forward AFC discriminator (refine_cfo_locked; twice — its
        # gain shrinks ~0.65x per pass under waterfall noise), then RE-HUNT
        # at the corrected offset: an uncorrected ~1.5 kHz bias costs the
        # weaker FIRST sync its hunt detection at the FEC waterfall
        # (measured on tests/golden/awgn8.iq: one whole frame, 10x the
        # residual BER).  One extra 2-frame dense pass per batch call.
        freq_offset = refine_cfo_locked(samples, p0, freq_offset)
        freq_offset = refine_cfo_locked(samples, p0, freq_offset)
        p0, found = acquire(freq_offset)
        freq_offset = refine_cfo_locked(samples, p0, freq_offset)
    # multi-frame-averaged sub-sample timing: one dense pass over up to 32
    # frame intervals, folded by static reshape (refine_timing_from_raw).
    # At the 7 dB waterfall the fold's residual wobble is the locked path's
    # whole remaining deficit vs the reference (~0.05 dB = ~12% BER on the
    # 10x/dB slope), so deep averaging pays; past ~32
    # folds the gain is under the parabola bias.
    refine_len = min(n, (min(n_frames, REFINE_FOLD_CAP) + 1) * _FS * _SPS
                     + (_SB + 2) * _SPS)
    soft_r = dense_soft(samples[:, :refine_len], freq_offset)
    raw_r, _ = dense_sync(soft_r)
    # deep-fold ACQUISITION fallback: where the 2-frame hunt verified no
    # sync (5 dB-class captures — single-window thresholds fail while the
    # reference's serial tracker still acquires),
    # take the grid phase from the argmax of the WHOLE refine fold rather
    # than the first interval's single-shot argmax: the same sqrt(F)
    # noise averaging the timing refinement exploits, applied to the
    # acquisition itself.  Measured at 5 dB (5 seeded 200-frame captures):
    # the single-shot fallback mis-gridded 3/5 captures (BER ~0.97
    # — total misalignment, vs ~0.35 aligned); the folded fallback
    # acquires all 5 at BER 0.348-0.363, below the reference's 0.391.
    # Verified hunts are untouched, so >=7 dB behavior (incl. the pinned
    # reference quirks) is identical.
    spf = _FS * _SPS
    fcount = raw_r.shape[1] // spf
    if fcount >= 2:
        fold_full = raw_r[:, : fcount * spf].reshape(c, fcount, spf).sum(1)
        p0_fold = jnp.argmax(fold_full, axis=-1).astype(jnp.int32)
        p0 = jnp.where(found, p0, p0_fold)
    p0, frac = refine_timing_from_raw(raw_r, p0)
    return _locked_body(samples, p0, freq_offset, n_frames, frac=frac)


@jax.jit
def refine_cfo_locked(samples: jnp.ndarray, p0: jnp.ndarray,
                      freq_offset: jnp.ndarray) -> jnp.ndarray:
    """Feed-forward CFO refinement at the locked grid: (C,) corrected Hz.

    The coarse grid search (rx/cfo.py) reproduces the reference's estimator
    INCLUDING its bias (+1430 Hz on a clean 0-offset capture — a pinned
    reference quirk).  The reference then converges that bias away with its
    per-symbol AFC loop (src/opv-demod.cpp:288-307: phase of the dominant
    tone's correlation, inter-symbol); the locked engine has no serial
    loop, so an uncorrected bias costs waterfall SNR (measured ~5x residual
    BER vs the reference at 8 dB on tests/golden/awgn8.iq).

    This is the AFC discriminator, batched: one frame of per-symbol complex
    tone correlations at the acquired grid; consecutive symbols where the
    SAME tone dominates accumulate phase 2*pi*df*40/fs per symbol from any
    residual offset df, so a power-weighted mean of the pairwise phase
    increments reads df directly (~1000 usable pairs/frame -> sigma(df)
    ~100 Hz at the FEC waterfall).  One extra symbol-rate pass over one
    frame per acquisition — negligible next to the dense hunt.
    """
    seg = _slice_rows(samples, p0, _FS * _SPS)        # (C, spf) from sync
    c = seg.shape[0]
    freqs = jnp.stack([-CONFIG.freq_dev + freq_offset,
                       CONFIG.freq_dev + freq_offset], axis=-1)    # (C, 2)
    incs = (_TWO_PI / CONFIG.sample_rate) * freqs
    t = jnp.arange(_SPS, dtype=jnp.float32)
    e = jnp.exp(-1j * incs[:, None, :] * t[None, :, None])        # (C,40,2)
    sym = seg.reshape(c, _FS, _SPS)
    corr = jnp.einsum("cst,ctk->csk", sym, e.astype(seg.dtype))   # (C,S,2)
    p = jnp.abs(corr) ** 2
    dom = (p[..., 1] > p[..., 0]).astype(jnp.int32)               # 0:F1 1:F2
    sel = jnp.where(dom[..., None] == 1, corr[..., 1:2], corr[..., 0:1])[..., 0]
    same = (dom[:, 1:] == dom[:, :-1]).astype(jnp.float32)
    pair = sel[:, 1:] * jnp.conj(sel[:, :-1])
    # the per-symbol kernel restarts at phase 0 each symbol (unlike the
    # reference's free-running NCO, opv-demod.cpp:231-252), so the pairwise
    # phase still contains the dominant tone's own per-symbol advance
    # (exactly +-pi/2 at dev = symbol_rate/4, plus the estimate) — rotate
    # it out so only the residual df remains
    adv = jnp.exp(-1j * incs * _SPS)                              # (C, 2)
    adv_dom = jnp.where(dom[:, 1:] == 1, adv[:, 1:2], adv[:, 0:1])
    pair = pair * adv_dom
    w = same * jnp.minimum(p.max(-1)[:, 1:], p.max(-1)[:, :-1])
    ang = jnp.arctan2((pair.imag * w).sum(-1), (pair.real * w).sum(-1))
    df = ang * (CONFIG.sample_rate / (_TWO_PI * _SPS))
    # the discriminator is unambiguous to +-fs/(2*sps) = +-27.1 kHz; clamp
    # the CORRECTION to the reference's AFC authority (src/opv-demod.cpp:
    # 303) so the all-noise degenerate case (w ~ 0 -> arbitrary angle)
    # cannot fling the estimate outside the lock-tolerant band
    df = jnp.clip(df, -CONFIG.afc_clamp_hz, CONFIG.afc_clamp_hz)
    return (freq_offset + df).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("n_frames",))
def refine_timing_locked(samples: jnp.ndarray, p0: jnp.ndarray,
                         freq_offset: jnp.ndarray, n_frames: int):
    """Multi-frame-averaged sub-sample timing at the locked grid.

    The hunt/acquire peak is a SINGLE sync correlation's argmax: at the FEC
    waterfall its position jitters by a few samples (measured: 3 samples at
    7 dB), and the integrate-and-dump correlation loses ~tau/40 amplitude
    per sample of offset — ~0.34 dB, worth ~2-3x BER on the 10x/dB
    waterfall slope.  The reference's per-symbol TED converges this away
    (src/opv-demod.cpp:270-286); the grid path instead FOLDS the dense sync
    correlation across every frame interval in the window (noise averages
    down ~sqrt(F)) and refines the folded peak to sub-sample resolution by
    parabolic interpolation.

    Returns ((C,) p0_refined int32, (C,) frac in [0, 1), (C, 43) fold)
    such that the true sync position is p0_refined + frac; feed frac to
    the soft stage's blended kernel (_symbol_soft_batch).  The raw folded
    segment (bin b <-> sample offset p0 - 20 + b) is returned so streaming
    drivers can ACCUMULATE folds across blocks — averaging the sufficient
    statistic instead of the noisy per-window estimates
    (stream/locked.py _FOLD_DECAY).  Cost: n_frames slabs of ~1.7k
    samples of dense correlation per channel — a few % of one dense hunt.
    """
    c = samples.shape[0]
    half = _SPS // 2
    n_off = 2 * half + 1                          # +-20 samples around p0
    # slab: offsets + the sync correlation's own 24-symbol reach + interp
    slab_len = n_off + (_SB - 1) * _SPS + _SPS + 8
    base = jnp.maximum(p0 - half, 0)              # a p0 < 20 slab would
    slabs = []                                    # otherwise clamp-shift
    n_total = samples.shape[1]                    # flat (C, N) only here
    for k in range(n_frames):                     # static unroll: one
        st = base + k * _FS * _SPS                # concatenated dense pass
        # a slab past the window end would be clamp-shifted by
        # dynamic_slice and fold in MISALIGNED correlation — zero it
        # instead (late p0 + short window, e.g. streaming re-acquire
        # near the window tail)
        ok = (st + slab_len <= n_total).astype(samples.dtype)
        slabs.append(_slice_rows(samples, st, slab_len) * ok[:, None])
    # zero-pad past the correlators' valid-trim (39-sample tone window +
    # 920-sample dilated sync reach) so raw covers every slab position; the
    # padding only touches the last slab's offsets beyond n_off, never read
    cat = jnp.concatenate(slabs + [jnp.zeros((c, 1024), slabs[0].dtype)],
                          axis=1)
    soft = dense_soft(cat, freq_offset)
    raw, _ = dense_sync(soft)
    raw = raw[:, : n_frames * slab_len].reshape(c, n_frames, slab_len)
    fold = raw[:, :, :n_off + 2].sum(axis=1)      # (C, n_off+2)
    est = _fold_est(fold)
    pos = base.astype(jnp.float32) + est
    p0r = jnp.floor(pos).astype(jnp.int32)
    frac = (pos - jnp.floor(pos)).astype(jnp.float32)
    # if even slab 0 overran the window (a burst hunted at the very tail),
    # the fold is all-zero and pk is meaningless: keep the hunt's p0 and
    # sit on the plateau center (the dense argmax tie-breaks to the FIRST
    # of the pairwise-equal pair, so +0.5 is the apex center)
    valid0 = base + slab_len <= n_total
    p0r = jnp.where(valid0, p0r, p0)
    frac = jnp.where(valid0, frac, 0.5).astype(jnp.float32)
    return p0r, frac, fold


#: static bias of the smoothed 3-point parabola on the clean folded sync
#: correlation, measured in the capture INTERIOR: the apex skirt is
#: symmetric to ~0.5%, leaving a small (+0.04..+0.06, shrinking with fold
#: depth) late pull from the tail interval's residual asymmetry.
#: (A signal starting at sample 0 shows a fake +0.48 "asymmetry" — the
#: capture head truncates the left skirt; do not calibrate there.)
#: Template/matched-filter estimators were tried and REJECTED: the fold's
#: broad shape makes the MF peak nearly flat, so its calibration drifts
#: ~0.7 samples with fold depth, and differenced (edge-matched) templates
#: amplify bin noise ~3x (measured).  Generated by
#: tools/gen_timing_template.py; pinned by
#: tests/test_locked.py::test_timing_parabola_bias_constant.
_PB_BIAS = 0.0409839434


def _fold_est(fold: jnp.ndarray) -> jnp.ndarray:
    """Shared sub-sample peak estimator: (C, n_off+2) folded sync
    correlation -> (C,) float32 offset of the apex CENTER relative to
    fold[:, 0].

    The int16 MSK waveform's dense correlation is pairwise-equal in
    adjacent offsets (a genuine 2-sample apex plateau — verified against
    brute-force dots, tests/test_locked.py::test_timing_refinement_*).
    Summing adjacent bins ([1,1] smoothing) removes the stair pairing and
    restores curvature at the apex, so the argmax + parabola are
    well-conditioned; smoothed bin j centers on offset j + 0.5.  The
    small tail-interval asymmetry bias of the parabola is removed by the
    clean-fold calibration constant (_PB_BIAS).

    Peak over [0, n_off-1]: bin 0 matters when a clamped base puts the
    apex pair at offsets {0, 1}; restricting to >=1 forced pk=1 with delta
    clipped to -0.5 — half a sample late, measured worth ~25% BER at 8 dB.
    At pk=0 the left parabola neighbor doesn't exist; fall back to the
    smoothed bin's own center, which IS the plateau center (uncorrected:
    the bias calibration belongs to the parabola, not the raw argmax)."""
    n_off = fold.shape[-1] - 2
    fold = fold[:, :-1] + fold[:, 1:]             # (C, n_off+1)
    idx = jnp.arange(fold.shape[-1], dtype=jnp.int32)[None, :]
    inner = (idx >= 0) & (idx <= n_off - 1)
    pk = jnp.argmax(jnp.where(inner, fold, -jnp.inf), axis=-1).astype(jnp.int32)
    # gather-free neighbor extraction (one-hot masked sums)
    oh = idx == pk[:, None]
    r0 = (fold * oh).sum(-1)
    rm = (fold * (idx == pk[:, None] - 1)).sum(-1)
    rp = (fold * (idx == pk[:, None] + 1)).sum(-1)
    denom = rm - 2.0 * r0 + rp
    delta = jnp.where(jnp.abs(denom) > 1e-30,
                      0.5 * (rm - rp) / denom, 0.0)
    delta = jnp.where(pk == 0, 0.0,
                      jnp.clip(delta, -0.5, 0.5) - _PB_BIAS)
    return pk.astype(jnp.float32) + delta + 0.5   # smoothed-bin center


def fold_est_np(fold: np.ndarray) -> np.ndarray:
    """Numpy twin of _fold_est for HOST-side use on accumulated folds
    (stream/locked.py fold accumulator: a tiny (C, 43) estimate per block
    is not worth a device dispatch + fetch).
    Semantics pinned identical to the jax version by
    tests/test_locked.py::test_fold_est_np_matches_jax."""
    fold = np.asarray(fold, np.float64)
    n_off = fold.shape[-1] - 2
    sm = fold[:, :-1] + fold[:, 1:]
    pk = np.argmax(sm[:, :n_off], axis=-1).astype(np.int64)
    rows = np.arange(fold.shape[0])
    r0 = sm[rows, pk]
    rm = np.where(pk > 0, sm[rows, np.maximum(pk - 1, 0)], 0.0)
    rp = sm[rows, pk + 1]
    denom = rm - 2.0 * r0 + rp
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = np.where(np.abs(denom) > 1e-30, 0.5 * (rm - rp) / denom, 0.0)
    delta = np.where(pk == 0, 0.0, np.clip(delta, -0.5, 0.5) - _PB_BIAS)
    return (pk + delta + 0.5).astype(np.float32)


def refine_timing_from_raw(raw: jnp.ndarray, p0: jnp.ndarray):
    """Sub-sample timing from an ALREADY-COMPUTED dense sync correlation.

    The slab form (refine_timing_locked) gathers per-frame slabs with
    scanned dynamic slices, a second dense pass.  Where the dense
    correlation over the window already exists (re-acquire's hunt,
    rx_locked's refine pass),
    folding is a STATIC reshape-sum over frame intervals — zero dynamic
    slicing in the fused program except ONE scanned slice of the tiny
    (C, spf + 43) folded array.

    raw: (C, M) dense sync correlation (dense_sync).  Every complete frame
    interval in raw is folded — positions before a mid-window burst add
    zero-mean noise to the fold (a mild SNR dilution vs the slab form's
    burst-anchored slabs, still ~sqrt(F) better than single-shot).
    Returns ((C,) p0_refined int32 >= 0, (C,) frac in [0, 1))."""
    c, m = raw.shape
    spf = _FS * _SPS
    f = m // spf
    half = _SPS // 2
    n_off = 2 * half + 1
    if f < 1:        # capture shorter than one frame interval of positions
        return p0, jnp.full(c, 0.5, jnp.float32)
    fold_full = raw[:, : f * spf].reshape(c, f, spf).sum(axis=1)  # (C, spf)
    # doubled head so the +-half window around p0 never wraps the slice
    fold2 = jnp.concatenate([fold_full, fold_full[:, : n_off + 2]], axis=1)
    off = (p0 - half) % spf
    seg = _slice_rows(fold2, off, n_off + 2)
    est = _fold_est(seg)
    pos = jnp.maximum(p0.astype(jnp.float32) + (est - half), 0.0)
    p0r = jnp.floor(pos).astype(jnp.int32)
    frac = (pos - jnp.floor(pos)).astype(jnp.float32)
    return p0r, frac


@functools.partial(jax.jit, static_argnames=("n_frames",))
def rx_locked_retime(samples: jnp.ndarray, p0: jnp.ndarray,
                     freq_offset: jnp.ndarray, n_frames: int = 1):
    """Timing micro-adjustment for LOCKED channels — FOLDED.

    Originally a single-shot dense sync correlation around the second
    expected sync; at the FEC waterfall that argmax is noise-driven, and
    with the refresh trigger firing on sub-0.90 sync quality (routine at
    7 dB) the single-shot deltas WANDERED the grid off the transmission
    (measured: p0 walked 0 -> 6 over 200 frames, 2.4x the batch BER).
    Now the same fold as acquisition (refine_timing_locked) anchored one
    frame AFTER p0 — so a backward drift straddling the window start stays
    visible — averaging every frame interval the window holds.

    Returns ((C,) int32 delta in [-20, 20], (C,) float32 frac, (C, 43)
    fold): the corrected grid is p0 + delta with sub-sample frac; fold is
    the raw folded segment (bin b <-> offset p0 - 20 + b) for cross-block
    accumulation.  Cost: n_frames slabs of ~1k samples of dense
    correlation per channel.
    """
    spf = _FS * _SPS
    p0r, frac, fold = refine_timing_locked(samples, p0 + spf, freq_offset,
                                           n_frames=n_frames)
    half = _SPS // 2
    delta = jnp.clip(p0r - spf - p0, -half, half).astype(jnp.int32)
    return delta, frac, fold


def _slice_rows(x: jnp.ndarray, starts: jnp.ndarray, length: int) -> jnp.ndarray:
    """(C, N) -> (C, length), row c sliced from starts[c].

    lax.scan over rows: ONE compiled slice body instead of C python-unrolled
    dynamic_slices (which grow the HLO linearly in C), and NOT a batched
    gather (vmapped dynamic_slice / take_along_axis, which the compiler
    the engine was first built for could not lower).  unroll=16 trims the
    on-device loop overhead; the compiled HLO stays bounded — 16 bodies
    regardless of C."""
    def body(_, xs):
        row, st = xs
        return None, jax.lax.dynamic_slice(row, (st,), (length,))
    _, out = jax.lax.scan(body, None, (x, starts), unroll=16)
    return out


def _extract_frames(soft: jnp.ndarray, k0: jnp.ndarray, n_frames: int):
    """(C, nsym) symbol-rate soft stream -> per-frame payloads + sync checks.

    One scanned dynamic_slice per channel + static strided reshape; sync
    quality and raw correlation per frame come from a tiny batched
    (C, F, 24) @ (24,) matmul.  Split out of _locked_body so stage-level
    benchmarks (tools/stage_bench.py) can time it in isolation.
    """
    from opv_tpu.rx.sync import normalized_sync
    c, nsym = soft.shape
    span = n_frames * _FS
    # zero-pad the symbol stream so a sync acquired ANYWHERE in the window
    # (hunt_grid can return p0 deep inside the block) still yields a full
    # static slice; frames extending into the padding read zero soft values
    # and are rejected by the sync-quality gate / the caller's fit check
    soft = jnp.pad(soft, ((0, 0), (0, span)))
    w = _slice_rows(soft, jnp.clip(k0, 0, nsym), span)
    fr = w.reshape(c, n_frames, _FS)
    payloads = fr[:, :, _SB:]             # (C, F, 2144)
    sync_w = fr[:, :, :_SB]
    pat = jnp.asarray(sync_pattern(), soft.dtype)
    raw = sync_w @ pat                    # (C, F)
    q = normalized_sync(raw, jnp.abs(sync_w).sum(-1))
    return payloads, q, raw


def _locked_body(samples, p0, freq_offset, n_frames: int, scale=None,
                 frac=None):
    c = samples.shape[0]
    if samples.ndim == 3 and samples.shape[-1] == 2 * _SPS:
        n = samples.shape[1] * _SPS       # windowed (C, M, 80) rows
    else:
        n = samples.shape[1]
    # --- symbol-rate body at the shared timing phase r = p0 mod 40 ---
    r = p0 % _SPS
    k0 = (p0 - r) // _SPS                 # symbol index of the sync start
    nsym = (n - _SPS) // _SPS
    soft = _symbol_soft_batch(samples, r, freq_offset, nsym, scale,
                              frac)                               # (C,ns)

    payloads, q, raw = _extract_frames(soft, k0, n_frames)

    flat = payloads.reshape(-1, _EB)
    frames, metrics, ok = decode_payloads(flat)
    ok = ok.reshape(c, n_frames)
    # frame validity with the reference's FLYWHEEL semantics
    # (src/opv-demod.cpp:60, 697-713): a sub-threshold sync still emits its
    # frame when any of the preceding sync_miss_limit slots re-checked OK
    # (the locked state rides through up to 5 consecutive misses on the
    # predicted grid).  Gather-free trailing-window max; at the FEC
    # waterfall a single q dip below 0.70 on an otherwise-locked grid used
    # to drop a perfectly decodable frame the reference keeps
    # (tests/golden/awgn7.iq slot 9).
    w = CONFIG.sync_miss_limit + 1
    qp = jnp.pad(q, ((0, 0), (w - 1, 0)), constant_values=-jnp.inf)
    q_trail = jnp.stack([qp[:, i:i + n_frames] for i in range(w)], 0).max(0)
    fv = ok & (q_trail >= CONFIG.sync_locked_norm_thresh)
    return dict(
        frames=frames.reshape(c, n_frames, CONFIG.frame_bytes),
        metrics=metrics.reshape(c, n_frames),
        frame_valid=fv, sync_q=q, sync_raw=raw, decode_ok=ok, p0=p0,
        freq_offset=freq_offset,
        frac=(frac.astype(jnp.float32) if frac is not None
              else jnp.zeros(c, jnp.float32)),
        n_decoded=fv.sum(),
    )
