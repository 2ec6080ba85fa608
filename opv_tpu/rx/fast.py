"""Feed-forward multichannel RX pipeline (exploratory / full-backend path).

NOTE: this path uses vmapped dynamic slices and nonzero+gather patterns;
rx/locked.py is the gather-free production path.  This is the most general
pipeline (arbitrary frame positions and per-burst detection).

The reference demodulates one channel with per-symbol feedback loops (AFC +
early-late TED), which is sample-serial by construction.  This module is the
array-first redesign for the production use case (many concurrent channels from
locked-clock SDR front-ends; the tracking-loop path in rx/demod.py remains
the reference-parity / drifting-clock fallback):

* **Dense correlator bank as one matmul**: the integrate-and-dump
  correlation of both tone LOs at EVERY sample offset, phase-decomposed
  onto the 40-sample symbol grid so the whole bank is a single
  (C, M, 80) x (C, 80, 320) real matmul (windows read once) — this
  subsumes symbol-timing search entirely; there is no
  timing loop and no separate phase estimator.

* **Dilated sync correlation**: the 24-symbol sync pattern is correlated
  against the dense soft stream with a stride-40 dilated conv, giving a
  normalized sync metric at every sample position.  Frame starts are local
  maxima over a +-half-symbol window above the reference's hunting
  thresholds (0.85 norm / 5000 raw, opv-demod.cpp:783-786).

* **Feed-forward CFO**: the reference's coarse+fine grid (rx/cfo.py) per
  channel, batched over channels as one matmul per stage.

* **Strided payload gather + batched Viterbi** over all (channel, frame)
  payloads at once.

Everything is fixed-shape and jit-compiles once per (channels, block_len)
geometry.  Decodes the reference's own captures bit-exactly at arbitrary
sample alignment (tests/test_fast.py).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG
from opv_tpu.rx.frame_decoder import decode_payloads
from opv_tpu.rx.sync import sync_pattern

_TWO_PI = 2.0 * math.pi
_SPS = CONFIG.samples_per_symbol
_SB = CONFIG.sync_bits
_EB = CONFIG.encoded_bits


def dense_soft(samples: jnp.ndarray, freq_offset: jnp.ndarray,
               stride: int = 1) -> jnp.ndarray:
    """(C, N) complex IQ -> soft decision at every `stride`-th sample offset.

    stride=1 (default, the batch path): every offset, (C, N-39).
    stride=2 (streaming re-hunt): EVEN offsets only — flat index u maps to
    sample offset 2u, halving the einsum and every downstream dense pass.
    Detection-safe for hunting because the MSK sync apex is a 2-sample
    plateau (pairwise-equal adjacent offsets, CLAUDE.md DSP lore): one of
    the two apex offsets is always on the even grid at full amplitude.
    _SPS must be divisible by stride.

    soft[n] = |corr_f2[n]|^2 - |corr_f1[n]|^2 — the reference's non-coherent
    metric (opv-demod.cpp:264-268), densely evaluated.

    Formulated as the locked-grid correlation (rx/locked.py
    _symbol_soft_batch) evaluated at ALL 40 sample phases in one real
    matmul: position p = 40s + r splits at the static block boundary,

        corr_r(s) = e^{j inc r} (A_r(s) + e^{-40j inc} B_r(s+1)),

    A_r/B_r masking the shared tone vectors at t >= r / t < r, and the
    leading phase dropping inside |.|^2.  The windows tensor (C, M, 80) is
    a free reshape read ONCE by a (C, 80, 320)-kernel matmul.  (A
    per-channel vmapped 2-feature conv, the earlier form, padded its
    size-2 feature axis 64x on the first accelerator.)
    """
    c, n = samples.shape
    real_dt = (jnp.float64 if samples.dtype == jnp.complex128
               else jnp.float32)
    m2 = -(-n // _SPS)                               # ceil(N / 40)
    x = jnp.pad(samples, ((0, 0), (0, (m2 + 1) * _SPS - n)))
    sym_f = jnp.stack([x.real.astype(real_dt), x.imag.astype(real_dt)],
                      axis=-1).reshape(c, m2 + 1, 2 * _SPS)
    freqs = jnp.stack([-CONFIG.freq_dev + freq_offset,
                       CONFIG.freq_dev + freq_offset], axis=-1)   # (C, 2)
    incs = ((_TWO_PI / CONFIG.sample_rate) * freqs).astype(real_dt)
    i = jnp.arange(_SPS, dtype=real_dt)
    e = jnp.exp(-1j * incs[:, None, :] * i[None, :, None])        # (C, 40, 2)
    maskA = (jnp.arange(_SPS)[None, :, None] >=
             jnp.arange(_SPS)[None, None, :])[..., None]   # (1, t, r, 1)
    ka = jnp.where(maskA, e[:, :, None, :], 0)              # (C, 40, 40, 2)
    kb = jnp.where(maskA, 0, e[:, :, None, :])
    kern = jnp.concatenate([ka, kb], axis=-1)               # (C, 40, 40, 4)
    kr, ki = kern.real, kern.imag
    kern_f = jnp.stack(
        [jnp.concatenate([kr, ki], -1),                     # re rows
         jnp.concatenate([-ki, kr], -1)], axis=2            # im rows
    ).reshape(c, 2 * _SPS, _SPS, 8)                  # (C, 80, 40 phases, 8)
    if stride > 1:                       # keep phases 0, stride, 2*stride…
        kern_f = kern_f[:, :, ::stride, :]
    n_ph = _SPS // stride
    ab = jnp.einsum("cst,ctro->csro", sym_f, kern_f)      # (C, M+1, ph, 8)
    a_re, b_re = ab[:, :-1, :, 0:2], ab[:, 1:, :, 2:4]
    a_im, b_im = ab[:, :-1, :, 4:6], ab[:, 1:, :, 6:8]
    phi = jnp.exp(-1j * incs * _SPS)[:, None, None, :]
    c_re = a_re + phi.real.astype(real_dt) * b_re - \
        phi.imag.astype(real_dt) * b_im                     # (C, M, 40, 2)
    c_im = a_im + phi.real.astype(real_dt) * b_im + \
        phi.imag.astype(real_dt) * b_re
    p = c_re ** 2 + c_im ** 2
    soft = (p[..., 1] - p[..., 0]).reshape(c, m2 * n_ph)    # u <-> 40s + r
    return soft[:, : (n - _SPS) // stride + 1]


def dense_sync(soft: jnp.ndarray, stride: int = 1):
    """Dilated 24-tap sync correlation at every dense soft position.

    soft: (C, M) from dense_soft(..., stride=stride) — one value per
    `stride` samples, so the 40-sample symbol spacing is 40/stride
    positions.  Returns (raw, norm) of shape (C, M - 23*40/stride): the
    sync metric for a window of 24 soft symbols starting at each position.
    """
    dil = _SPS // stride
    pat = jnp.asarray(sync_pattern(), soft.dtype)[None, None, :]   # (1,1,24)
    x = soft[:, None, :]
    raw = jax.lax.conv_general_dilated(
        x, pat, window_strides=(1,), padding="VALID",
        rhs_dilation=(dil,), dimension_numbers=("NCH", "OIH", "NCH"))[:, 0]
    ones = jnp.ones_like(pat)
    energy = jax.lax.conv_general_dilated(
        jnp.abs(x), ones, window_strides=(1,), padding="VALID",
        rhs_dilation=(dil,), dimension_numbers=("NCH", "OIH", "NCH"))[:, 0]
    from opv_tpu.rx.sync import normalized_sync
    return raw, normalized_sync(raw, energy)


def detect_frames(raw: jnp.ndarray, norm: jnp.ndarray, soft: jnp.ndarray,
                  max_frames: int):
    """Find frame sync positions: threshold + local max over +-SPS/2.

    soft: the (C, M) dense soft stream the sync metrics came from (used for
    the tap-dominance guard).  Returns (starts (C, F) int32 sample index of
    the first payload soft value, valid (C, F), quality (C, F)).  A sync
    window starting at sample n has its payload starting at n + 24*40.
    """
    m_soft = soft.shape[-1]
    m = norm.shape[-1]
    hit = (norm >= CONFIG.sync_hunt_norm_thresh) & \
          (raw >= CONFIG.sync_hunt_raw_thresh)
    # tap-dominance guard: at a signal->silence edge, a window holding ONE
    # strong soft symbol (the other 23 taps in the gap) still clears both
    # thresholds (norm ~ 1.0 by construction).  A true sync spreads energy
    # over all 24 taps, so reject windows where a single tap carries most
    # of the window energy.  (The reference behaves differently but no
    # better: its LOCKED flywheel free-runs into the gap emitting garbage
    # frames until the miss limit, src/opv-demod.cpp:697-713.)
    a = jnp.abs(soft)[:, None, :]
    ones = jnp.ones((1, 1, _SB), a.dtype)
    energy = jax.lax.conv_general_dilated(
        a, ones, window_strides=(1,), padding="VALID",
        rhs_dilation=(_SPS,), dimension_numbers=("NCH", "OIH", "NCH"))[:, 0]
    # dilated max over the 24 sync taps (window 24, dilation 40)
    amax = jax.lax.reduce_window(
        jnp.abs(soft), -jnp.inf, jax.lax.max,
        window_dimensions=(1, _SB), window_strides=(1, 1),
        padding="VALID", window_dilation=(1, _SPS))
    hit = hit & (amax[:, :m] <= 0.5 * energy[:, :m])
    # normalized corr saturates at 1.0 over a plateau around true alignment;
    # the RAW correlation peaks sharply at the exact sample — select on raw
    wmax = jax.lax.reduce_window(
        raw, -jnp.inf, jax.lax.max, (1, _SPS + 1), (1, 1), "SAME")
    prev = jnp.pad(raw, [(0, 0), (1, 0)], constant_values=-jnp.inf)[:, :-1]
    is_peak = (raw >= wmax) & (raw > prev) & hit

    # timing-phase validation: data bits can imitate the sync pattern at
    # off-grid sample phases (a failure mode the reference's symbol-locked
    # tracker never sees).  A peak is accepted if EITHER
    #   (a) it matches the strongest peak's phase mod 40 (+-1 sample) — the
    #       per-channel vote that anchors the dominant burst, OR
    #   (b) another threshold-qualifying sync exists exactly one frame
    #       interval away at the same sample phase (+-1) — burst-local
    #       consistency, so a SECOND burst at a different sample phase in
    #       the same block also decodes (the reference's tracker re-acquires
    #       arbitrary phases across bursts, src/opv-demod.cpp:615-736).
    #       Noise/data imitations cannot produce two frame-aligned syncs.
    n_idx = jnp.arange(m)
    best = jnp.argmax(jnp.where(is_peak, raw, -jnp.inf), axis=-1)  # (C,)
    p_star = (best % _SPS)[:, None]
    dph = (n_idx[None, :] - p_star) % _SPS
    phase_ok = (dph <= 1) | (dph >= _SPS - 1)

    spf = CONFIG.samples_per_frame
    pad = jnp.pad(hit, ((0, 0), (1, 1)))                 # dilate +-1 sample
    dil = pad[:, :-2] | pad[:, 1:-1] | pad[:, 2:]
    nxt = jnp.pad(dil, ((0, 0), (0, spf)))[:, spf:]      # hit at n + spf
    prv = jnp.pad(dil, ((0, 0), (spf, 0)))[:, :m]        # hit at n - spf
    neighbor_ok = nxt | prv
    phase_ok = phase_ok | neighbor_ok

    # payload must fit in the dense soft stream
    fits = n_idx + _SB * _SPS + (_EB - 1) * _SPS < m_soft
    mask = is_peak & phase_ok & fits[None, :]

    def find(mk, nr):
        t = jnp.nonzero(mk, size=max_frames, fill_value=-1)[0]
        return t, nr[jnp.clip(t, 0, None)]

    t_idx, q = jax.vmap(find)(mask, norm)
    return t_idx + _SB * _SPS, t_idx >= 0, q


def extract_payloads_dense(soft: jnp.ndarray, starts: jnp.ndarray):
    """Gather (C, F, 2144) payload soft symbols at stride 40 from (C, M)."""
    span = (_EB - 1) * _SPS + 1
    m = soft.shape[-1]
    st = jnp.clip(starts, 0, m - span)

    def one(sf, p):
        w = jax.lax.dynamic_slice(sf, (p,), (span,))
        return w[:: _SPS]

    return jax.vmap(jax.vmap(one, in_axes=(None, 0)))(soft, st)


@functools.partial(jax.jit, static_argnames=("max_frames", "estimate_cfo_flag"))
def rx_fast(samples: jnp.ndarray, freq_offset=None, max_frames: int = 8,
            estimate_cfo_flag: bool = True):
    """Full feed-forward pipeline: (C, N) complex IQ -> decoded frames.

    Handles arbitrary symbol timing and frame positions (dense correlation),
    constant CFO per block (grid estimate).  Returns dict with frames
    (C, F, 134), metrics, frame_valid, sync_q, starts (sample-resolution
    payload starts), freq_offset, n_decoded.
    """
    c, n = samples.shape
    min_n = _SB * _SPS + (_EB - 1) * _SPS + _SPS + (_SB - 1) * _SPS
    if n < min_n:
        raise ValueError(
            f"rx_fast needs at least one full frame of samples ({min_n}), "
            f"got {n}; short captures cannot contain a decodable frame")
    if freq_offset is None:
        if estimate_cfo_flag:
            from opv_tpu.rx.cfo import estimate_cfo_batch
            freq_offset = estimate_cfo_batch(samples).astype(jnp.float32)
        else:
            freq_offset = jnp.zeros((c,), jnp.float32)

    soft = dense_soft(samples, freq_offset)          # (C, M)
    raw, norm = dense_sync(soft)
    starts, valid, q = detect_frames(raw, norm, soft, max_frames)
    payloads = extract_payloads_dense(soft, starts)
    flat = payloads.reshape(-1, _EB)
    frames, metrics, ok = decode_payloads(flat)
    f = payloads.shape[1]
    fv = ok.reshape(c, f) & valid
    return dict(
        frames=frames.reshape(c, f, CONFIG.frame_bytes),
        metrics=metrics.reshape(c, f),
        frame_valid=fv,
        sync_q=q, starts=starts,
        freq_offset=freq_offset,
        n_decoded=fv.sum(),
    )
