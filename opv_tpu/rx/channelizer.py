"""Analysis channelizer: one wideband capture -> K-channel bank.

The multichannel pipelines (rx_locked / stream.multichannel) consume per-
channel baseband at 2.168 MSPS.  In deployment those channels arrive as ONE
wideband digitizer stream at K x 2.168 MSPS; this module splits it
(SURVEY.md section 7.4 "channelizer for the 64-channel bank config").

Formulation: channel c is  decimate_K( lowpass_h( x[n] e^{-j2pi c n/K} ) ).
Pulling the mixer through the filter gives

    y_c[m] = const_phase * sum_t (h[t] e^{j2pi c t/K}) x[mK + d - t]

i.e. a stride-K convolution of the wideband stream with K modulated copies
of the prototype — ONE grouped strided conv (matmul work), no gathers, no FFT
bookkeeping, and constant per-channel phase (irrelevant to the non-coherent
OPV demod).  Cost is N*taps*2 MACs per channel — trivial next to the demod.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def prototype_filter(k: int, taps_per_branch: int = 12, beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed-sinc lowpass, cutoff at half the channel spacing.

    Length K * taps_per_branch, unit passband gain.  OPV occupies only the
    inner few percent of a 2.168 MHz channel, so the passband is flat where
    it matters and adjacent-channel rejection is set by `beta`.
    """
    n = k * taps_per_branch
    t = np.arange(n) - (n - 1) / 2
    h = np.sinc(t / k) * np.kaiser(n, beta)
    return (h / h.sum()).astype(np.float64)


@functools.lru_cache(maxsize=None)
def dft_kernel(k: int) -> np.ndarray:
    """The channelizer's DFT-across-legs matmul kernel, GROUPED BY OUTPUT
    CHANNEL: shape (2K, K, 2) where [:, c, 0]/[:, c, 1] are the real/imag
    kernel columns of output channel c.

    Grouping by channel makes the kernel the natural SHARDING OPERAND for a
    mesh channelizer: device d holding channels [d*lc, (d+1)*lc) takes
    kernel shard [:, d*lc:(d+1)*lc, :] (PartitionSpec(None, 'ch', None))
    and computes exactly its local channel rows — no collectives, no
    axis_index bookkeeping (stream/wideband.py mesh mode).  Each output
    element is the same (2K,)-dot product as the ungrouped kernel's, so
    column grouping does not change the numerics.
    """
    # W[c, r] = e^{+2j pi c (K-1-r) / K}  across polyphase legs r
    w = np.exp(2j * np.pi * np.arange(k)[:, None]
               * (k - 1 - np.arange(k))[None, :] / k)   # (c, r)
    wr, wi = w.real.T, w.imag.T                          # (r, c)
    # rows interleave the re/im legs of the polyphase accumulator u:
    # row 2r   (re leg of u_r) contributes  wr to re_c and  wi to im_c
    # row 2r+1 (im leg of u_r) contributes -wi to re_c and  wr to im_c
    kern = np.stack([np.stack([wr, wi], axis=-1),        # (r, c, 2)
                     np.stack([-wi, wr], axis=-1)],
                    axis=1)                               # (r, 2, c, 2)
    return kern.reshape(2 * k, k, 2)


def polyphase_legs(x: jnp.ndarray, k: int, taps_per_branch: int = 12):
    """(N,) complex wideband -> (M, 2K) filtered polyphase legs
    (re/im interleaved per leg), the left operand of the DFT matmul.

        u[m,r] = sum_p g[p,r] * X[m+p, r],       X[j,r] = x[jK + r]

    A free contiguous reshape into polyphase rows X and a taps_per_branch-
    term accumulation of SHIFTED X slices weighted per column (one fused
    elementwise pass; no gathers, no strided conv)."""
    h = prototype_filter(k, taps_per_branch)
    taps = taps_per_branch
    n = x.shape[0]
    m = (n - k * taps) // k + 1
    real_dt = x.real.dtype
    # polyphase rows: X[j, r] = x[jK + r]  (free reshape of the stream)
    rows = m + taps - 1
    xr = x[: rows * k].reshape(rows, k)
    xf = jnp.stack([xr.real, xr.imag], axis=-1).astype(real_dt)  # (rows,K,2)
    # g[p, r] = h[(taps-1-p)K + (K-1-r)]: the doubly-reversed tap matrix
    g = np.asarray(h.reshape(taps, k)[::-1, ::-1])
    gj = jnp.asarray(g, real_dt)[:, :, None]
    acc = jnp.zeros((m, k, 2), real_dt)
    for p in range(taps):                # taps is small & static: unrolled,
        acc = acc + xf[p: p + m] * gj[p]  # XLA fuses into one pass
    return acc.reshape(m, 2 * k)


def channelize_cols(x: jnp.ndarray, kern: jnp.ndarray, k: int,
                    taps_per_branch: int = 12) -> jnp.ndarray:
    """Channelize against an explicit (2K, C, 2) dft_kernel slice: returns
    the (C, M) basebands of the C channels whose kernel columns were
    passed.  With the full dft_kernel(k) this IS channelize(); with a
    'ch'-sharded kernel inside a shard_map body it computes each device's
    local channels from the (replicated) wideband stream — the mesh
    wideband receiver's fused-ingest formulation (stream/wideband.py)."""
    legs = polyphase_legs(x, k, taps_per_branch)          # (M, 2K)
    kf = kern.astype(legs.dtype)
    c = kf.shape[1]
    y = (legs @ kf.reshape(2 * k, 2 * c)).reshape(-1, c, 2)
    return (y[..., 0] + 1j * y[..., 1]).astype(x.dtype).T


@functools.partial(jax.jit, static_argnames=("k", "taps_per_branch"))
def channelize(x: jnp.ndarray, k: int, taps_per_branch: int = 12) -> jnp.ndarray:
    """(N,) complex wideband at K*fs_ch -> (K, M) channel basebands at fs_ch.

    Output channel c carries the band centered at +c * fs_ch (c > K/2 wraps
    to negative frequencies) with a constant group delay of
    (K*taps_per_branch-1)/K output samples.

    Formulated as the POLYPHASE decomposition mapped to array primitives:
    the stride-K modulated filterbank splits (t = pK + q) into

        y_c[m] = sum_r W[c,r] * u[m,r]

    with u the filtered polyphase legs (polyphase_legs) and W the DFT
    matrix (dft_kernel) — one (M, 2K) x (2K, 2K) real matmul (complex via
    interleaved re/im kernel rows, as rx/locked.py's soft stage).  The
    previous formulation — a stride-K `conv_general_dilated` with a
    K*taps-long kernel — lowered far off the memory roofline on the first
    accelerator; that conv path survives only in git history.  Numerically
    this reorders the same MACs (ulp-level differences; frame decodes and
    the channel-power tests are unaffected).
    """
    real_dt = x.real.dtype
    kern = jnp.asarray(dft_kernel(k), real_dt)
    return channelize_cols(x, kern, k, taps_per_branch)


def msk_wideband(frames_u8: np.ndarray, k: int) -> jnp.ndarray:
    """Simulation helper: the OPV MSK waveform synthesized directly AT the
    wideband rate (K x 2.168 MSPS) — identical math to tx/modulator.py's
    fast path with phase increments scaled 1/K (period 160K samples,
    40K samples/symbol), plus the standard 100-symbol zero flush.

    True-narrowband by construction (no ZOH upsampling images), so
    `synthesize_wideband` placements built from it leave quiet channels
    genuinely quiet — the single source for the channelizer tests, the
    multihost wideband worker, the dryrun and chip_smoke.py.  Computed on
    the device: a jax array, complex128 when x64 is on, else complex64."""
    from opv_tpu.core import encode_frame
    from opv_tpu.core.framing import frame_to_symbol_bits
    from opv_tpu.tx.modulator import mod_reset, symbol_signs

    enc = encode_frame(jnp.asarray(frames_u8))
    bits = frame_to_symbol_bits(enc).reshape(-1)
    st = mod_reset()
    d1, d2, _, _ = symbol_signs(bits, st.t_xor, st.b_n)
    return _msk_wave(d1, d2, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _msk_wave(d1, d2, k: int):
    from opv_tpu.config import CONFIG
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    sps = CONFIG.samples_per_symbol * k
    period = 160 * k
    idx = jnp.arange(d1.shape[0] * sps) % period
    ph = (2 * np.pi) * idx.astype(fdt) / period
    a1 = jnp.repeat(d1.astype(fdt), sps)
    a2 = jnp.repeat(d2.astype(fdt), sps)
    sig = jax.lax.complex((a2 - a1) * jnp.sin(ph), (a2 + a1) * jnp.cos(ph)) \
        * CONFIG.iq_amplitude
    return jnp.concatenate([sig, jnp.zeros(100 * sps, sig.dtype)])


def wideband_test_channels(k: int) -> list:
    """Two DISTINCT channel indices for wideband smoke signals at any K
    (the naive {1 % k, (k//2) % k} picks collapse to one channel for
    K <= 2, silently halving what a dryrun certifies)."""
    idx = list(dict.fromkeys([1 % k, (k // 2) % k, 0, max(k - 1, 0)]))
    return idx[: min(2, k)]


def synthesize_wideband(channel_signals: dict, k: int, n: int) -> jnp.ndarray:
    """Simulation helper: place signals (already sampled at the WIDEBAND
    rate) on the channelizer grid by direct frequency shift and summation.
    The mixer phase (c * t mod K) / K is exact; the sum is built on the
    device (complex128 when x64 is on, else complex64).

    channel_signals: {channel_index c: (<=N,) complex wideband-rate signal}.
    """
    cdt = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64
    out = jnp.zeros(n, cdt)
    for c, s in channel_signals.items():
        s = jnp.asarray(s, cdt)[:n]
        out = _place(out, s, jnp.int32(c), k)
    return out


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _place(out, s, c, k: int):
    m = s.shape[0]
    t = jnp.arange(m, dtype=jnp.int32)
    ph = (2 * np.pi / k) * ((c * (t % k)) % k).astype(out.real.dtype)
    mixed = s * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    return out.at[:m].add(mixed)
