"""MSK modulator, reformulated for batched array hardware.

The reference "HDL modulator" (src/opv-mod.cpp:219-291) is a per-sample serial
loop: a 4-variable gating state machine picks, per symbol, which of two
free-running NCOs (F1 = -13550 Hz, F2 = +13550 Hz) is active and with which
sign; the active NCO's quadrature pair is scaled by 16383 and cast to int16.

Array redesign:

1.  The gating state machine reduces to two +/-1 products (see symbol_signs):
        d_s1 = d_pos_enc * T,   d_s2 = d_neg_enc * T,
        T'   = (T == 0) ? 1 : d_val * T,     b_n toggles each symbol
    — a tiny lax.scan over symbols (integer carry, no trig).

2.  Waveform synthesis is embarrassingly parallel because the numerology is
    exactly periodic: fs / f_dev = 2168000 / 13550 = 160, so both NCO phases
    are  -/+ 2*pi*(n mod 160)/160  and the two tones are complex-conjugate
    mirrors.  The whole waveform is

        I[n] = (d_s2[n/40] - d_s1[n/40]) * sin(2*pi*(n mod 160)/160)
        Q[n] = (d_s2[n/40] + d_s1[n/40]) * cos(2*pi*(n mod 160)/160)

    one fused elementwise kernel, batchable over channels (fast path).

3.  A reference-exact path (float64 serial phase accumulation with the same
    per-sample wrap order as opv-mod.cpp:262-280) exists for golden-vector
    validation; it is bit-identical to the reference binary's int16 output.

Note the first symbol after reset is silent (T starts at 0 so both signs are
0) — faithfully reproduced.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG

_SPS = CONFIG.samples_per_symbol
_PERIOD = 160                       # fs / f_dev, exact
_AMP = CONFIG.iq_amplitude
_PI = math.pi
_TWO_PI = 2.0 * math.pi
_INC1 = _TWO_PI * CONFIG.f1_freq / CONFIG.sample_rate
_INC2 = _TWO_PI * CONFIG.f2_freq / CONFIG.sample_rate


class ModulatorState(NamedTuple):
    """Serializable modulator carry (persists across frames within a stream;
    reset only at stream start — g_reset_per_frame=false, opv-mod.cpp:298)."""
    t_xor: jnp.ndarray      # int32, in {-1, 0, +1}; 0 only right after reset
    b_n: jnp.ndarray        # int32, alternates 1,0,1,...
    phase_f1: jnp.ndarray   # float64 NCO phase (exact path)
    phase_f2: jnp.ndarray
    n160: jnp.ndarray       # int32 sample index mod 160 (fast path)


def mod_reset() -> ModulatorState:
    # float64 phases when x64 is enabled (exact path); float32 otherwise
    # (fast path derives phases from n160 and never accumulates them)
    pdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return ModulatorState(
        t_xor=jnp.int32(0), b_n=jnp.int32(1),
        phase_f1=jnp.asarray(0.0, pdtype), phase_f2=jnp.asarray(0.0, pdtype),
        n160=jnp.int32(0),
    )


def symbol_signs(bits: jnp.ndarray, t_xor: jnp.ndarray, b_n: jnp.ndarray):
    """Run the gating state machine over a bit sequence — in CLOSED FORM.

    The reference's per-symbol recurrence (src/opv-mod.cpp:241-258)
        t' = (t == 0) ? 1 : (1 - 2 b) * t
    only multiplies t by +/-1 once it is nonzero (t == 0 happens exactly at
    stream start), so the t value USED at symbol k is a bit-parity prefix:
        t_init != 0:  t_k = t_init * (-1)^(b_0 + ... + b_{k-1})
        t_init == 0:  t_0 = 0,  t_k = (-1)^(b_1 + ... + b_{k-1})  for k >= 1
    and b_n simply alternates.  One cumsum + elementwise ops replace the
    serial scan: log-depth, fully vectorized, vmap-able over channels —
    the whole TX chain is now embarrassingly parallel (test_modulator pins
    equivalence against the recurrence and golden IQ stays byte-identical).

    bits: (S,) in {0,1}.  Returns (d_s1, d_s2) each (S,) int32 in {-1,0,1},
    plus the final (t_xor, b_n) carry.
    """
    bits = bits.astype(jnp.int32)
    s = bits.shape[0]
    if s == 0:
        return bits, bits, t_xor, b_n
    k = jnp.arange(s, dtype=jnp.int32)
    incl = jnp.cumsum(bits)                 # inclusive prefix sum
    excl = incl - bits                      # c_k = b_0 + ... + b_{k-1}
    t_nz = t_xor * (1 - 2 * (excl & 1))
    t_z = jnp.where(k == 0, 0, 1 - 2 * ((excl - bits[0]) & 1))
    t_k = jnp.where(t_xor == 0, t_z, t_nz)
    bn_k = jnp.where((k & 1) == 0, b_n, 1 - b_n)
    d_s1 = (1 - bits) * t_k
    d_s2 = jnp.where(bn_k == 0, -bits, bits) * t_k
    tot = incl[-1]
    t_f = jnp.where(t_xor == 0, 1 - 2 * ((tot - bits[0]) & 1),
                    t_xor * (1 - 2 * (tot & 1)))
    bn_f = jnp.where((s & 1) == 0, b_n, 1 - b_n)
    return d_s1, d_s2, t_f.astype(jnp.int32), bn_f.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Fast path: closed-form periodic phases (production / bench path)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("dtype",))
def modulate_bits_wire(bits: jnp.ndarray, state: ModulatorState,
                       dtype=jnp.float32):
    """Modulate (S,) bits -> ((S*40,) int32 packed wire words, new state).

    Each int32's little-endian bytes are exactly one wire sample
    [I_lo, I_hi, Q_lo, Q_hi] (the reference's int16 I,Q interleaved format,
    src/opv-mod.cpp:53,271-272): word = (Q << 16) | (I & 0xFFFF).  Packing
    on-device instead of stacking a (N, 2) int16 array matters: a
    concatenate on a minor axis of size 2 defeated XLA's elementwise fusion
    on the first accelerator and cost ~10x the rest of the synthesis.
    `wire.tobytes()` is the stream to emit.

    Two more facts make the synthesis one fused elementwise
    kernel, bound by the 4 B/sample HBM write:
    - the gating state machine is a closed-form bit-parity prefix
      (symbol_signs) — no scan;
    - the waveform repeats every _PERIOD = 160 samples = 4 symbols and
      every 160-sample row starts at the same phase offset, so ONE (160,)
      sin/cos row (values bit-identical to the per-sample form) broadcasts
      over (S/4, 160) rows — no per-sample transcendentals."""
    d_s1, d_s2, t_f, bn_f = symbol_signs(bits, state.t_xor, state.b_n)
    s = bits.shape[0]
    j = jnp.arange(_PERIOD, dtype=jnp.int32)
    k = (state.n160 + j) % _PERIOD
    ph = (k.astype(dtype)) * dtype(_TWO_PI / _PERIOD)
    sin_t = jnp.sin(ph)                       # (160,)
    cos_t = jnp.cos(ph)
    pad = (-s) % 4                            # static: rows of 4 symbols
    if pad:
        d_s1 = jnp.pad(d_s1, (0, pad))
        d_s2 = jnp.pad(d_s2, (0, pad))
    a1 = jnp.repeat(d_s1.reshape(-1, 4), _SPS, axis=1).astype(dtype)
    a2 = jnp.repeat(d_s2.reshape(-1, 4), _SPS, axis=1).astype(dtype)
    # phase_f1 = -ph  =>  sin_f1 = -sin_t, cos_f1 = cos_t
    i_sig = (a2 - a1) * sin_t                 # (rows, 160) * (160,)
    q_sig = (a2 + a1) * cos_t
    # truncation toward zero, as the C++ cast
    i16 = (i_sig * dtype(_AMP)).astype(jnp.int16)
    q16 = (q_sig * dtype(_AMP)).astype(jnp.int16)
    wire = (q16.astype(jnp.int32) << 16) | (i16.astype(jnp.int32) & 0xFFFF)
    wire = wire.reshape(-1)[:s * _SPS]
    n160_new = (state.n160 + s * _SPS) % _PERIOD
    # keep accumulator phases consistent for mode interop (exact rational)
    pdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    ph1 = -_TWO_PI / _PERIOD * n160_new.astype(pdtype)
    new_state = ModulatorState(t_f, bn_f, _wrap_pi_scalar(ph1),
                               _wrap_pi_scalar(-ph1), n160_new)
    return wire, new_state


@functools.partial(jax.jit, static_argnames=("dtype",))
def modulate_bits_fast(bits: jnp.ndarray, state: ModulatorState,
                       dtype=jnp.float32):
    """Modulate (S,) bits -> ((S*40, 2) int16 IQ, new state).  jit-friendly.

    The (N, 2) view is a free bitcast of the packed wire words (verified
    low-half-first on CPU and GPU); all synthesis
    happens in modulate_bits_wire."""
    wire, new_state = modulate_bits_wire(bits, state, dtype=dtype)
    return jax.lax.bitcast_convert_type(wire, jnp.int16), new_state


def _wrap_pi_scalar(p):
    p = jnp.where(p > _PI, p - _TWO_PI, p)
    return jnp.where(p < -_PI, p + _TWO_PI, p)


# ---------------------------------------------------------------------------
# Exact path: serial float64 accumulation, bit-identical to the reference
# ---------------------------------------------------------------------------

def _phase_track(ph0, inc, n):
    """Serial float64 NCO phase recurrence with the reference's per-sample
    wrap order (opv-mod.cpp:274-279).  Only the 2-flop recurrence is
    sequential; sin/cos are applied vectorized by the caller."""
    def step(ph, _):
        return _wrap_pi_scalar(ph + inc), ph
    ph_final, phases = jax.lax.scan(step, ph0, None, length=n)
    return phases, ph_final


@jax.jit
def modulate_bits_exact(bits: jnp.ndarray, state: ModulatorState):
    """Reference-exact modulation (float64 phase recurrence, per-sample wrap
    order identical to opv-mod.cpp:262-280).  Used for golden validation and
    the CLI compat path; modulate_bits_fast is the float32 bench path.

    Requires jax_enable_x64 — without it the phases silently degrade to
    float32 and the bit-exactness contract is void, so we refuse."""
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "modulate_bits_exact requires jax_enable_x64=True (the float64 "
            "phase recurrence is the bit-exactness contract); use "
            "modulate_bits_fast for float32 synthesis")
    d_s1, d_s2, t_f, bn_f = symbol_signs(bits, state.t_xor, state.b_n)
    s = bits.shape[0]
    n = s * _SPS
    ph1s, ph1f = _phase_track(state.phase_f1, jnp.float64(_INC1), n)
    ph2s, ph2f = _phase_track(state.phase_f2, jnp.float64(_INC2), n)
    a1 = jnp.repeat(d_s1, _SPS).astype(jnp.float64)
    a2 = jnp.repeat(d_s2, _SPS).astype(jnp.float64)
    i_sig = a1 * jnp.sin(ph1s) + a2 * jnp.sin(ph2s)
    q_sig = a1 * jnp.cos(ph1s) + a2 * jnp.cos(ph2s)
    iq = jnp.stack([i_sig, q_sig], axis=-1) * _AMP
    iq16 = iq.astype(jnp.int16)
    n160_new = (state.n160 + jnp.int32(n)) % _PERIOD
    return iq16, ModulatorState(t_f, bn_f, ph1f, ph2f, n160_new)


def modulate_frames(encoded_frames: jnp.ndarray, state: ModulatorState | None = None,
                    exact: bool = False, dtype=jnp.float32):
    """Modulate a batch of already-encoded frames as one continuous stream.

    encoded_frames: (F, 2144) bits.  Sync words are prepended per frame
    (opv-mod.cpp:315-321) and the modulator state flows across frames.
    Returns ((F*2168*40, 2) int16, final state).
    """
    from opv_tpu.core.framing import frame_to_symbol_bits
    if state is None:
        state = mod_reset()
    stream = frame_to_symbol_bits(encoded_frames).reshape(-1)
    fn = modulate_bits_exact if exact else (
        lambda b, st: modulate_bits_fast(b, st, dtype=dtype))
    return fn(stream, state)


def tx_flush_zeros(n_symbols: int = 100) -> np.ndarray:
    """Trailing zero-IQ flush the reference emits at end of stream
    (opv-mod.cpp:528-530) — gives the receiver's early-late lookahead room to
    demodulate the final frame."""
    return np.zeros((n_symbols * _SPS, 2), dtype=np.int16)


def iq_int16_to_complex(iq: np.ndarray, dtype=np.complex64) -> np.ndarray:
    """(N, 2) int16 -> (N,) complex, matching the demod's load convention
    (sample = I + jQ, src/opv-demod.cpp:1023)."""
    return (iq[..., 0].astype(np.float64) + 1j * iq[..., 1].astype(np.float64)).astype(dtype)
