"""Non-coherent MSK demodulator with AFC + early-late symbol timing recovery,
as a lax.scan with a small carry.

Replicates src/opv-demod.cpp:108-348 operation-for-operation (in float64 on
CPU for reference fidelity; float32 on an accelerator for speed):

per symbol: integrate-and-dump correlation of linearly-interpolated on-time /
early / late sample streams (EL spacing = 10 samples) against both tone LOs;
soft = |c2|^2 - |c1|^2; early-late-gate TED on the dominant tone feeding a
2nd-order timing loop (alpha=0.005, beta=1e-5, clamps 0.1 / 2.0); AFC from the
inter-symbol phase of the dominant tone (alpha=0.001 default, clamp +-2000 Hz,
skipped for the first symbol of each call); fractional position `mu` and
leftover samples carried across streaming chunks.

Array shape: the sequential part is only the ~12-word loop carry; each scan
step is vector work (a 64-sample dynamic slice + 6 length-40 complex
dots), and the whole scan vmaps over a channel axis so N channels run in
lockstep on (N, 40) blocks.  A fixed trip count with an `active` mask makes the
data-dependent symbol count jit-static (SURVEY.md section 7 "hard parts").
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from opv_tpu.config import CONFIG

_TWO_PI = 2.0 * math.pi
_PI = math.pi
_SPS = CONFIG.samples_per_symbol
_EL = CONFIG.el_offset          # 10.0
_WIN = 64                       # slice window: covers [pos-10-1, pos+49+2)


class LoopState(NamedTuple):
    """Serializable demodulator carry (the reference's member variables,
    opv-demod.cpp:336-347) — doubles as the checkpoint/seam-handoff record."""
    mu: jnp.ndarray           # fractional symbol position (0..1)
    phase_f1: jnp.ndarray
    phase_f2: jnp.ndarray
    freq_offset: jnp.ndarray  # Hz
    timing_freq: jnp.ndarray
    prev_c1: jnp.ndarray      # complex on-time correlators of previous symbol
    prev_c2: jnp.ndarray


def loop_state_init(freq_offset=0.0, dtype=jnp.float64) -> LoopState:
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    z = jnp.asarray(0.0, dtype)
    return LoopState(
        mu=z, phase_f1=z, phase_f2=z,
        freq_offset=jnp.asarray(freq_offset, dtype),
        timing_freq=z,
        prev_c1=jnp.asarray(0.0, cdtype), prev_c2=jnp.asarray(0.0, cdtype),
    )


def _wrap_pi(p):
    p = jnp.where(p > _PI, p - _TWO_PI, p)
    return jnp.where(p < -_PI, p + _TWO_PI, p)


def max_symbols(capacity: int) -> int:
    """Worst-case symbols a buffer can produce (timing_adj >= -2 => stride
    >= 38 samples/symbol)."""
    return int(capacity // (_SPS - CONFIG.timing_adj_clamp)) + 2


def demodulate_block(samples: jnp.ndarray, n_valid: jnp.ndarray,
                     state: LoopState, afc_alpha: float | jnp.ndarray = None):
    """Demodulate one block of IQ.

    samples: (CAP,) complex buffer (only the first n_valid entries are real
             data; CAP is the static capacity).
    n_valid: scalar int — actual sample count in the buffer.
    state:   loop carry from the previous block (mu plays the role of the
             starting fractional position; the caller prepends the leftover
             samples exactly as the reference's chunk loop does).

    Returns (soft (MAXS,), sym_valid (MAXS,), new_state, samples_used int32).
    `samples_used` = floor(final position): the caller keeps
    samples[samples_used:n_valid] as the head of the next buffer.
    """
    if afc_alpha is None:
        afc_alpha = CONFIG.afc_alpha
    cap = samples.shape[0]
    maxs = max_symbols(cap)
    rdtype = state.mu.dtype
    afc_alpha = jnp.asarray(afc_alpha, rdtype)
    n_valid = n_valid.astype(jnp.int32)

    i40 = jnp.arange(_SPS, dtype=rdtype)
    i40_int = jnp.arange(_SPS, dtype=jnp.int32)
    first_sample = samples[0]
    fd = jnp.asarray(CONFIG.freq_dev, rdtype)
    fs = jnp.asarray(CONFIG.sample_rate, rdtype)
    sr = jnp.asarray(CONFIG.symbol_rate, rdtype)

    def interp_window(w, rel):
        """Linear interp of window w at fractional positions rel.  The index
        clamp mirrors the reference (opv-demod.cpp:122-128): interpolation
        proceeds normally up to rel < WIN-1; only at/after the final sample
        does the index pin to WIN-2 (unreachable within active steps)."""
        relc = jnp.clip(rel, 0.0, _WIN - 1)
        i0 = jnp.minimum(jnp.floor(relc).astype(jnp.int32), _WIN - 2)
        f = (relc - i0.astype(rdtype)).astype(w.dtype)
        v0 = jnp.take(w, i0)
        v1 = jnp.take(w, i0 + 1)
        return v0 * (1 - f) + v1 * f

    def step(carry, _):
        # position is carried SPLIT as (pos_int int32, mu in [0,1)): a single
        # float accumulator loses the timing resolution past ~2^22 samples in
        # float32 mode, and integer compares keep the loop-gate semantics
        # exact (a float64 pos in C++ is exactly int+frac, so this matches)
        pos_int, mu, ph1, ph2, foff, tfreq, pc1, pc2, emitted = carry
        active = pos_int < n_valid - jnp.int32(_SPS + int(_EL))

        inc1 = _TWO_PI * (-fd + foff) / fs
        inc2 = _TWO_PI * (fd + foff) / fs

        base = jnp.clip(pos_int - 11, 0, cap - _WIN)
        w = jax.lax.dynamic_slice(samples, (base,), (_WIN,))

        offs = (pos_int - base).astype(rdtype) + mu
        rel_on = offs + i40
        s_on = interp_window(w, rel_on)
        # p_early < 0  <=>  pos_int + i < 10   (mu < 1 makes this exact)
        e_neg = (pos_int + i40_int) < jnp.int32(int(_EL))
        s_e = jnp.where(e_neg, first_sample, interp_window(w, rel_on - _EL))
        s_l = interp_window(w, rel_on + _EL)

        lo1 = jnp.exp(1j * (ph1 + i40 * inc1)).astype(w.dtype)
        lo2 = jnp.exp(1j * (ph2 + i40 * inc2)).astype(w.dtype)
        c1 = jnp.sum(s_on * jnp.conj(lo1))
        c2 = jnp.sum(s_on * jnp.conj(lo2))
        c1e = jnp.sum(s_e * jnp.conj(lo1))
        c2e = jnp.sum(s_e * jnp.conj(lo2))
        c1l = jnp.sum(s_l * jnp.conj(lo1))
        c2l = jnp.sum(s_l * jnp.conj(lo2))

        ph1n = _wrap_pi(ph1 + _SPS * inc1)
        ph2n = _wrap_pi(ph2 + _SPS * inc2)

        def cnorm(z):      # std::norm — re^2 + im^2, no sqrt
            return z.real * z.real + z.imag * z.imag

        e1 = cnorm(c1)
        e2 = cnorm(c2)
        soft = e2 - e1
        f1_dom = e1 > e2

        # --- early-late gate TED + 2nd order timing loop ---
        ee = jnp.where(f1_dom, cnorm(c1e), cnorm(c2e))
        el = jnp.where(f1_dom, cnorm(c1l), cnorm(c2l))
        ted = (el - ee) / (el + ee + 1e-10)
        tfreq_n = jnp.clip(tfreq + CONFIG.beta_timing * ted,
                           -CONFIG.timing_freq_clamp, CONFIG.timing_freq_clamp)
        adj = jnp.clip(CONFIG.alpha_timing * ted + tfreq_n,
                       -CONFIG.timing_adj_clamp, CONFIG.timing_adj_clamp)

        # --- AFC from inter-symbol phase of the dominant tone ---
        dom = jnp.where(f1_dom, c1, c2)
        prev_dom = jnp.where(f1_dom, pc1, pc2)
        pd = jnp.angle(dom * jnp.conj(prev_dom)).astype(rdtype)
        ferr = pd * sr / _TWO_PI
        foff_afc = jnp.clip(foff + afc_alpha * ferr,
                            -CONFIG.afc_clamp_hz, CONFIG.afc_clamp_hz)
        foff_n = jnp.where(emitted >= 1, foff_afc, foff)

        # advance: pos += 40 + adj, decomposed to keep full fractional
        # precision at any stream position
        t = mu + (_SPS + adj)
        t_int = jnp.floor(t).astype(jnp.int32)
        pos_int_n = pos_int + t_int
        mu_n = t - t_int.astype(rdtype)

        def upd(new, old):
            return jnp.where(active, new, old)

        carry_n = (upd(pos_int_n, pos_int), upd(mu_n, mu),
                   upd(ph1n, ph1), upd(ph2n, ph2),
                   upd(foff_n, foff), upd(tfreq_n, tfreq),
                   upd(c1, pc1), upd(c2, pc2),
                   emitted + active.astype(jnp.int32))
        return carry_n, (jnp.where(active, soft, 0.0), active)

    carry0 = (jnp.int32(0), state.mu, state.phase_f1, state.phase_f2,
              state.freq_offset, state.timing_freq, state.prev_c1,
              state.prev_c2, jnp.int32(0))
    carry_f, (soft, sym_valid) = jax.lax.scan(step, carry0, None, length=maxs)
    pos_i_f, mu_f, ph1_f, ph2_f, foff_f, tfreq_f, pc1_f, pc2_f, _ = carry_f

    samples_used = pos_i_f
    new_state = LoopState(
        mu=mu_f,
        phase_f1=ph1_f, phase_f2=ph2_f, freq_offset=foff_f,
        timing_freq=tfreq_f, prev_c1=pc1_f, prev_c2=pc2_f,
    )
    return soft, sym_valid, new_state, samples_used
