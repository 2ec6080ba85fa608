"""Coarse carrier-frequency-offset estimator as batched matmuls.

The reference (src/opv-demod.cpp:131-202) serially grid-searches 121 coarse
offsets (+-1500 Hz step 25) then 13 fine offsets (+-30 Hz step 5 around the
best), integrating both tone correlators over up to 1000 symbols per
hypothesis — ~134 full passes over the data.

Array reformulation: because per-symbol correlation energy is invariant to the
inter-symbol phase of the LO (|.|^2 drops the unit-modulus carry-over factor),
the whole grid collapses to ONE complex matmul per stage:

    energy[o, tone] = sum_sym | S[sym, :] @ conj(lo[o,tone]) |^2,
    S = samples[:nsym*40].reshape(nsym, 40),  lo[o,t][i] = exp(j inc_ot i)

which is a (nsym, 40) x (40, 2*O) contraction.  Selection
semantics (strict-improvement running max == first-occurrence argmax, fine
stage must strictly beat the coarse best) match the reference exactly.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG

_TWO_PI = 2.0 * math.pi


def _grid_energies(sym_mat: jnp.ndarray, offsets: jnp.ndarray) -> jnp.ndarray:
    """sym_mat: (nsym, 40) complex; offsets: (O,) Hz -> (O,) total energy."""
    dtype = sym_mat.dtype
    freqs = jnp.stack([-CONFIG.freq_dev + offsets, CONFIG.freq_dev + offsets],
                      axis=-1)                                   # (O, 2)
    incs = (_TWO_PI / CONFIG.sample_rate) * freqs                # (O, 2)
    i = jnp.arange(CONFIG.samples_per_symbol, dtype=incs.dtype)  # (40,)
    # conj(lo) = exp(-j inc i)
    phases = -incs[..., None] * i                                # (O, 2, 40)
    e = jnp.exp(1j * phases).astype(dtype)
    corr = jnp.einsum("si,oti->sot", sym_mat, e)                 # (nsym, O, 2)
    return jnp.sum(jnp.abs(corr) ** 2, axis=(0, 2))              # (O,)


def estimate_cfo_batch(samples: jnp.ndarray) -> jnp.ndarray:
    """Natively batched CFO estimate: (C, N) complex -> (C,) Hz.

    Same grids and selection rules as estimate_cfo, written with explicit
    batch axes (channel-sharded matmuls) rather than vmap — this is the
    production multichannel path (and avoids a vmap-of-gather pattern).
    """
    sps = CONFIG.samples_per_symbol
    c, n = samples.shape
    nsym = min(n, sps * CONFIG.cfo_max_symbols) // sps
    sym = samples[:, : nsym * sps].reshape(c, nsym, sps)

    def energies(offsets):
        """offsets (C, O) -> (C, O) total correlation energy."""
        freqs = jnp.stack([-CONFIG.freq_dev + offsets,
                           CONFIG.freq_dev + offsets], axis=-1)   # (C, O, 2)
        incs = (_TWO_PI / CONFIG.sample_rate) * freqs
        i = jnp.arange(sps, dtype=incs.dtype)
        e = jnp.exp(-1j * incs[..., None] * i).astype(samples.dtype)  # (C,O,2,40)
        corr = jnp.einsum("csi,coti->csot", sym, e)
        p = corr.real ** 2 + corr.imag ** 2
        return p.sum(axis=(1, 3))                                  # (C, O)

    def select(grid, e):
        """Row-wise (value, energy) at argmax via one-hot masked reduction
        (no batched gather)."""
        i = jnp.argmax(e, axis=-1)
        onehot = jnp.arange(e.shape[-1])[None, :] == i[:, None]
        return (jnp.where(onehot, grid, 0).sum(-1),
                jnp.where(onehot, e, 0).sum(-1))

    span, step = CONFIG.cfo_coarse_span_hz, CONFIG.cfo_coarse_step_hz
    coarse = jnp.broadcast_to(jnp.arange(-span, span + step / 2, step),
                              (c, int(2 * span / step) + 1))
    e_c = energies(coarse)
    coarse_best, coarse_e = select(coarse, e_c)

    fspan, fstep = CONFIG.cfo_fine_span_hz, CONFIG.cfo_fine_step_hz
    fine = coarse_best[:, None] + jnp.arange(-fspan, fspan + fstep / 2, fstep)
    e_f = energies(fine)
    fine_best, fine_e = select(fine, e_f)
    return jnp.where(fine_e > coarse_e, fine_best, coarse_best)


def estimate_cfo(samples: jnp.ndarray) -> jnp.ndarray:
    """Estimate carrier offset in Hz from a block of IQ samples.

    samples: (N,) complex.  Uses at most cfo_max_symbols symbols, like the
    reference (opv-demod.cpp:141).  Returns a scalar (same grid + selection
    rules as the reference, so results agree on the same input).
    """
    sps = CONFIG.samples_per_symbol
    n = samples.shape[0]
    nsym = min(n, sps * CONFIG.cfo_max_symbols) // sps
    sym_mat = samples[: nsym * sps].reshape(nsym, sps)

    span, step = CONFIG.cfo_coarse_span_hz, CONFIG.cfo_coarse_step_hz
    coarse = jnp.arange(-span, span + step / 2, step)
    e_c = _grid_energies(sym_mat, coarse)
    ci = jnp.argmax(e_c)
    coarse_best = coarse[ci]
    coarse_e = e_c[ci]

    fspan, fstep = CONFIG.cfo_fine_span_hz, CONFIG.cfo_fine_step_hz
    fine = coarse_best + jnp.arange(-fspan, fspan + fstep / 2, fstep)
    e_f = _grid_energies(sym_mat, fine)
    fi = jnp.argmax(e_f)
    return jnp.where(e_f[fi] > coarse_e, fine[fi], coarse_best)
