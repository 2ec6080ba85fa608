"""K=7 rate-1/2 convolutional encoder as vectorized XOR of shifted bitstreams.

The reference clocks one bit at a time through a 6-bit shift register
(src/opv-mod.cpp:120-136): state = (in << 6) | sr with sr holding the previous
six inputs (most recent in bit 0), and outputs

    g1 = parity(state & 0x4F),   g2 = parity(state & 0x6D)

State bit 6 is the current input u[i]; state bit k (k<=5) is u[i-1-k].  So a
mask bit at position 6 contributes delay 0, and a mask bit at position k<=5
contributes delay k+1.  The whole encode therefore reduces to XORing a few
delayed copies of the input bitstream — one fused elementwise op, with
zero-padding at the front reproducing the fresh (all-zero) shift register the
reference uses per frame (opv-mod.cpp:160-161; truncated, not terminated).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG


@functools.lru_cache(maxsize=None)
def _mask_delays(mask: int) -> tuple[int, ...]:
    delays = []
    if (mask >> 6) & 1:
        delays.append(0)
    for k in range(6):
        if (mask >> k) & 1:
            delays.append(k + 1)
    return tuple(sorted(delays))


G1_DELAYS = _mask_delays(CONFIG.g1_mask)   # taps of G1 as input delays
G2_DELAYS = _mask_delays(CONFIG.g2_mask)


def _xor_delayed(u_padded: jnp.ndarray, delays: tuple[int, ...], n: int) -> jnp.ndarray:
    """XOR delayed copies of u (padded with `maxd` zeros at the front)."""
    maxd = 6
    out = None
    for d in delays:
        sl = u_padded[..., maxd - d : maxd - d + n]
        out = sl if out is None else out ^ sl
    return out


def conv_encode_bits(u: jnp.ndarray) -> jnp.ndarray:
    """Encode a bit sequence; returns interleaved (g1, g2) pairs.

    u: (..., N) uint8/int bits in encoder clock order.
    returns: (..., 2N) with out[2i] = g1_i, out[2i+1] = g2_i, matching the
    emission order at src/opv-mod.cpp:186-195.
    """
    u = u.astype(jnp.uint8)
    n = u.shape[-1]
    pad = [(0, 0)] * (u.ndim - 1) + [(6, 0)]
    up = jnp.pad(u, pad)
    g1 = _xor_delayed(up, G1_DELAYS, n)
    g2 = _xor_delayed(up, G2_DELAYS, n)
    return jnp.stack([g1, g2], axis=-1).reshape(*u.shape[:-1], 2 * n)


def conv_encode_bits_np(u: np.ndarray) -> np.ndarray:
    """NumPy-returning wrapper for host-side golden tests (one algorithm,
    one implementation)."""
    return np.asarray(conv_encode_bits(jnp.asarray(u)))
