"""CCSDS additive randomizer as a precomputed XOR mask.

The reference runs an 8-bit LFSR (x^8+x^7+x^5+x^3+1, seed 0xFF, MSB-first
output) bytewise over every frame (src/opv-mod.cpp:97-113 and the inline
derandomizer src/opv-demod.cpp:887-895).  Because the LFSR is re-seeded for
every frame, the whole randomizer is a *constant* 134-byte mask — so it
is a single vectorized XOR with a precomputed table rather than a serial
bit recurrence.
"""

from __future__ import annotations

import functools

import numpy as np

from opv_tpu.config import CONFIG


@functools.lru_cache(maxsize=None)
def randomizer_mask(n_bytes: int = CONFIG.frame_bytes, seed: int = CONFIG.lfsr_seed) -> np.ndarray:
    """Return the first `n_bytes` of the randomizer keystream as uint8."""
    state = seed & 0xFF
    out = np.zeros(n_bytes, dtype=np.uint8)
    for i in range(n_bytes):
        b = 0
        for bit in range(7, -1, -1):
            b |= ((state >> 7) & 1) << bit
            fb = ((state >> 7) ^ (state >> 6) ^ (state >> 4) ^ (state >> 2)) & 1
            state = ((state << 1) | fb) & 0xFF
        out[i] = b
    return out
