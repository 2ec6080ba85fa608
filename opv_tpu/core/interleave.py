"""67x32 block interleaver as precomputed permutation gathers.

The reference scatters bit i of the encoded stream to position

    pos  = (i % 32) * 67 + (i / 32)
    dest = (pos / 8) * 8 + (7 - pos % 8)        # per-byte bit reversal

(src/opv-mod.cpp:142-153).  The demodulator applies the identical closed form
as a gather (`deinterleave_addr`, src/opv-demod.cpp:792-795).  Both
directions are single gathers with permutation tables computed once at import.
"""

from __future__ import annotations

import functools

import numpy as np

from opv_tpu.config import CONFIG


@functools.lru_cache(maxsize=None)
def _scatter_map(n: int = CONFIG.encoded_bits) -> np.ndarray:
    """dest[i] = where input bit i lands in the interleaved stream."""
    i = np.arange(n)
    pos = (i % CONFIG.interleave_cols) * CONFIG.interleave_rows + (i // CONFIG.interleave_cols)
    return (pos // 8) * 8 + (7 - pos % 8)


@functools.lru_cache(maxsize=None)
def interleave_perm(n: int = CONFIG.encoded_bits) -> np.ndarray:
    """Gather table P with  out = in[P]  performing TX interleaving."""
    dest = _scatter_map(n)
    inv = np.empty(n, dtype=np.int32)
    inv[dest] = np.arange(n, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def deinterleave_gather(n: int = CONFIG.encoded_bits) -> np.ndarray:
    """Gather table D with  deint = received[D]  performing RX deinterleaving.

    This equals the scatter map itself: received[dest[i]] is original bit i.
    """
    return _scatter_map(n).astype(np.int32)
