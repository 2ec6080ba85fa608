"""Test bank: C independent transmitters, synthesized on the device.

Each channel carries its own frames, starts after its own sample delay and
sits at its own carrier offset — the multi-radio receive host the locked
engine serves, with no broadcast copies, so p0, CFO and lock timing differ
per channel.  The waveform is the fast TX path (modulate_bits_wire), rotated
by the carrier offset and rounded to integer wire values, as a radio would
deliver it.  Used by chip_smoke.py, bench.py and tools/stage_bench.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG


def bank_frames(channels: int, n_frames: int, seed: int = 0) -> np.ndarray:
    """(C, F, 134) uint8 BERT frames, distinct per channel (station id
    "CH<c>" and per-channel frame numbers)."""
    from opv_tpu.core import build_bert_frame
    return np.stack([np.asarray(build_bert_frame(
        f"CH{c}", token=0xBBAADD ^ seed,
        frame_num=np.arange(n_frames) + 1000 * c))
        for c in range(channels)])


def bank_impairments(channels: int, seed: int = 0,
                     max_delay: int = 40_000, max_cfo_hz: float = 1500.0):
    """Per-channel (delays int32 samples, carrier offsets float32 Hz)."""
    rng = np.random.default_rng(seed)
    delays = rng.integers(0, max_delay, channels).astype(np.int32)
    cfo = rng.uniform(-max_cfo_hz, max_cfo_hz, channels).astype(np.float32)
    return delays, cfo


def channel_bank(frames_u8, delays, cfo_hz, tail: int = 100):
    """(C, F, 134) frames -> (C, N) complex64 device samples.

    Channel c is silent for delays[c] samples, then transmits its F frames
    continuously (sync word of frame k at sample delays[c] + k * 86,720),
    then `tail` zero symbols; N = F * 86,720 + max(delays) + tail * 40,
    rounded up to a whole symbol."""
    frames_u8 = np.asarray(frames_u8)
    c, f = frames_u8.shape[:2]
    delays = np.asarray(delays, np.int32)
    n = f * CONFIG.samples_per_frame + int(delays.max()) \
        + tail * CONFIG.samples_per_symbol
    n = -(-n // CONFIG.samples_per_symbol) * CONFIG.samples_per_symbol
    return _bank(jnp.asarray(frames_u8.reshape(c * f, -1)),
                 jnp.asarray(delays), jnp.asarray(cfo_hz, jnp.float32),
                 channels=c, n=n)


@functools.partial(jax.jit, static_argnames=("channels", "n"))
def _bank(frames, delays, cfo_hz, channels: int, n: int):
    from opv_tpu.core import encode_frame
    from opv_tpu.core.framing import frame_to_symbol_bits
    from opv_tpu.tx.modulator import mod_reset, modulate_bits_wire

    bits = frame_to_symbol_bits(encode_frame(frames)).reshape(channels, -1)
    wire = jax.vmap(lambda b: modulate_bits_wire(b, mod_reset())[0])(bits)
    i = ((wire << 16) >> 16).astype(jnp.float32)        # low half: I
    q = (wire >> 16).astype(jnp.float32)                  # high half: Q
    sig = jax.lax.complex(i, q)
    sig = jnp.pad(sig, ((0, 0), (0, n - sig.shape[1])))
    sig = jax.vmap(lambda s, d: jnp.roll(s, d))(sig, delays)
    t = jnp.arange(n, dtype=jnp.float32)
    ph = (2.0 * np.pi / CONFIG.sample_rate) * cfo_hz[:, None] * t[None, :]
    rot = sig * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    return jax.lax.complex(jnp.round(rot.real), jnp.round(rot.imag))
